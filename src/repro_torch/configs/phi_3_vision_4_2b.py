"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP ViT-L frontend stub
[hf:microsoft/Phi-3-vision-128k-instruct].  The vision tower is a STUB per the
brief: input_specs provide (B, 576, 1024) patch embeddings; the learned linear
projector + LM backbone are implemented."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
    d_ff=8192, vocab=32064,
    mlp="swiglu",
    modality="vision", n_modal_tokens=576, d_modal=1024,
)
