"""starcoder2-7b [dense] — GQA kv=4, RoPE [arXiv:2402.19173].  Uses GeLU MLP
per the model's pre-SwiGLU FFN."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_head=128,
    d_ff=18432, vocab=49152,
    mlp="gelu",
)

# Beyond-paper sliding-window variant: makes long_500k decode applicable for a
# dense arch (see DESIGN.md §Arch-applicability).
SWA_CONFIG = ModelConfig(
    name="starcoder2-7b-swa", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_head=128,
    d_ff=18432, vocab=49152,
    mlp="gelu", window=4096,
)
