"""seamless-m4t-large-v2 [audio] — encoder-decoder multimodal backbone
[arXiv:2308.11596].  The speech frontend (mel + conformer feature extractor)
is a STUB per the brief: input_specs provide (B, 960, 1024) frame embeddings;
we implement the 24L encoder + 24L decoder transformer that consumes them."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=8192, vocab=256206,
    mlp="gelu",
    enc_dec=True, n_enc_layers=24,
    modality="audio", n_modal_tokens=960, d_modal=1024,
)
