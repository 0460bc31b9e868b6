"""chatglm3-6b [dense] — RoPE 2d (partial rotary), GQA kv=2 [arXiv:2406.12793]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_head=128,
    d_ff=13696, vocab=65024,
    rope_fraction=0.5,           # chatglm's "2d RoPE": rotary on half the head dim
    mlp="swiglu", qkv_bias=True, # chatglm uses qkv bias
)
