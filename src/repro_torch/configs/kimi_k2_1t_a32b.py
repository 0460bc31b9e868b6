"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 (paper-table
entry) [arXiv:2501.kimi2].  GQA kv=8 per the assignment (the real model's MLA
is out of the assigned spec); d_head=128."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=2048, vocab=163840,
    moe=True, n_experts=384, top_k=8,
    mlp="swiglu",
)
