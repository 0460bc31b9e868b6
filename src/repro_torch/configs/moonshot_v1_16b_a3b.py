"""moonshot-v1-16b-a3b (Moonlight) [moe] — MoE 64e top-6, MHA
[hf:moonshotai/Moonlight-16B-A3B].  d_ff=1408 is the per-expert hidden; the
model card's shared expert + first-dense-layer details are folded into the
uniform MoE stack (noted in DESIGN.md)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=163840,
    moe=True, n_experts=64, top_k=6,
    mlp="swiglu",
)
