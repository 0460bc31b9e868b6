"""hymba-1.5b [hybrid] — parallel attention+mamba heads per layer, sliding
window attention [arXiv:2411.13676].  long_500k decode RUNS (windowed attn +
recurrent SSM state)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
    d_ff=5504, vocab=32001,
    hybrid=True, ssm_state=16, ssm_conv=4, ssm_expand=2,
    window=1024,                 # hymba's SWA layers
    mlp="swiglu",
)
