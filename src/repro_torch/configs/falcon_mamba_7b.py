"""falcon-mamba-7b [ssm] — attention-free Mamba-1 stack [arXiv:2410.05355].

The paper's coalition technique applies unchanged (it consumes flattened
weights); long_500k decode RUNS for this arch (recurrent state, O(1)/token)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=65024,
    ssm=True, ssm_state=16, ssm_conv=4, ssm_expand=2,
    tie_embeddings=False,        # falcon-mamba has a separate LM head
)
