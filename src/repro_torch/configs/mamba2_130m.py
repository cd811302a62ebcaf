"""mamba2-130m [ssm] — SSD (state-space duality), arXiv:2405.21060.
24L d_model=768, attention-free, vocab=50280, ssm_state=128."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    use_rope=False, norm="rmsnorm",
)

SMOKE = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab=256,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
    use_rope=False,
)

register(FULL, SMOKE)
