"""gemma2-9b [dense] — local+global alternating attention, logit softcaps. arXiv:2408.00118.
42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000,
    act="gelu_glu", norm="rmsnorm", layer_pattern="local_global", window=4096,
    attn_softcap=50.0, final_softcap=30.0, embed_scale=True,
)

SMOKE = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    act="gelu_glu", layer_pattern="local_global", window=16,
    attn_softcap=50.0, final_softcap=30.0, embed_scale=True,
)

register(FULL, SMOKE)
