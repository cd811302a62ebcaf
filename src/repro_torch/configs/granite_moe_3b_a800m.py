"""granite-moe-3b-a800m [moe] — 40 experts top-8. hf:ibm-granite (granite-3.0 family).
32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 40e top-8."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    n_experts=40, top_k=8, d_ff_expert=512, n_shared_experts=0,
    act="silu_glu", norm="rmsnorm",
)

SMOKE = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab=256,
    n_experts=8, top_k=2, d_ff_expert=64,
    act="silu_glu",
)

register(FULL, SMOKE)
