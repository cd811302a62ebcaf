"""starcoder2-7b [dense] — GQA, RoPE. arXiv:2402.19173.
32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432, vocab=49152,
    act="gelu", norm="layernorm", rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    act="gelu", norm="layernorm",
)

register(FULL, SMOKE)
