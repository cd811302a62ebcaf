"""deepseek-coder-33b [dense] — llama-arch. arXiv:2401.14196.
62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19200, vocab=32256,
    act="silu_glu", norm="rmsnorm", rope_theta=100000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    act="silu_glu", tie_embeddings=False,
)

register(FULL, SMOKE)
