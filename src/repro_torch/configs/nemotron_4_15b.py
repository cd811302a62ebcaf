"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP. arXiv:2402.16819.
32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=256000,
    act="relu2", norm="layernorm", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    act="relu2", norm="layernorm", tie_embeddings=False,
)

register(FULL, SMOKE)
