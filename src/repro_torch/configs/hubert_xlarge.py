"""hubert-xlarge [audio] — encoder-only transformer backbone (w2v2 arch), conv feature
extractor is a STUB (precomputed frame features). arXiv:2106.07447.
48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504 (target cluster classes).

Deviation note (DESIGN.md §5): positions via RoPE instead of the conv positional
embedding of the original — the backbone dims are the assignment's contract."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504,
    act="gelu", norm="layernorm", causal=False,
    frontend="audio_stub", frontend_dim=512, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=32,
    act="gelu", norm="layernorm", causal=False,
    frontend="audio_stub", frontend_dim=32, tie_embeddings=False,
)

register(FULL, SMOKE)
