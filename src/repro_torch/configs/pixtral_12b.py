"""pixtral-12b [vlm] — pixtral-ViT frontend (STUB: precomputed patch embeddings) +
mistral-nemo text backbone. hf:mistralai/Pixtral-12B-2409.
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072,
    act="silu_glu", norm="rmsnorm", rope_theta=1000000000.0,
    frontend="vision_stub", frontend_dim=1024, n_patches=256, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    act="silu_glu",
    frontend="vision_stub", frontend_dim=32, n_patches=8, tie_embeddings=False,
)

register(FULL, SMOKE)
