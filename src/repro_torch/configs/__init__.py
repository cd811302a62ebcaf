"""Arch registry: repro_torch.configs.get(name) / all_archs()."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ModelConfig, ShapeConfig, all_archs, cell_supported, get, register,
    with_padded_heads,
)
