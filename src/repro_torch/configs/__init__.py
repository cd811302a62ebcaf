"""Arch registry: repro_torch.configs.get(name) / all_archs()."""
from repro_torch.configs.base import ModelConfig, all_archs, get, register  # noqa: F401
