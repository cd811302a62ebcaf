"""Modality frontend stubs (port of ``repro/models/frontends.py``).

The ``vlm`` and ``audio`` configs specify the transformer backbone only; their
inputs arrive as precomputed patch or frame features, and the stubs are linear
projections of those features into ``d_model``. The projection is a plain matrix
product that the reference leaves to XLA outside any kernel, so here it is
``torch.matmul``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import qlinear as ql


def init_frontend(gen: torch.Generator, cfg: ModelConfig, *, device) -> dict:
    if cfg.frontend == "none":
        return {}
    return {"proj": ql.init(gen, cfg.frontend_dim, cfg.d_model, device=device)}


def vision_stub_apply(params: dict, tokens_embed: torch.Tensor, patch_embeds: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """The projected patch embeddings replace the first ``n_patches`` text
    positions: sequence = [patches | text[n_patches:]], length unchanged."""
    patches = patch_embeds @ params["proj"]["w"].to(patch_embeds.dtype)
    return torch.cat([patches.to(tokens_embed.dtype), tokens_embed[:, cfg.n_patches:]], dim=1)


def audio_stub_apply(params: dict, frames: torch.Tensor) -> torch.Tensor:
    """Project precomputed acoustic frame features to the backbone width."""
    return frames @ params["proj"]["w"].to(frames.dtype)
