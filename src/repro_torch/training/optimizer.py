"""AdamW with a cosine schedule (port of ``repro/training/optimizer.py``).

The optimizer state mirrors the parameter tree: ``m`` and ``v`` are f32 tensors of
each leaf's shape on its device, ``step`` an int32 scalar tensor. The schedule and
the bias corrections are f32 tensor arithmetic on that scalar, as XLA computes
them, never Python doubles.

:func:`apply_updates` writes the new parameters and moments into the tensors it is
given (under ``torch.no_grad()``) and returns them in the reference's tuple, so a
step holds one copy of each; a caller that needs the old values clones them
first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.model import leaves, map_tensors


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor      # () int32
    m: Any                  # f32 tree of the params' shapes
    v: Any


def init(params) -> OptState:
    dev = leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    map_tensors(params, zeros), map_tensors(params, zeros))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio`` × lr: f32 on the
    step's device."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree, layout=None) -> torch.Tensor:
    """The L2 norm over every leaf. With ``layout`` (``training.layout.TrainLayout``)
    ``tree`` is a rank's shards and the norm is the whole logical tree's: each
    rank's sums of squares of the shards it owns (a replicated piece counts once),
    SUMmed across the mesh."""
    parts = torch.stack([torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)])
    if layout is not None:
        own = torch.tensor(layout.owned, device=parts.device)
        parts = layout.norm_sum(torch.where(own, parts, torch.zeros_like(parts)))
    return torch.sqrt(torch.sum(parts))


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: AdamWConfig, layout=None):
    """Returns (new_params, new_state, metrics). Master weights stay f32; the
    params, ``m`` and ``v`` are updated in place (module docstring). With
    ``layout`` they are a rank's shards (AdamW is elementwise) and only the clip
    norm spans the mesh (:func:`global_norm`)."""
    step = state.step + 1
    gnorm = global_norm(grads, layout)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    # torch.full, not torch.tensor: no host-to-device copy, so no sync
    b1c = 1 - torch.pow(torch.full((), cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.full((), cfg.b2, dtype=torch.float32, device=stepf.device), stepf)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m), leaves(state.v)):
        g = g.to(torch.float32) * clip
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.to(torch.float32)
        p.copy_(pf - lr * (update + cfg.weight_decay * pf))
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}
