"""Calibration pass for static-c CrossQuant (port of ``repro/core/calibration.py``).

The observer records running per-channel column absmax per named linear during
eager forward passes; the tables come back to the host as float32 numpy arrays.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch


class Observer:
    """Running per-channel absmax per linear-layer name."""

    def __init__(self, momentum: Optional[float] = None):
        # momentum=None -> hard max over all batches; in (0,1) -> EMA of per-batch max
        self.momentum = momentum
        self.col_max: Dict[str, np.ndarray] = {}
        self.n_obs: Dict[str, int] = {}

    def observe(self, name: str, x: torch.Tensor) -> None:
        col = x.abs().reshape(-1, x.shape[-1]).amax(dim=0)
        flat = col.to(torch.float32).cpu().numpy()
        if name not in self.col_max:
            self.col_max[name] = flat
            self.n_obs[name] = 1
            return
        if self.momentum is None:
            self.col_max[name] = np.maximum(self.col_max[name], flat)
        else:
            m = self.momentum
            self.col_max[name] = m * self.col_max[name] + (1 - m) * flat
        self.n_obs[name] += 1

    def tables(self) -> Dict[str, np.ndarray]:
        return dict(self.col_max)


def calibrate(apply_fn, params, batches, observer: Optional[Observer] = None) -> Observer:
    """Run ``apply_fn(params, batch, observer)`` over calibration batches."""
    obs = observer or Observer()
    for batch in batches:
        apply_fn(params, batch, obs)
    return obs


def stack_tables(tables: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Observer names → parameter-tree paths: ``/L{b}/S{i}/attn/wq`` (layer b,
    sublayer i) stacks along a new leading axis at ``blocks/{i}/attn/wq``."""
    out: Dict[str, np.ndarray] = {}
    grouped: Dict[tuple, Dict[int, np.ndarray]] = {}
    for name, v in tables.items():
        m = re.match(r"^/L(\d+)/S(\d+)/(.*)$", name)
        if m:
            b, i, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            grouped.setdefault((i, rest), {})[b] = v
            continue
        m = re.match(r"^/T(\d+)/(.*)$", name)
        if m:
            out[f"tail/{m.group(1)}/{m.group(2)}"] = v
            continue
        if name.startswith("/shared_attn/"):
            out["shared_attn/attn/" + name[len("/shared_attn/"):]] = v
            continue
        if name.startswith("/shared_mlp/"):
            out["shared_attn/mlp/" + name[len("/shared_mlp/"):]] = v
            continue
        out[name.lstrip("/")] = v
    for (i, rest), per_layer in grouped.items():
        n = max(per_layer) + 1
        if len(per_layer) == n:
            out[f"blocks/{i}/{rest}"] = np.stack([per_layer[b] for b in range(n)])
    return out
