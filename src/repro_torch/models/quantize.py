"""Whole-model weight quantization (port of ``quantize_tree`` and
``quantized_bytes`` from ``repro/models/quantize.py``).

The offline PTQ step of a deployment: every quantizable linear becomes its
prepared int8 static-c CrossQuant form; embeddings and norms stay fp."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import qlinear as ql

QUANTIZABLE_PARENTS = ("wq", "wk", "wv", "wo", "up", "gate", "down",
                       "in_proj", "out_proj")


def _prepare_stacked(w: torch.Tensor, cfg: ql.QuantConfig,
                     cmax: Optional[torch.Tensor]) -> dict:
    """``prepare_int8`` one layer at a time over a stacked (L, d_in, d_out) weight.

    Every step of the preparation is per layer (elementwise, or reduced within one
    layer's columns), so this equals the stacked call, while the f32 temporaries
    stay one layer large instead of L (10.9 GB for a 32-layer 4608x18432 stack)."""
    parts = [ql.prepare_int8({"w": w[i]}, cfg, None if cmax is None else cmax[i])
             for i in range(w.shape[0])]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def quantize_tree(params, cfg: ql.QuantConfig,
                  tables: Optional[Dict[str, np.ndarray]] = None):
    """Returns a new params tree with prepared int8 linears. ``tables``:
    calibration column absmax per linear path (``calibration.stack_tables``);
    a missing name falls back to c=1 (pure per-token row scaling)."""
    tables = tables or {}
    if cfg.w_bits <= 4:
        raise NotImplementedError("W4 preparation is not ported yet")

    def convert(node, prefix):
        if isinstance(node, dict):
            if "w" in node and prefix and prefix.split("/")[-1] in QUANTIZABLE_PARENTS:
                w = node["w"]
                if w.ndim >= 2:
                    cmax = node.get("cmax")
                    if cmax is None and prefix in tables:
                        cmax = torch.as_tensor(tables[prefix], device=w.device)
                    if w.ndim == 3:
                        return _prepare_stacked(w, cfg, cmax)
                    return ql.prepare_int8({"w": w}, cfg, cmax)
            return {k: convert(v, f"{prefix}/{k}" if prefix else k) for k, v in node.items()}
        if isinstance(node, list):
            return [convert(v, f"{prefix}/{i}") for i, v in enumerate(node)]
        return node

    return convert(params, "")


def quantized_bytes(params) -> int:
    """Total bytes of every tensor leaf: codes and scale/aux leaves alike."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(quantized_bytes(v) for v in params)
    return params.numel() * params.element_size()
