"""Quantization numerics (port of ``repro/core/quantizers.py``, the parts this slice
uses). Symmetric signed grids, round half to even (``torch.round``, as ``jnp.round``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Floor on scales so rows/columns of exact zeros do not produce inf/nan.
EPS = 1e-8


def qmax(bits: int) -> int:
    """Largest representable magnitude: 2^(N-1) - 1 (symmetric signed grid)."""
    return 2 ** (bits - 1) - 1


@dataclasses.dataclass
class QuantResult:
    """Integer codes + broadcastable scale (``codes * scale`` dequantizes)."""

    codes: torch.Tensor
    scale: torch.Tensor
    bits: int


def _quantize(x: torch.Tensor, scale: torch.Tensor, bits: int) -> QuantResult:
    q = torch.clamp(torch.round(x / scale), -qmax(bits), qmax(bits))
    dtype = torch.int8 if bits <= 8 else torch.int32
    return QuantResult(q.to(dtype), scale.to(torch.float32), bits)


def per_token_scale(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Eq. (1): Δ_ij = t_i / qmax with t_i = max|X_i,:| (broadcast over last axis).

    Evaluated as ``t · (1/qmax)``: the reference's ``per_token_quant`` is jitted,
    and XLA compiles a division by a constant into a multiply by its f32
    reciprocal, so this is what its int8 KV scales hold, bit for bit."""
    t = x.abs().amax(dim=-1, keepdim=True)
    return torch.clamp_min(t, EPS) * (1.0 / qmax(bits))


def crossquant_scale(x: torch.Tensor, bits: int, alpha: float = 0.15,
                     col_max: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. (5): Δ̃_ij = t_i^α · c_j^(1-α) / qmax; ``col_max`` replaces the dynamic
    column absmax with calibrated statistics (static-c CrossQuant)."""
    t = x.abs().amax(dim=-1, keepdim=True)
    if col_max is None:
        c = x.abs().amax(dim=tuple(range(x.ndim - 1)), keepdim=True)
    else:
        c = torch.as_tensor(col_max, device=x.device).reshape((1,) * (x.ndim - 1) + (-1,))
    t = torch.clamp_min(t, EPS)
    c = torch.clamp_min(c, EPS)
    return (t ** alpha) * (c ** (1.0 - alpha)) / qmax(bits)


def per_token_quant(x: torch.Tensor, bits: int = 8) -> QuantResult:
    return _quantize(x, per_token_scale(x, bits), bits)
