"""Quantization numerics (port of ``repro/core/quantizers.py``). Symmetric signed
grids, round half to even (``torch.round``, as ``jnp.round``).

* Per-token quantization   — eq. (1): scale from the per-row absmax ``t_i``.
* Per-channel quantization — eq. (2): per-row absmax of W (``axis=-1``, the
  paper's form) or per output channel (``axis=-2``).
* Group-wise quantization  — reshape to (I·O/g, g), per-group absmax.
* CrossQuant               — eq. (5): per-element scale ``t_i^α · c_j^(1-α)``.

Every scale divides its absmax by the constant ``qmax`` as a multiply by the
f32 reciprocal ``1/qmax``: the reference calls these functions under ``jax.jit``
(its quantizers are jitted, and so is every serving step), where XLA compiles a
division by a constant into that multiply, so this is what its scales hold bit
for bit. A division by data (``x / scale``) stays a true division.
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


def _inv_qmax(bits: int) -> float:
    """``1/qmax`` as the reference's jitted graphs multiply by it."""
    return 1.0 / qmax(bits)


def _storage_dtype(bits: int) -> torch.dtype:
    # INT4 codes sit in int8 containers (packing lives in core/packing.py)
    return torch.int8 if bits <= 8 else torch.int32


@dataclasses.dataclass
class QuantResult:
    """Integer codes + broadcastable scale (``dequant() == codes * scale``)."""

    codes: torch.Tensor
    scale: torch.Tensor
    bits: int

    def dequant(self) -> torch.Tensor:
        return self.codes.to(self.scale.dtype) * self.scale


def _round_clip(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -qmax(bits), qmax(bits))


def _quantize(x: torch.Tensor, scale: torch.Tensor, bits: int) -> QuantResult:
    q = _round_clip(x, scale, bits)
    return QuantResult(q.to(_storage_dtype(bits)), scale.to(torch.float32), bits)


# ======================================================================================
# Scale constructions
# ======================================================================================

def per_token_scale(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Eq. (1): Δ_ij = t_i / qmax with t_i = max|X_i,:| (broadcast over last axis)."""
    t = x.abs().amax(dim=-1, keepdim=True)
    return torch.clamp_min(t, EPS) * _inv_qmax(bits)


def per_channel_scale(w: torch.Tensor, bits: int, axis: int = -1) -> torch.Tensor:
    """Eq. (2): per-channel weight scale; ``axis`` is the axis reduced over
    (``-1``: one scale per input channel, the paper's form; ``-2``: per output
    channel)."""
    t = w.abs().amax(dim=axis, keepdim=True)
    return torch.clamp_min(t, EPS) * _inv_qmax(bits)


def per_tensor_scale(x: torch.Tensor, bits: int) -> torch.Tensor:
    return torch.clamp_min(x.abs().amax(), EPS) * _inv_qmax(bits)


def crossquant_scale(x: torch.Tensor, bits: int, alpha: float = 0.15,
                     col_max: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. (5): Δ̃_ij = t_i^α · c_j^(1-α) · (1/qmax). Rows are the second-to-last
    axis; the column absmax ``c`` reduces over every leading axis (all token
    rows). ``col_max`` replaces it with calibrated statistics (static-c)."""
    t = x.abs().amax(dim=-1, keepdim=True)
    if col_max is None:
        c = x.abs().amax(dim=tuple(range(x.ndim - 1)), keepdim=True)
    else:
        c = torch.as_tensor(col_max, device=x.device).reshape((1,) * (x.ndim - 1) + (-1,))
    t = torch.clamp_min(t, EPS)
    c = torch.clamp_min(c, EPS)
    return (t ** alpha) * (c ** (1.0 - alpha)) * _inv_qmax(bits)


# ======================================================================================
# Quantizers (scale + codes)
# ======================================================================================

def per_token_quant(x: torch.Tensor, bits: int = 8) -> QuantResult:
    return _quantize(x, per_token_scale(x, bits), bits)


def per_channel_quant(w: torch.Tensor, bits: int = 8, axis: int = -1) -> QuantResult:
    return _quantize(w, per_channel_scale(w, bits, axis=axis), bits)


def group_quant(w: torch.Tensor, bits: int = 4, group_size: int = 128) -> QuantResult:
    """Group-wise weight quantization (the ``g128`` of W4A8-g128): W flattened to
    (I·O/g, g) groups, one scale per group. The codes keep W's shape; the scale
    (I·O/g, 1) broadcasts against the grouped view (:func:`group_dequant`)."""
    grouped = w.reshape(-1, group_size)
    scale = torch.clamp_min(grouped.abs().amax(dim=-1, keepdim=True), EPS) * _inv_qmax(bits)
    q = _round_clip(grouped, scale, bits)
    return QuantResult(q.to(_storage_dtype(bits)).reshape(w.shape),
                       scale.to(torch.float32), bits)


def group_dequant(qr: QuantResult, group_size: int = 128) -> torch.Tensor:
    grouped = qr.codes.reshape(-1, group_size).to(qr.scale.dtype)
    return (grouped * qr.scale).reshape(qr.codes.shape)


def crossquant(x: torch.Tensor, bits: int = 8, alpha: float = 0.15,
               col_max: Optional[torch.Tensor] = None) -> QuantResult:
    """CrossQuant (eq. 5): ``alpha=1`` is per-token quantization exactly;
    ``alpha=0`` per-(input-)channel quantization of the activation."""
    return _quantize(x, crossquant_scale(x, bits, alpha, col_max), bits)


# ======================================================================================
# Fake quantization (quantize → dequantize: the paper's evaluation mode)
# ======================================================================================

def _fake(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    return (_round_clip(x, scale, bits) * scale).to(x.dtype)


def fake_per_token(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    return _fake(x, per_token_scale(x, bits), bits)


def fake_crossquant(x: torch.Tensor, bits: int = 8, alpha: float = 0.15,
                    col_max: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The paper's App. B.1 reference code (divide by t^α and by c^(1-α), round,
    multiply back) as one fused scale."""
    return _fake(x, crossquant_scale(x, bits, alpha, col_max), bits)


def fake_per_channel(w: torch.Tensor, bits: int = 8, axis: int = -1) -> torch.Tensor:
    return _fake(w, per_channel_scale(w, bits, axis=axis), bits)


def fake_group(w: torch.Tensor, bits: int = 4, group_size: int = 128) -> torch.Tensor:
    return group_dequant(group_quant(w, bits, group_size), group_size).to(w.dtype)
