"""Quantization-kernel analysis (port of ``repro/core/kernel_analysis.py``: paper
§4.1, Definition 1).

The *quantization kernel* of a quantization function Q over an activation X is

    K(Q) = { X_ij : Q(X_ij) = 0 } = { X_ij : |X_ij| < B_ij },   B_ij = 0.5 · Δ_ij

These functions measure kernel mass under any scale construction, implement the
paper's "Remove Kernel" ablations (Fig. 1/6/7/9) and the Table 1 statistics.

Counts are exact: kernel elements are counted in int64 (:func:`kernel_count`),
where the reference's mean of an f32 0/1 mask stops being exact above 2^24
elements. The fractions come back as f32 scalars computed as the reference's
jitted ``jnp.mean`` does, ``f32(count) · (1/n)``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import quantizers as Q


def zero_bound(scale: torch.Tensor) -> torch.Tensor:
    """B = 0.5 · Δ (eq. 4); ``scale`` is the broadcastable Δ tensor."""
    return 0.5 * scale


def kernel_mask(x: torch.Tensor, scale: torch.Tensor, *,
                count_exact_zeros: bool = False) -> torch.Tensor:
    """Boolean mask of the elements in K(Q) under scale Δ: |x| < 0.5·Δ. Exact
    zeros carry no information and are left out unless ``count_exact_zeros``."""
    in_kernel = x.abs() < zero_bound(scale)
    if not count_exact_zeros:
        in_kernel = in_kernel & (x != 0)
    return in_kernel


def kernel_count(x: torch.Tensor, scale: torch.Tensor, *,
                 count_exact_zeros: bool = True) -> torch.Tensor:
    """|K(Q)| as an int64 scalar tensor (on x's device)."""
    return kernel_mask(x, scale, count_exact_zeros=count_exact_zeros).sum(dtype=torch.int64)


def _mean_of_count(count: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp.mean`` of a 0/1 f32 mask under jit: the f32 sum times the f32
    reciprocal of the f32 element count."""
    recip = (torch.tensor(1.0, dtype=torch.float32)
             / torch.tensor(float(n), dtype=torch.float32)).to(count.device)
    return count.to(torch.float32) * recip


def kernel_fraction(x: torch.Tensor, scale: torch.Tensor, *,
                    count_exact_zeros: bool = True) -> torch.Tensor:
    """|K(Q)| / |X|: the quantity plotted in Fig. 4 (f32 scalar)."""
    return _mean_of_count(kernel_count(x, scale, count_exact_zeros=count_exact_zeros),
                          x.numel())


def per_token_kernel_fraction(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    return kernel_fraction(x, Q.per_token_scale(x, bits))


def crossquant_kernel_fraction(x: torch.Tensor, bits: int = 8,
                               alpha: float = 0.15) -> torch.Tensor:
    return kernel_fraction(x, Q.crossquant_scale(x, bits, alpha))


def remove_kernel(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The paper's "Remove Kernel" ablation: zero the kernel, keep every other
    element *unquantized* (Fig. 1/9)."""
    return torch.where(kernel_mask(x, scale, count_exact_zeros=True),
                       torch.zeros((), dtype=x.dtype, device=x.device), x).to(x.dtype)


def quantile_linear(flat: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(flat, q)`` with its default ``linear`` method, for any size
    (``torch.quantile`` refuses more than 2^24 elements): sort, then interpolate
    between the order statistics at ``floor`` and ``ceil`` of ``q·(n-1)``, with
    every step in f32 as the reference takes it (n itself rounded to f32). XLA
    contracts the interpolation ``lo·lw + hi·hw`` into ``fma(lo, lw, hi·hw)``;
    the product ``lo·lw`` is exact in f64, so one f64 add then one rounding to
    f32 gives the same value."""
    f32, f64 = torch.float32, torch.float64
    srt = torch.sort(flat.reshape(-1)).values
    n = torch.tensor(float(srt.numel()), dtype=f32)
    pos = torch.tensor(q, dtype=f32) * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    lo_i = int(torch.clamp(low, torch.zeros((), dtype=f32), n - 1))
    hi_i = int(torch.clamp(high, torch.zeros((), dtype=f32), n - 1))
    lw, hw = lw.to(srt.device), hw.to(srt.device)
    hi_term = srt[hi_i].to(f32) * hw
    out = srt[lo_i].to(f64) * lw.to(f64) + hi_term.to(f64)
    return out.to(f32).to(flat.dtype)


def remove_kernel_fraction(x: torch.Tensor, fraction: float) -> torch.Tensor:
    """Zero the smallest-|x| ``fraction`` of elements (Fig. 6/7 sweeps): the global
    magnitude quantile is the zero bound, so the removed share is set directly."""
    ax = x.abs()
    thresh = quantile_linear(ax, fraction)
    return torch.where(ax <= thresh, torch.zeros((), dtype=x.dtype, device=x.device),
                       x).to(x.dtype)


# ======================================================================================
# Table 1 statistics
# ======================================================================================

def table1_stats(x: torch.Tensor, bits: int = 8, alpha: float = 0.15) -> Dict[str, torch.Tensor]:
    """The Table 1 row statistics of one activation matrix: the share of positions
    with ``c_j >= t_i`` (case II of the §4.2 proof), the share with ``B̃_ij <
    B_ij`` (kernel-shrinking positions), and the kernel fractions of CrossQuant and
    of per-token quantization (f32 scalars)."""
    t = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), Q.EPS)
    c = torch.clamp_min(x.abs().amax(dim=tuple(range(x.ndim - 1)), keepdim=True), Q.EPS)
    n = x.numel()
    inv = 1.0 / Q.qmax(bits)
    c_ge_t = (c >= t).expand(x.shape).sum(dtype=torch.int64)
    b_pt = zero_bound(t * inv)
    b_cq = zero_bound((t ** alpha) * (c ** (1 - alpha)) * inv)
    b_shrunk = (b_cq < b_pt).expand(x.shape).sum(dtype=torch.int64)
    return {
        "c_ge_t": _mean_of_count(c_ge_t, n),
        "bcq_lt_bpt": _mean_of_count(b_shrunk, n),
        "kernel_crossquant": kernel_fraction(x, Q.crossquant_scale(x, bits, alpha)),
        "kernel_per_token": kernel_fraction(x, Q.per_token_scale(x, bits)),
    }


# ======================================================================================
# Activation capture: kernel fractions inside a running model
# ======================================================================================

class KernelStats:
    """Accumulates kernel fractions over many activation matrices (host side)."""

    def __init__(self, bits: int = 8, alpha: float = 0.15):
        self.bits = bits
        self.alpha = alpha
        self.per_token: list[float] = []
        self.crossquant: list[float] = []

    def observe(self, x: torch.Tensor) -> None:
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        self.per_token.append(float(per_token_kernel_fraction(x2, self.bits)))
        self.crossquant.append(float(crossquant_kernel_fraction(x2, self.bits, self.alpha)))

    def summary(self) -> dict:
        return {
            "per_token_mean": float(np.mean(self.per_token)) if self.per_token else 0.0,
            "crossquant_mean": float(np.mean(self.crossquant)) if self.crossquant else 0.0,
            "n": len(self.per_token),
        }
