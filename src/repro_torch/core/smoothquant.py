"""SmoothQuant baseline (Xiao et al., 2023; port of ``repro/core/smoothquant.py``),
the paper's strongest W8A8 baseline.

A per-input-channel smoothing factor, from calibration statistics, moves the
quantization difficulty from activations to weights:

    s_j = max|X_:,j|^α / max|W_j,:|^(1-α)
    X' = X / s,   W' = s ⊙ W          (exact: X'W' = XW)

then X' is per-token quantized and W' per-channel quantized. The paper uses
α = 0.8 for LLaMA and 0.5 for OPT (App. B.1); the default is 0.5.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantizers as Q


def smoothing_scale(act_col_max: torch.Tensor, w_row_max: torch.Tensor,
                    alpha: float = 0.5) -> torch.Tensor:
    """Per-input-channel smoothing factor s_j; both statistics are length-I."""
    a = torch.clamp_min(act_col_max, Q.EPS)
    w = torch.clamp_min(w_row_max, Q.EPS)
    return torch.clamp_min((a ** alpha) / (w ** (1.0 - alpha)), Q.EPS)


def smooth_pair(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor):
    """The exact-equivalence transform: returns (X/s, s·W)."""
    return x / s, w * s[:, None]


def smoothquant_matmul_fake(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                            bits_a: int = 8, bits_w: int = 8) -> torch.Tensor:
    """Fake-quant SmoothQuant GEMM: smooth → per-token A-quant → per-channel
    W-quant → fp product."""
    xs, ws = smooth_pair(x, w, s)
    return Q.fake_per_token(xs, bits_a) @ Q.fake_per_channel(ws, bits_w, axis=-1)
