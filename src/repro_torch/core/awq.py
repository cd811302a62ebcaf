"""AWQ baseline (Lin et al., 2024; port of ``repro/core/awq.py``), the paper's
weight-only W4 baseline.

AWQ protects *salient* weight channels (those that multiply large activations)
by scaling them up before group quantization and dividing back after:

    W' = deq(quant_g128(W · s)) / s          s_j = cmax_j^α

The activation side stays untouched (AWQ folds X/s into the previous op). The
exponent α is grid-searched per linear to minimise the activation-weighted
reconstruction error ``|| diag(cmax) · (W - W') ||_F``, with the column absmax
``cmax`` as the data surrogate.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantizers as Q

ALPHA_GRID = (0.0, 0.25, 0.5, 0.75, 1.0)


def _fake_group_cols(w: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """Group quantization along the input axis (rows), per output column: the
    g128 layout of W4A8-g128 (``qlinear.prepare_int4``'s). A d_in the group does
    not divide falls back to flat grouping."""
    d_in, d_out = w.shape[-2], w.shape[-1]
    g = min(group, d_in)
    if d_in % g:
        return Q.fake_group(w, bits, group)
    grouped = w.reshape(*w.shape[:-2], d_in // g, g, d_out)
    scale = torch.clamp_min(grouped.abs().amax(dim=-2, keepdim=True), Q.EPS) * (1.0 / Q.qmax(bits))
    q = torch.clamp(torch.round(grouped / scale), -Q.qmax(bits), Q.qmax(bits))
    return (q * scale).reshape(w.shape)


def awq_weight(w: torch.Tensor, cmax: torch.Tensor, *, bits: int = 4,
               group: int = 128, alphas=ALPHA_GRID) -> torch.Tensor:
    """The AWQ fake-quantized weight: the best α's scale-protect-quantize.

    w: (..., d_in, d_out); cmax: (d_in,) activation column absmax."""
    cm = torch.clamp_min(cmax.to(torch.float32), Q.EPS)
    cm = cm / torch.exp(torch.mean(torch.log(cm)))        # normalise (AWQ convention)
    best_w, best_err = None, None
    for alpha in alphas:
        s = cm ** alpha
        wq = _fake_group_cols(w * s[..., :, None], bits, group) / s[..., :, None]
        err = torch.sum((cm[..., :, None] * (w - wq)) ** 2)
        if best_err is None:
            best_w, best_err = wq, err
        else:
            best_w = torch.where(err < best_err, wq, best_w)
            best_err = torch.minimum(err, best_err)
    return best_w.to(w.dtype)
