"""Gradient compression with error feedback (port of
``repro/training/compression.py``; plain torch, as the reference is plain jnp).

Each gradient matrix is quantized to int8 and dequantized before the optimizer,
the payload a compressed data-parallel all-reduce would ship. CrossQuant's scale
(``rowmax^α · colmax^(1-α)`` per element) shrinks the quantization kernel of a
gradient as it does an activation's, and error feedback carries what the
rounding dropped into the next step. On one device there is no all-reduce: the
quantize → dequantize pair is what changes the update. Under data axes the
trainer compresses each whole leaf's data-summed gradient (every rank the same,
with the same error state) before it keeps its shard, so the codes are one
device's; under a model axis a rank holds a slice of a leaf and the planner
refuses compression (``check_train``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import kernel_analysis as KA
from repro_torch.core import quantizers as Q
from repro_torch.models.model import map_tensors


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    bits: int = 8
    alpha: float = 0.5            # gradient matrices are near-isotropic: a balanced mix
    scheme: str = "crossquant"    # crossquant | per_tensor | none
    error_feedback: bool = True


def _grad_scale(g2d: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    if cfg.scheme == "per_tensor":
        return Q.per_tensor_scale(g2d, cfg.bits)
    return Q.crossquant_scale(g2d, cfg.bits, cfg.alpha)


def compress_leaf(g: torch.Tensor, err: torch.Tensor, cfg: CompressionConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize-dequantize one gradient tensor with error feedback: (g_hat, new_err)
    with g_hat = deq(quant(g + err)) and new_err = (g + err) - g_hat. Tensors of
    fewer than 2 dims (norm scales, biases) pass through uncompressed."""
    if cfg.scheme == "none" or g.ndim < 2:
        return g, err
    gf = g.to(torch.float32) + err if cfg.error_feedback else g.to(torch.float32)
    g2d = gf.reshape(-1, gf.shape[-1])
    scale = _grad_scale(g2d, cfg)
    ghat = (Q._round_clip(g2d, scale, cfg.bits) * scale).reshape(g.shape)
    new_err = gf - ghat if cfg.error_feedback else err
    return ghat.to(g.dtype), new_err


def init_error_state(params):
    """f32 zeros of every compressible (≥ 2-D) leaf's shape, a () zero for the rest."""
    return map_tensors(params, lambda p: torch.zeros(p.shape if p.ndim >= 2 else (),
                                                     dtype=torch.float32, device=p.device))


def compress_grads(grads, err_state, cfg: CompressionConfig):
    """:func:`compress_leaf` over the gradient tree: (g_hat tree, new error tree)."""
    pairs = map_tensors(grads, lambda g, e: compress_leaf(g, e, cfg), err_state)
    return (map_tensors(grads, lambda _, p: p[0], pairs),
            map_tensors(grads, lambda _, p: p[1], pairs))


def gradient_kernel_fractions(g: torch.Tensor, bits: int = 8,
                              alpha: float = 0.5) -> Dict[str, torch.Tensor]:
    """The quantization-kernel fraction of a gradient matrix under per-tensor and
    CrossQuant scaling (the paper's Definition 1 applied to gradients)."""
    g2d = g.reshape(-1, g.shape[-1]).to(torch.float32)
    return {"per_tensor": KA.kernel_fraction(g2d, Q.per_tensor_scale(g2d, bits)),
            "crossquant": KA.kernel_fraction(g2d, Q.crossquant_scale(g2d, bits, alpha))}
