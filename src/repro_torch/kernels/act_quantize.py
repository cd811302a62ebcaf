"""Launcher of the CUDA kernel K1 ``act_quantize`` (``csrc/act_quantize.cu``), the
counterpart of the reference's Pallas kernel in ``repro/kernels/act_quantize.py``.

Callers go through :func:`repro_torch.kernels.ops.act_quantize`, which checks the
inputs, runs the plain version for CPU tensors and counts launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def act_quantize_cuda(x: torch.Tensor, bcol: torch.Tensor, alpha_t: Optional[torch.Tensor],
                      alpha_val: float, bits: int):
    """x (M, K) f32|bf16 and bcol (K,) f32, contiguous on one card; the exponent
    is read from ``alpha_t`` (one f32 value on the card) when given, else
    ``alpha_val``. Returns (codes (M, K) int8, a (M, 1) f32)."""
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    a = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    rc = build.library().repro_act_quantize(
        x.data_ptr(), DTYPE_CODE[x.dtype], bcol.data_ptr(),
        None if alpha_t is None else alpha_t.data_ptr(), alpha_val, q.data_ptr(),
        a.data_ptr(), M, K, bits, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "act_quantize")
    return q, a
