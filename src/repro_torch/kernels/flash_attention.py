"""Launcher of the CUDA kernel K3 ``flash_attention`` (``csrc/flash_attention.cu``),
the counterpart of the reference's ``_fa_kernel`` in
``repro/kernels/flash_attention.py``. The kernel has two bodies, chosen by dtype:
bf16 runs on the tensor cores, f32 on the CUDA cores (:data:`BODIES`).

Callers go through :func:`repro_torch.kernels.ops.flash_attention`, which checks
the inputs, runs the plain version for CPU tensors and counts launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.act_quantize import DTYPE_CODE

HEAD_DIMS = (16, 32, 64, 80, 128, 256)  # the head sizes the kernel is built for
#: the body each dtype runs
BODIES = {torch.bfloat16: "bf16_mma", torch.float32: "f32"}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: Optional[torch.Tensor], *, causal: bool,
                         window: Optional[int], softcap: Optional[float]) -> torch.Tensor:
    """q (B, H, Sq, D), k/v (B, Hkv, Sk, D), contiguous f32|bf16 on one card (bf16
    16-byte aligned); ``kv_len`` (B,) int32 already clipped to [0, Sk], or None.
    → (B, H, Sq, D)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rc = build.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if kv_len is None else kv_len.data_ptr(), DTYPE_CODE[q.dtype], B, H, Hkv,
        Sq, Sk, D, int(causal), 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), float(D ** -0.5),
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, "flash_attention")
    return out
