"""Launcher of the CUDA kernel K4/K5 ``paged_attention`` (``csrc/paged_attention.cu``),
the counterpart of the reference's ``_paged_decode_kernel`` in
``repro/kernels/flash_attention.py``: single-token decode at ``q_win = 1`` and
draft-window verify at ``q_win > 1``.

Callers go through :func:`repro_torch.kernels.ops.paged_decode_attention` and
:func:`repro_torch.kernels.ops.paged_verify_attention`, which check the inputs, run
the plain versions for CPU tensors and count launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.act_quantize import DTYPE_CODE

POOL_CODE = {**DTYPE_CODE, torch.int8: 2}    # pool element types the kernel reads


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                         k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
                         page_table: torch.Tensor, kv_len: torch.Tensor,
                         q_len: Optional[torch.Tensor], *, q_win: int,
                         window: Optional[int], softcap: Optional[float]) -> torch.Tensor:
    """q (B, Hkv, q_win·G, D) f32|bf16; pools (P, ps, Hkv, D) f32|bf16|int8 with
    (P, ps, Hkv, 1) f32 scale pools for int8; page_table (B, maxP), kv_len (B,)
    and, at ``q_win > 1``, q_len (B,) int32; all contiguous on one card.
    → (B, Hkv, q_win·G, D) in q's dtype."""
    B, Hkv, R, D = q.shape
    P, ps = k_pages.shape[0], k_pages.shape[1]
    out = torch.empty_like(q)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = build.library().repro_paged_attention(
        q.data_ptr(), DTYPE_CODE[q.dtype], k_pages.data_ptr(), v_pages.data_ptr(),
        POOL_CODE[k_pages.dtype], ptr(k_scale), ptr(v_scale), page_table.data_ptr(),
        kv_len.data_ptr(), ptr(q_len), out.data_ptr(), B, Hkv, R, D, P, ps,
        page_table.shape[1], q_win, 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), float(D ** -0.5),
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, "paged_attention")
    return out
