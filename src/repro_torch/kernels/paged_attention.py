"""Launchers of the CUDA kernels K4/K5/K6, the counterparts of the reference's
``_paged_decode_kernel`` and ``_ragged_prefill_kernel`` in
``repro/kernels/flash_attention.py``: single-token decode at ``q_win = 1``,
draft-window verify at ``q_win > 1``, and ragged chunked prefill. Two bodies, by
q's dtype (:data:`BODIES`): bf16 q runs the split tensor-core body in
``csrc/paged_attention_mma.cu`` (each slot's key walk cut into the partitions of
:func:`split_plan`, merged by a second launch), f32 q the CUDA-core body in
``csrc/paged_attention.cu``.

Callers go through :func:`repro_torch.kernels.ops.paged_decode_attention`,
:func:`~repro_torch.kernels.ops.paged_verify_attention` and
:func:`~repro_torch.kernels.ops.ragged_prefill_attention`, which check the
inputs, run the plain versions for CPU tensors and count launches.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.act_quantize import DTYPE_CODE

POOL_CODE = {**DTYPE_CODE, torch.int8: 2}    # pool element types the kernel reads
BODIES = {torch.bfloat16: "bf16_mma", torch.float32: "f32"}
HEAD_DIMS = (16, 32, 64, 128, 256)      # the head sizes the bf16 body is built for

#: the bf16 body's key chunk, target partition length and most partitions
SPLIT_CHUNK, SPLIT_TARGET, SPLIT_MAX = 32, 128, 32


def split_plan(maxP: int, ps: int) -> Tuple[int, int]:
    """(n_parts, part_len) of the bf16 body: the logical positions [0, maxP·ps)
    cut into n_parts partitions of part_len positions (a multiple of the 32-key
    chunk), about 128 each and at most 32 of them, none empty. It reads shapes
    only, so a launch needs no kv_len on the host, and a decode and a ragged
    launch over one table cut every slot's walk alike."""
    span = maxP * ps
    n = max(1, min(SPLIT_MAX, math.ceil(span / SPLIT_TARGET)))
    part_len = math.ceil(math.ceil(span / n) / SPLIT_CHUNK) * SPLIT_CHUNK
    return math.ceil(span / part_len), part_len


def _scratch(n_parts: int, rows: int, D: int, device):
    """The bf16 body's partial (acc, (m, l)) buffers, or none for one partition."""
    if n_parts == 1:
        return None, None
    return (torch.empty((n_parts, rows, D), dtype=torch.float32, device=device),
            torch.empty((n_parts, rows, 2), dtype=torch.float32, device=device))


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
    if q.dtype == torch.bfloat16:
        n_parts, part_len = split_plan(page_table.shape[1], ps)
        acc, ml = _scratch(n_parts, B * Hkv * R, D, q.device)
        rc = build.library().repro_paged_attention_bf16(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), POOL_CODE[k_pages.dtype],
            ptr(k_scale), ptr(v_scale), page_table.data_ptr(), kv_len.data_ptr(), ptr(q_len),
            out.data_ptr(), ptr(acc), ptr(ml), B, Hkv, R, D, P, ps, page_table.shape[1], q_win,
            n_parts, part_len, 0 if window is None else int(window),
            0.0 if softcap is None else float(softcap), float(D ** -0.5),
            torch.cuda.current_stream().cuda_stream)
        build.check(rc, "paged_attention bf16 body")
        return out
    rc = build.library().repro_paged_attention(
        q.data_ptr(), DTYPE_CODE[q.dtype], k_pages.data_ptr(), v_pages.data_ptr(),
        POOL_CODE[k_pages.dtype], ptr(k_scale), ptr(v_scale), page_table.data_ptr(),
        kv_len.data_ptr(), ptr(q_len), out.data_ptr(), B, Hkv, R, D, P, ps,
        page_table.shape[1], q_win, 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), float(D ** -0.5),
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, "paged_attention")
    return out


def ragged_prefill_cuda(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                        k_pages: torch.Tensor, v_pages: torch.Tensor,
                        k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
                        page_table: torch.Tensor, q_start: torch.Tensor, q_len: torch.Tensor,
                        kv_len: torch.Tensor, *, chunk_cap: int, window: Optional[int],
                        softcap: Optional[float]) -> torch.Tensor:
    """q (Nt, Hkv·G, D) and k_new/v_new (Nt, Hkv, D) in one f32|bf16 dtype; pools
    and scale pools as :func:`paged_attention_cuda`; page_table (B, maxP) and
    q_start/q_len/kv_len (B,) int32; all contiguous on one card. → (Nt, Hkv·G, D),
    zero at rows no slot owns."""
    Nt, H, D = q.shape
    P, ps, Hkv = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    B, maxP = page_table.shape
    out = torch.zeros_like(q)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    if q.dtype == torch.bfloat16:
        n_parts, part_len = split_plan(maxP, ps)
        acc, ml = _scratch(n_parts, Nt * H, D, q.device)
        rc = build.library().repro_ragged_prefill_bf16(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), POOL_CODE[k_pages.dtype], ptr(k_scale), ptr(v_scale),
            page_table.data_ptr(), q_start.data_ptr(), q_len.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), ptr(acc), ptr(ml), Nt, B, Hkv, H // Hkv, D, P, ps, maxP,
            int(chunk_cap), n_parts, part_len, 0 if window is None else int(window),
            0.0 if softcap is None else float(softcap), float(D ** -0.5),
            torch.cuda.current_stream().cuda_stream)
        build.check(rc, "ragged_prefill bf16 body")
        return out
    rc = build.library().repro_ragged_prefill(
        q.data_ptr(), DTYPE_CODE[q.dtype], k_new.data_ptr(), v_new.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), POOL_CODE[k_pages.dtype], ptr(k_scale),
        ptr(v_scale), page_table.data_ptr(), q_start.data_ptr(), q_len.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), Nt, B, Hkv, H // Hkv, D, P, ps, maxP,
        int(chunk_cap), 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), float(D ** -0.5),
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, "ragged_prefill")
    return out
