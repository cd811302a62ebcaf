"""Launcher of the dense decode / verify attention kernel (``csrc/dense_attention.cuh``,
built from ``csrc/dense_attention.cu`` and ``csrc/dense_attention_spill.cu``).

It replaces no TPU kernel: the reference computes this attention with XLA einsums
(``repro/models/layers.py`` ``decode_attention`` and ``verify_attention``), and the
port's plain version keeps that form (:func:`repro_torch.models.layers.decode_attention`,
:func:`~repro_torch.models.layers.verify_attention`). On a card it sums every output
element in one order fixed by the slot's key walk and D alone, so a tensor-parallel
rank's kv heads, or a GQA group of one, give one device's bits (see the source's
notes). One body, on the CUDA cores; its instantiations by q's dtype are counted
apart (:data:`BODIES`).

Callers go through :func:`repro_torch.kernels.ops.dense_decode_attention` and
:func:`~repro_torch.kernels.ops.dense_verify_attention`, which check the inputs, run
the plain versions for CPU tensors and count launches.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.act_quantize import DTYPE_CODE

CACHE_CODE = {**DTYPE_CODE, torch.int8: 2}      # cache element types the kernel reads
BODIES = {torch.bfloat16: "bf16", torch.float32: "f32"}
HEAD_DIMS = (16, 32, 64, 128, 256)             # the head sizes the kernel is built for
#: a block's threads (the p.v stripes are 4 · THREADS // D of them), the most query
#: rows it holds (one softmax warp each), the shared memory its rows may take, and
#: the blocks that fill the card (its 132 SMs) before a block takes more rows
THREADS, MAX_ROWS, SMEM_BYTES, FILL_BLOCKS = 256, 8, 200 * 1024, 132


class DensePlan(NamedTuple):
    """A launch's layout: ``rows`` query rows a block (of one slot and kv head),
    ``grid`` (row blocks, Hkv, B), ``smem`` bytes a block, ``scratch`` f32 elements
    of the global buffer that holds the blocks' scores where shared memory cannot
    (0: they stay in shared memory). ``order`` is what fixes every sum's order:
    (softmax key stripes, p.v key stripes, keys a p.v group); it reads D alone."""
    rows: int
    grid: Tuple[int, int, int]
    smem: int
    scratch: int
    order: Tuple[int, int, int]


def dense_plan(B: int, W: int, H: int, Hkv: int, T: int, D: int) -> DensePlan:
    """The launch of W query rows a slot (1 at decode) over a (B, T, Hkv, D) cache:
    the W·G rows of a (slot, kv head) split into even blocks, each of as many rows
    as leave FILL_BLOCKS blocks (a block reads its slot's K and V rows once for all
    its rows), at most MAX_ROWS and what SMEM_BYTES holds. A block keeps its rows' T
    scores and the walk's T V scales in shared memory; where not even one row's fit
    (T past ~24k), in a global scratch of (rows + 1)·T floats a block, with the same
    arithmetic. Only the layout reads B, Hkv and G; no sum's order does."""
    R = W * (H // Hkv)
    tpad = -(-T // 4) * 4
    per_row = 4 * (D + 4 * THREADS)           # q row, p.v stripe partials
    cap = min(MAX_ROWS, (SMEM_BYTES - 4 * tpad) // (per_row + 4 * tpad))
    spill = cap < 1                           # not even one score row beside the V scales
    if spill:
        cap = min(MAX_ROWS, SMEM_BYTES // per_row)
    blocks = -(-R // max(1, min(cap, R * Hkv * B // FILL_BLOCKS)))
    rows = -(-R // blocks)
    scores = (rows + 1) * tpad                # score rows and the V scales
    return DensePlan(rows, (blocks, Hkv, B), rows * per_row + (0 if spill else 4 * scores),
                     blocks * Hkv * B * scores if spill else 0, (32, 4 * THREADS // D, 4))


def dense_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
                         cur_len: torch.Tensor, q_len: Optional[torch.Tensor], *,
                         window: Optional[int], softcap: Optional[float]) -> torch.Tensor:
    """q (B, W, H, D) f32|bf16; k/v (B, T, Hkv, D) f32|bf16|int8 with (B, T, Hkv, 1)
    f32 scales for int8; cur_len (B,) and, for verify, q_len (B,) int32 (None at
    decode, W = 1); all contiguous on one card. → (B, W, H, D) in q's dtype."""
    B, W, H, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    plan = dense_plan(B, W, H, Hkv, T, D)
    out = torch.empty_like(q)
    scratch = (torch.empty(plan.scratch, dtype=torch.float32, device=q.device)
               if plan.scratch else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = build.library().repro_dense_attention(
        q.data_ptr(), DTYPE_CODE[q.dtype], k_cache.data_ptr(), v_cache.data_ptr(),
        CACHE_CODE[k_cache.dtype], ptr(k_scale), ptr(v_scale), cur_len.data_ptr(), ptr(q_len),
        out.data_ptr(), ptr(scratch), B, W, H, Hkv, T, D, plan.rows, 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), float(D ** -0.5),
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, "dense_attention")
    return out
