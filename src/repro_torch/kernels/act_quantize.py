"""Launcher of the CUDA kernel K1 ``act_quantize`` (``csrc/act_quantize.cu``), the
counterpart of the reference's Pallas kernel in ``repro/kernels/act_quantize.py``,
and :func:`act_quantize_plan`, which picks one of its three bodies.

Callers go through :func:`repro_torch.kernels.ops.act_quantize` (and, for an MoE's
stacked linears, ``ops.act_quantize_experts``, every body expert-batched: row r
reads its expert r // C's column factors and exponent), which check the inputs,
run the plain version for CPU tensors and count launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BODY_CODE = {"sweep": 0, "rows": 1, "split": 2}

UNIT = 8                  # elements a thread loads, quantizes and stores at once
SPLIT_MAX_M = 32          # the split body takes the decode and verify rows
MAX_SPLITS = 8            # a portable thread-block cluster
MIN_SPLIT_UNITS = 32      # units per cluster rank at least (256 elements)
_SMS = 132                # H100 SXM streaming multiprocessors
ROWS_MAX_K = UNIT * 256 * 16      # rows body: 16 units per thread at 256 threads
SPLIT_MAX_SLICE = UNIT * 128 * 16  # split body: 16 units per thread at 128 threads


def act_quantize_plan(M: int, K: int) -> Tuple[str, int]:
    """K1's body for an (M, K) activation: ``("split", S)`` for 1 ≤ M ≤ SPLIT_MAX_M,
    one row per cluster of S ≤ 8 blocks with M·S near one block per SM (and each
    rank at least MIN_SPLIT_UNITS units of 8 elements); ``("rows", 1)`` for more
    rows, or where no split of 2 or more ranks is worth it, the row held in
    registers (K ≤ ROWS_MAX_K); ``("sweep", 1)`` beyond that, x read twice."""
    units = -(-K // UNIT)
    if 1 <= M <= SPLIT_MAX_M:
        splits = max(1, min(MAX_SPLITS, _SMS // M, units // MIN_SPLIT_UNITS))
        if splits > 1 and -(-units // splits) * UNIT <= SPLIT_MAX_SLICE:
            return "split", splits
    if K <= ROWS_MAX_K:
        return "rows", 1
    return "sweep", 1


def act_quantize_cuda(x: torch.Tensor, bcol: torch.Tensor, alpha_t: Optional[torch.Tensor],
                      alpha_val: float, bits: int, body: str, splits: int,
                      rows_per_expert: Optional[int] = None):
    """x (M, K) f32|bf16 and bcol (K,) f32, contiguous on one card; the exponent
    is read from ``alpha_t`` (one f32 value on the card) when given, else
    ``alpha_val``; ``body`` and ``splits`` from :func:`act_quantize_plan`. Returns
    (codes (M, K) int8, a (M, 1) f32). Expert-batched: ``rows_per_expert`` = C,
    the M = E·C rows are E experts' C rows each, bcol is (E, K) and ``alpha_t``
    (E,); row r takes expert r // C's."""
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    a = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    rc = build.library().repro_act_quantize(
        x.data_ptr(), DTYPE_CODE[x.dtype], bcol.data_ptr(),
        None if alpha_t is None else alpha_t.data_ptr(), alpha_val, q.data_ptr(),
        a.data_ptr(), M, K, M if rows_per_expert is None else rows_per_expert, bits,
        BODY_CODE[body], splits,
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, f"act_quantize {body} body")
    return q, a
