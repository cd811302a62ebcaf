"""Launchers of the CUDA kernels K2 ``qgemm_w8a8``, K7 ``qgemm_w8a8_sparse`` and
K8 ``qgemm_w4a8``, the counterparts of the reference's W8A8, block-sparse W8A8 and
W4A8 Pallas kernels in ``repro/kernels/qgemm.py``. Each has three bodies: the 64 ×
64 tile body in ``csrc/qgemm_w8a8.cu``, for few activation rows the split-K weight
stream in ``csrc/qgemm_decode.cu``, and for more rows the ``wgmma`` bodies in
``csrc/qgemm_wgmma.cu`` (TMA ring, register-sourced weight operand, cluster split-K
where few output tiles would idle the card); :func:`qgemm_w8a8_plan`,
:func:`qgemm_w8a8_sparse_plan` and :func:`qgemm_w4a8_plan` pick one. K7's decode
and wgmma bodies are K2's with a tile skip: each block compacts the list of its
occupied 64-row k-tiles on the card (:func:`sparse_stage_ranges` models it).

K2's three bodies also run expert-batched (``experts`` = E): an MoE's stacked
(E, C, K) × (E, K, N) product in one launch, the decode body with the expert on
grid z, the wgmma body with it folded into grid y beside the m-tiles, the tile
body on grid z; the plan picks the body for C rows and the splits for all E
experts' output tiles.

Callers go through :mod:`repro_torch.kernels.ops`, which checks the inputs, runs
the plain versions for CPU tensors and counts launches.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from repro_torch.kernels import build

#: the tile body's (k, n) tile: K7's occupancy table has one entry per tile
TILE_K, TILE_N = 64, 64

#: K2 runs the decode body for M <= DECODE_MAX_M: the decode steps (M = batch)
#: and speculative verify windows; chosen from the bodies' times at M = 20 and
#: 128 on the H100 (PERF.md)
DECODE_MAX_M = 32
DECODE_TILE_N = 128      # output columns per decode-body block
MAX_SPLITS = 8           # a portable thread-block cluster holds the K splits
_SMS = 132               # H100 SXM streaming multiprocessors
_BLOCKS_PER_SM = 4       # blocks to aim at, so each SM keeps ~100 KB of weights in flight
WGMMA_TILE_N = 128       # output columns per wgmma-body block
WGMMA_TILE_K = 128       # k-rows per ring stage (one 128-byte TMA row)
WGMMA_MAX_TILE_M = 128   # token rows per block: M rounded up to 16 up to here
WGMMA_MIN_SPLIT_K_TILES = 36   # k-tiles a wgmma K split keeps at least (K = 4608)


def decode_splits(K: int, N: int, experts: int = 1) -> int:
    """K splits of the decode body for a (K, N) weight (``experts`` of them in an
    expert-batched launch): enough blocks for about four per SM, at most one
    cluster (8) and one 64-row k-tile per split."""
    n_tiles = -(-N // DECODE_TILE_N) * experts
    k_tiles = -(-K // TILE_K)
    want = math.ceil(_BLOCKS_PER_SM * _SMS / n_tiles)
    return max(1, min(MAX_SPLITS, k_tiles, want))


def split_bounds(K: int, splits: int, unit: int = TILE_K) -> List[Tuple[int, int]]:
    """A body's K ranges: split s takes the ``unit``-row pieces [s·U/S, (s+1)·U/S) of
    the U = ceil(K / unit) there are, the last one cut at K. K2's decode body splits
    64-row k-tiles; K8's bodies their :func:`w4a8_split_unit`."""
    n_units = -(-K // unit)
    return [(s * n_units // splits * unit, min(K, (s + 1) * n_units // splits * unit))
            for s in range(splits)]


def wgmma_tile_m(M: int) -> int:
    """The wgmma body's token rows per block: M rounded up to 16 (at least 48)
    up to 128 rows, else 128-row tiles."""
    return WGMMA_MAX_TILE_M if M > WGMMA_MAX_TILE_M else max(48, -(-M // 16) * 16)


def wgmma_splits(M: int, K: int, N: int, experts: int = 1) -> int:
    """K splits of the wgmma body (M rows per expert, ``experts`` of them in an
    expert-batched launch): 1 where its output tiles fill the card, else
    enough for about one block per SM, at most one cluster (8), and never fewer
    than WGMMA_MIN_SPLIT_K_TILES k-tiles per split: on the H100 a split of K =
    4608 (36 k-tiles) lost more to the cluster reduction than it gained, at every
    M from 33 to 128 and N from 512 to 18432, while K = 18432 gained from 2-4."""
    tiles = -(-N // WGMMA_TILE_N) * -(-M // wgmma_tile_m(M)) * experts
    want = math.ceil(_SMS / tiles)
    by_k = -(-K // WGMMA_TILE_K) // WGMMA_MIN_SPLIT_K_TILES
    return max(1, min(MAX_SPLITS, by_k, want))


def qgemm_w8a8_plan(M: int, K: int, N: int, aligned: bool = True,
                    experts: int = 1) -> Tuple[str, int]:
    """K2's body for an (M, K) × (K, N) product, where K and N are multiples of 16
    and both operands 16-byte aligned (``aligned``): ``("decode", splits)`` for 1 ≤
    M ≤ DECODE_MAX_M, ``("wgmma", splits)`` above (chip_smoke phase 3 measured it
    faster than the tile body at every M from 33 to 2048 on the H100, PERF.md);
    every other product ``("tile", 1)``. An expert-batched launch passes its C rows
    per expert as M and ``experts`` = E: the body is chosen as for one expert, the
    splits for all E experts' output tiles."""
    if not (M >= 1 and K > 0 and K % 16 == 0 and N > 0 and N % 16 == 0 and aligned):
        return "tile", 1
    if M <= DECODE_MAX_M:
        return "decode", decode_splits(K, N, experts)
    return "wgmma", wgmma_splits(M, K, N, experts)


def qgemm_w8a8_sparse_plan(M: int, K: int, N: int, aligned: bool = True) -> Tuple[str, int]:
    """K7's body for an (M, K) × (K, N) product with a tile-occupancy table: K2's
    plan (:func:`qgemm_w8a8_plan`), since its decode and wgmma bodies take the skip.
    The table is read on the card only, so the plan, like K2's, depends on (M, K, N)
    alone and a launch replays unchanged under CUDA-graph capture."""
    return qgemm_w8a8_plan(M, K, N, aligned)


def sparse_stage_ranges(occ, K: int, N: int, body: str,
                        splits: int) -> List[List[List[Tuple[int, ...]]]]:
    """Plain-Python model of what K7's decode and wgmma bodies stream. For each
    128-column block ``b`` and split ``s``, ``[b][s]`` lists the block's stages in
    order, each a tuple of the 64-row k-tiles it loads: one per stage in the decode
    body, two (one for the last stage of an odd share) in the wgmma body. A block's
    list holds, in ascending order, every k-tile occupied in either of its two
    64-column table columns; split s takes its entries [s·L/S, (s+1)·L/S).
    ``occ`` is the (ceil(K/64), ceil(N/64)) table (a tensor or nested sequence)."""
    rows = [[int(v) for v in row] for row in (occ.tolist() if hasattr(occ, "tolist") else occ)]
    KT, NT = -(-K // TILE_K), -(-N // TILE_N)
    if len(rows) != KT or any(len(r) != NT for r in rows):
        raise ValueError(f"occ must be ({KT}, {NT}) for K={K}, N={N}")
    per = {"decode": 1, "wgmma": 2}[body]
    cols = DECODE_TILE_N // TILE_N                  # table columns per block (both bodies: 2)
    out = []
    for b in range(-(-N // DECODE_TILE_N)):
        lst = [kt for kt in range(KT) if any(rows[kt][n] for n in range(b * cols, (b + 1) * cols)
                                              if n < NT)]
        L = len(lst)
        shares = [lst[s * L // splits:(s + 1) * L // splits] for s in range(splits)]
        out.append([[tuple(sh[i:i + per]) for i in range(0, len(sh), per)] for sh in shares])
    return out


def w4a8_decode_splits(K: int, N: int, group: int) -> int:
    """K splits of K8's decode body: :func:`decode_splits`, at most one per group."""
    return max(1, min(decode_splits(K, N), K // group))


def w4a8_split_unit(body: str, group: int) -> int:
    """The k-rows a K8 split is made of: whole groups for the decode body (its
    stages are 64 k-rows, group a multiple of 64); whole groups and whole 128-row
    stages for the wgmma body."""
    return group if body == "decode" else max(group, WGMMA_TILE_K)


def w4a8_wgmma_splits(M: int, K: int, N: int, group: int) -> int:
    """K splits of K8's wgmma body: :func:`wgmma_splits`, at most one per unit."""
    return max(1, min(wgmma_splits(M, K, N), -(-K // w4a8_split_unit("wgmma", group))))


def qgemm_w4a8_plan(M: int, K: int, N: int, group: int,
                    aligned: bool = True) -> Tuple[str, int]:
    """K8's body for an (M, K) × packed (K/2, N) product in groups of ``group``
    k-rows, where N is a multiple of 16, ``group`` a multiple of 64 dividing K,
    and qx, qw4 and sw 16-byte aligned (``aligned``): ``("decode", splits)`` for 1
    ≤ M ≤ DECODE_MAX_M, ``("wgmma", splits)`` above where ``group`` is 64 or a
    multiple of 128 (its 128-row stages then end on a group boundary or inside one
    group); every other product ``("tile", 1)``."""
    if not (M >= 1 and N > 0 and N % 16 == 0 and group > 0 and group % TILE_K == 0
            and K > 0 and K % group == 0 and aligned):
        return "tile", 1
    if M <= DECODE_MAX_M:
        return "decode", w4a8_decode_splits(K, N, group)
    if group == TILE_K or group % WGMMA_TILE_K == 0:
        return "wgmma", w4a8_wgmma_splits(M, K, N, group)
    return "tile", 1


def _gemm_dims(qx: torch.Tensor, qw: torch.Tensor, experts: int):
    """(M, K, N) of a 2-D product (``experts`` = 1) or of one expert's product in
    an expert-batched launch (qx (E, C, K), qw (E, K, N); M = C)."""
    if (qx.ndim, qw.ndim) != ((2, 2) if experts == 1 else (3, 3)):
        raise ValueError(f"qx {tuple(qx.shape)} and qw {tuple(qw.shape)} do not fit "
                         f"experts={experts}")
    return qx.shape[-2], qx.shape[-1], qw.shape[-1]


def qgemm_w8a8_cuda(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                    sw: torch.Tensor, experts: int = 1) -> torch.Tensor:
    """qx (M, K) int8 · qw (K, N) int8 → (M, N) f32 = acc · a · sw, all contiguous
    on one card; expert-batched (``experts`` = E): qx (E, M, K), qw (E, K, N), a
    (E, M, 1), sw (E, N) → (E, M, N), the expert on the grid."""
    M, K, N = _gemm_dims(qx, qw, experts)
    vec_a, vec_b = _vec(qx, qw)
    out = torch.empty(qx.shape[:-1] + (N,), dtype=torch.float32, device=qx.device)
    rc = build.library().repro_qgemm_w8a8(
        qx.data_ptr(), qw.data_ptr(), a.data_ptr(), sw.data_ptr(), out.data_ptr(),
        M, N, K, experts, vec_a, vec_b, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "qgemm_w8a8")
    return out


def qgemm_w8a8_decode_cuda(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                           sw: torch.Tensor, splits: int, experts: int = 1) -> torch.Tensor:
    """K2's decode body: qx (M ≤ 128, K) int8 · qw (K, N) int8 → (M, N) f32 = acc ·
    a · sw, over ``splits`` K splits; K and N multiples of 16, qx and qw 16-byte
    aligned, all contiguous on one card. Expert-batched as :func:`qgemm_w8a8_cuda`
    (the expert on grid z)."""
    M, K, N = _gemm_dims(qx, qw, experts)
    if qx.data_ptr() % 16 or qw.data_ptr() % 16:
        raise ValueError("the decode body reads qx and qw in 16-byte chunks: align both")
    out = torch.empty(qx.shape[:-1] + (N,), dtype=torch.float32, device=qx.device)
    rc = build.library().repro_qgemm_w8a8_decode(
        qx.data_ptr(), qw.data_ptr(), a.data_ptr(), sw.data_ptr(), out.data_ptr(),
        M, N, K, experts, splits, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "qgemm_w8a8 decode body")
    return out


def qgemm_w8a8_wgmma_cuda(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                          sw: torch.Tensor, splits: int, experts: int = 1) -> torch.Tensor:
    """K2's wgmma body: qx (M, K) int8 · qw (K, N) int8 → (M, N) f32 = acc · a ·
    sw, over ``splits`` K splits; K and N multiples of 16, qx and qw 16-byte
    aligned, all contiguous on one card. Expert-batched as :func:`qgemm_w8a8_cuda`
    (the expert folded into grid y with the m-tiles)."""
    M, K, N = _gemm_dims(qx, qw, experts)
    if qx.data_ptr() % 16 or qw.data_ptr() % 16:
        raise ValueError("the wgmma body loads qx and qw with TMA: align both to 16 bytes")
    out = torch.empty(qx.shape[:-1] + (N,), dtype=torch.float32, device=qx.device)
    rc = build.library().repro_qgemm_w8a8_wgmma(
        qx.data_ptr(), qw.data_ptr(), a.data_ptr(), sw.data_ptr(), out.data_ptr(),
        M, N, K, experts, splits, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "qgemm_w8a8 wgmma body")
    return out


def _vec(qx: torch.Tensor, qw: torch.Tensor):
    """16-byte loads of qx rows and 4-byte loads of weight rows, where the shapes
    and addresses allow them."""
    return (int(qx.shape[-1] % 16 == 0 and qx.data_ptr() % 16 == 0),
            int(qw.shape[-1] % 4 == 0 and qw.data_ptr() % 4 == 0))


def qgemm_w8a8_sparse_cuda(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                           sw: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """K7's tile body: K2's tile body with a (ceil(K/64), ceil(N/64)) int32
    tile-occupancy table, whose empty tiles skip their loads and MMAs. → (M, N) f32."""
    M, K = qx.shape
    N = qw.shape[1]
    vec_a, vec_b = _vec(qx, qw)
    out = torch.empty((M, N), dtype=torch.float32, device=qx.device)
    rc = build.library().repro_qgemm_w8a8_sparse(
        qx.data_ptr(), qw.data_ptr(), a.data_ptr(), sw.data_ptr(), occ.data_ptr(),
        out.data_ptr(), M, N, K, vec_a, vec_b, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "qgemm_w8a8_sparse")
    return out


def _sparse_body_cuda(entry: str, what: str, qx: torch.Tensor, qw: torch.Tensor,
                      a: torch.Tensor, sw: torch.Tensor, occ: torch.Tensor,
                      splits: int) -> torch.Tensor:
    M, K = qx.shape
    N = qw.shape[1]
    if qx.data_ptr() % 16 or qw.data_ptr() % 16:
        raise ValueError(f"K7's {what} reads qx and qw in 16-byte chunks: align both")
    out = torch.empty((M, N), dtype=torch.float32, device=qx.device)
    rc = getattr(build.library(), entry)(
        qx.data_ptr(), qw.data_ptr(), a.data_ptr(), sw.data_ptr(), occ.data_ptr(),
        out.data_ptr(), M, N, K, splits, torch.cuda.current_stream().cuda_stream)
    build.check(rc, f"qgemm_w8a8_sparse {what}")
    return out


def qgemm_w8a8_sparse_decode_cuda(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                                  sw: torch.Tensor, occ: torch.Tensor,
                                  splits: int) -> torch.Tensor:
    """K7's decode body: K2's split-K weight stream over the block's occupied
    64-row k-tiles only, shared evenly by ``splits`` cluster ranks; qx (M ≤ 128, K)
    int8, qw (K, N) int8 zero in every tile ``occ`` marks empty, K and N multiples
    of 16, qx and qw 16-byte aligned, all contiguous on one card. → (M, N) f32."""
    return _sparse_body_cuda("repro_qgemm_w8a8_sparse_decode", "decode body", qx, qw, a, sw,
                             occ, splits)


def qgemm_w8a8_sparse_wgmma_cuda(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                                 sw: torch.Tensor, occ: torch.Tensor,
                                 splits: int) -> torch.Tensor:
    """K7's wgmma body: K2's wgmma body over stages of two occupied 64-row k-tiles
    each; as :func:`qgemm_w8a8_sparse_decode_cuda` for any M ≥ 1."""
    return _sparse_body_cuda("repro_qgemm_w8a8_sparse_wgmma", "wgmma body", qx, qw, a, sw,
                             occ, splits)


def qgemm_w4a8_cuda(qx: torch.Tensor, qw4: torch.Tensor, a: torch.Tensor,
                    sw: torch.Tensor, group: int) -> torch.Tensor:
    """qx (M, K) int8 · qw4 (K/2, N) packed int4 with (K/group, N) f32 group scales
    → (M, N) f32. ``group`` is a multiple of 64 dividing K."""
    M, K = qx.shape
    N = qw4.shape[1]
    vec_a, vec_b = _vec(qx, qw4)
    out = torch.empty((M, N), dtype=torch.float32, device=qx.device)
    rc = build.library().repro_qgemm_w4a8(
        qx.data_ptr(), qw4.data_ptr(), a.data_ptr(), sw.data_ptr(), out.data_ptr(),
        M, N, K, group, vec_a, vec_b, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "qgemm_w4a8")
    return out


def _w4a8_body_cuda(entry: str, what: str, qx: torch.Tensor, qw4: torch.Tensor,
                    a: torch.Tensor, sw: torch.Tensor, group: int,
                    splits: int) -> torch.Tensor:
    M, K = qx.shape
    N = qw4.shape[1]
    if qx.data_ptr() % 16 or qw4.data_ptr() % 16 or sw.data_ptr() % 16:
        raise ValueError(f"K8's {what} reads qx, qw4 and sw in 16-byte chunks: align them")
    out = torch.empty((M, N), dtype=torch.float32, device=qx.device)
    rc = getattr(build.library(), entry)(
        qx.data_ptr(), qw4.data_ptr(), a.data_ptr(), sw.data_ptr(), out.data_ptr(),
        M, N, K, group, splits, torch.cuda.current_stream().cuda_stream)
    build.check(rc, f"qgemm_w4a8 {what}")
    return out


def qgemm_w4a8_decode_cuda(qx: torch.Tensor, qw4: torch.Tensor, a: torch.Tensor,
                           sw: torch.Tensor, group: int, splits: int) -> torch.Tensor:
    """K8's decode body: qx (M ≤ 128, K) int8 · qw4 (K/2, N) packed int4 with (K/group,
    N) f32 group scales → (M, N) f32, over ``splits`` K splits of whole groups;
    ``group`` a multiple of 64 dividing K, N a multiple of 16, qx, qw4 and sw 16-byte
    aligned, all contiguous on one card."""
    return _w4a8_body_cuda("repro_qgemm_w4a8_decode", "decode body", qx, qw4, a, sw, group,
                           splits)


def qgemm_w4a8_wgmma_cuda(qx: torch.Tensor, qw4: torch.Tensor, a: torch.Tensor,
                          sw: torch.Tensor, group: int, splits: int) -> torch.Tensor:
    """K8's wgmma body: as :func:`qgemm_w4a8_decode_cuda` for any M ≥ 1, ``group`` 64
    or a multiple of 128, splits of :func:`w4a8_split_unit` k-rows."""
    return _w4a8_body_cuda("repro_qgemm_w4a8_wgmma", "wgmma body", qx, qw4, a, sw, group,
                           splits)
