"""Launchers of the CUDA kernels K2 ``qgemm_w8a8``, K7 ``qgemm_w8a8_sparse`` and
K8 ``qgemm_w4a8`` (one kernel body in ``csrc/qgemm_w8a8.cu``), the counterparts of
the reference's W8A8, block-sparse W8A8 and W4A8 Pallas kernels in
``repro/kernels/qgemm.py``.

Callers go through :mod:`repro_torch.kernels.ops`, which checks the inputs, runs
the plain versions for CPU tensors and counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: the kernel's (k, n) tile: K7's occupancy table has one entry per tile
TILE_K, TILE_N = 64, 64


def qgemm_w8a8_cuda(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                    sw: torch.Tensor) -> torch.Tensor:
    """qx (M, K) int8 · qw (K, N) int8 → (M, N) f32 = acc · a · sw, all contiguous
    on one card."""
    M, K = qx.shape
    N = qw.shape[1]
    vec_a, vec_b = _vec(qx, qw)
    out = torch.empty((M, N), dtype=torch.float32, device=qx.device)
    rc = build.library().repro_qgemm_w8a8(
        qx.data_ptr(), qw.data_ptr(), a.data_ptr(), sw.data_ptr(), out.data_ptr(),
        M, N, K, vec_a, vec_b, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "qgemm_w8a8")
    return out


def _vec(qx: torch.Tensor, qw: torch.Tensor):
    """16-byte loads of qx rows and 4-byte loads of weight rows, where the shapes
    and addresses allow them."""
    return (int(qx.shape[1] % 16 == 0 and qx.data_ptr() % 16 == 0),
            int(qw.shape[1] % 4 == 0 and qw.data_ptr() % 4 == 0))


def qgemm_w8a8_sparse_cuda(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                           sw: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """K2 with a (ceil(K/64), ceil(N/64)) int32 tile-occupancy table: empty tiles
    skip their loads and MMAs. → (M, N) f32."""
    M, K = qx.shape
    N = qw.shape[1]
    vec_a, vec_b = _vec(qx, qw)
    out = torch.empty((M, N), dtype=torch.float32, device=qx.device)
    rc = build.library().repro_qgemm_w8a8_sparse(
        qx.data_ptr(), qw.data_ptr(), a.data_ptr(), sw.data_ptr(), occ.data_ptr(),
        out.data_ptr(), M, N, K, vec_a, vec_b, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "qgemm_w8a8_sparse")
    return out


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
