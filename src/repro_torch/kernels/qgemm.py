"""Launcher of the CUDA kernel K2 ``qgemm_w8a8`` (``csrc/qgemm_w8a8.cu``), the
counterpart of the reference's W8A8 Pallas kernel in ``repro/kernels/qgemm.py``.

Callers go through :func:`repro_torch.kernels.ops.qgemm_w8a8`, which checks the
inputs, runs the plain version for CPU tensors and counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def qgemm_w8a8_cuda(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                    sw: torch.Tensor) -> torch.Tensor:
    """qx (M, K) int8 · qw (K, N) int8 → (M, N) f32 = acc · a · sw, all contiguous
    on one card. 16-byte loads of qx rows and 4-byte loads of qw rows are used
    where the shapes and addresses allow them."""
    M, K = qx.shape
    N = qw.shape[1]
    vec_a = int(K % 16 == 0 and qx.data_ptr() % 16 == 0)
    vec_b = int(N % 4 == 0 and qw.data_ptr() % 4 == 0)
    out = torch.empty((M, N), dtype=torch.float32, device=qx.device)
    rc = build.library().repro_qgemm_w8a8(
        qx.data_ptr(), qw.data_ptr(), a.data_ptr(), sw.data_ptr(), out.data_ptr(),
        M, N, K, vec_a, vec_b, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "qgemm_w8a8")
    return out
