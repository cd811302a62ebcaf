"""Plain PyTorch versions of the ported kernels (port of ``repro/kernels/ref.py``).

They are the semantic ground truth the CUDA kernels are held against on the card,
and the path ``kernels/ops.py`` takes for tensors that lie on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quantizers as Q

NEG_INF = -1e30


def qgemm_w8a8_ref(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                   sw: torch.Tensor) -> torch.Tensor:
    """int8 GEMM with separable dequant: (qx · qw) * a * sw → (M, N) f32.

    qx (M, K) int8; qw (K, N) int8; a (M, 1) f32; sw (N,) f32. The int32
    accumulator is formed as a float64 product of the codes, which is exact
    (|acc| ≤ 127²·K < 2^53); its f32 conversion rounds as int32→f32 does."""
    acc = torch.matmul(qx.to(torch.float64), qw.to(torch.float64))
    return acc.to(torch.float32) * a.to(torch.float32) * sw.to(torch.float32)


def act_quantize_ref(x: torch.Tensor, bcol: torch.Tensor, bits: int = 8, alpha=0.15):
    """Fused CrossQuant activation quantization (static-c path), as the Pallas
    kernel computes it: row absmax floored at EPS in f32, ``a = t^α / qmax``
    (evaluated as ``t^α · (1/qmax)``, the form XLA compiles a division by a
    constant into), codes ``clip(round(x / (a·bcol)))``. ``alpha`` is a float or
    a one-element f32 tensor (the prepared tree's ``qalpha``).
    → (codes (M,K) int8, a (M,1) f32)."""
    qm = Q.qmax(bits)
    xf = x.to(torch.float32)
    t = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), Q.EPS)
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.to(torch.float32).reshape(1, 1)
    a = (t ** alpha) * (1.0 / qm)
    q = torch.clamp(torch.round(xf / (a * bcol.to(torch.float32))), -qm, qm)
    return q.to(torch.int8), a


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[torch.Tensor] = None, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention in f32. q (B,H,Sq,D); k/v (B,Hkv,Sk,D), query head
    h reads kv head h // (H/Hkv); ``kv_len`` (B,) masks keys ≥ kv_len[b]. Masked
    scores are -1e30, as in the kernel. → (B,H,Sq,D) in q's dtype."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    kf = k.to(torch.float32).repeat_interleave(G, dim=1)
    vf = v.to(torch.float32).repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kf) * (D ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    mask = mask[None, None]
    if kv_len is not None:
        mask = mask & (k_pos[None, None] < kv_len.reshape(-1, 1, 1, 1))
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
