"""Plain PyTorch versions of the ported kernels (port of ``repro/kernels/ref.py``).

They are the semantic ground truth the CUDA kernels are held against on the card,
and the path ``kernels/ops.py`` takes for tensors that lie on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import packing
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


def qgemm_w8a8_acc_ref(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """int32-out mode of K2: the (M, N) int32 accumulator qx · qw, undequantized
    (an exact float64 product of the codes, |acc| ≤ 127²·K < 2^31 for K < 2^17)."""
    return torch.matmul(qx.to(torch.float64), qw.to(torch.float64)).to(torch.int32)


def qgemm_w8a8_sparse_acc_ref(qx: torch.Tensor, qw: torch.Tensor,
                              mask: torch.Tensor) -> torch.Tensor:
    """int32-out mode of K7: the masked product's int32 accumulator."""
    keep = packing.unpack_mask(mask, count=qw.shape[0], axis=0)
    return qgemm_w8a8_acc_ref(qx, qw * keep.to(qw.dtype))


def qgemm_w8a8_sparse_ref(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                          sw: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """N:M-sparse int8 GEMM (plain version of K7): the masked dense GEMM. ``mask``
    is the (ceil(K/8), N) bit-packed keep-mask leaf; ``qw`` is already zero where
    it is, and the multiply keeps the oracle exact on inconsistent inputs."""
    keep = packing.unpack_mask(mask, count=qw.shape[0], axis=0)
    return qgemm_w8a8_ref(qx, qw * keep.to(qw.dtype), a, sw)


def qgemm_w4a8_ref(qx: torch.Tensor, qw4: torch.Tensor, a: torch.Tensor, sw: torch.Tensor,
                   group: int = 128) -> torch.Tensor:
    """W4A8 grouped GEMM (plain version of K8). qx (M, K) int8; qw4 (K/2, N) int8,
    two int4 codes per byte packed along K; a (M, 1) f32; sw (K/group, N) f32.
    Per-group integer partial sums (an exact float64 product), dequantized by
    sw[g], summed over the groups, then × a."""
    M, K = qx.shape
    qw = packing.unpack_int4(qw4, axis=-2)
    ng = K // group
    acc = torch.einsum("mgk,gkn->mgn", qx.reshape(M, ng, group).to(torch.float64),
                       qw.reshape(ng, group, -1).to(torch.float64))
    return (acc.to(torch.float32) * sw.to(torch.float32)).sum(dim=-2) * a.to(torch.float32)


def qgemm_w4a8_group_acc_ref(qx: torch.Tensor, qw4: torch.Tensor,
                             group: int = 128) -> torch.Tensor:
    """Group-acc mode of K8: the (M, K/group, N) int32 per-group partial sums of
    :func:`qgemm_w4a8_ref`, undequantized (exact float64 products)."""
    M, K = qx.shape
    qw = packing.unpack_int4(qw4, axis=-2)
    ng = K // group
    acc = torch.einsum("mgk,gkn->mgn", qx.reshape(M, ng, group).to(torch.float64),
                       qw.reshape(ng, group, -1).to(torch.float64))
    return acc.to(torch.int32)


def act_quantize_ref(x: torch.Tensor, bcol: torch.Tensor, bits: int = 8, alpha=0.15,
                     row_max: Optional[torch.Tensor] = None):
    """Fused CrossQuant activation quantization (static-c path), as the Pallas
    kernel computes it: row absmax floored at EPS in f32, ``a = t^α / qmax``
    (evaluated as ``t^α · (1/qmax)``, the form XLA compiles a division by a
    constant into), codes ``clip(round(x / (a·bcol)))``. ``alpha`` is a float or
    a one-element f32 tensor (the prepared tree's ``qalpha``). Given-max mode:
    ``row_max`` (M,) f32 replaces the row absmax (x then holds a shard of each
    row's columns; the max is the whole row's), floored at EPS once.
    → (codes (M,K) int8, a (M,1) f32)."""
    qm = Q.qmax(bits)
    xf = x.to(torch.float32)
    amax = (xf.abs().amax(dim=-1, keepdim=True) if row_max is None
            else row_max.to(torch.float32).reshape(-1, 1))
    t = torch.clamp_min(amax, Q.EPS)
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.to(torch.float32).reshape(1, 1)
    a = (t ** alpha) * (1.0 / qm)
    q = torch.clamp(torch.round(xf / (a * bcol.to(torch.float32))), -qm, qm)
    return q.to(torch.int8), a


def act_quantize_experts_ref(x: torch.Tensor, bcol: torch.Tensor, bits: int = 8, alpha=0.15,
                            row_max: Optional[torch.Tensor] = None):
    """Expert-batched K1: :func:`act_quantize_ref` on each expert's (C, K) rows with
    its own ``bcol[e]`` (K,) and ``alpha[e]`` (``alpha`` a float or an (E,) f32
    tensor). x (E, C, K) → (codes (E, C, K) int8, a (E, C, 1) f32). Given-max mode:
    ``row_max`` (E, C) holds each row's absmax over the whole row."""
    outs = [act_quantize_ref(x[e], bcol[e], bits,
                             alpha[e] if isinstance(alpha, torch.Tensor) else alpha,
                             row_max=None if row_max is None else row_max[e])
            for e in range(x.shape[0])]
    return torch.stack([q for q, _ in outs]), torch.stack([a for _, a in outs])


def qgemm_w8a8_experts_ref(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                           sw: torch.Tensor) -> torch.Tensor:
    """Expert-batched K2: :func:`qgemm_w8a8_ref` per expert. qx (E, C, K) int8; qw
    (E, K, N) int8; a (E, C, 1) f32; sw (E, N) f32 → (E, C, N) f32."""
    return torch.stack([qgemm_w8a8_ref(qx[e], qw[e], a[e], sw[e]) for e in range(qx.shape[0])])


def qgemm_w8a8_experts_acc_ref(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """Expert-batched K2's int32-out mode: qx (E, C, K) int8 · qw (E, K, N) int8 →
    the (E, C, N) int32 accumulators, undequantized."""
    return torch.matmul(qx.to(torch.float64), qw.to(torch.float64)).to(torch.int32)


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


def _page_gather_index(page_table: torch.Tensor, P: int, ps: int) -> torch.Tensor:
    """(B, maxP) page table → (B, maxP·ps) flat pool positions; sentinel entries
    (≥ P) clamp into the pool, and callers mask those positions."""
    pos = page_table.to(torch.int64)[:, :, None] * ps + torch.arange(ps, device=page_table.device)
    return torch.clamp(pos, 0, P * ps - 1).reshape(page_table.shape[0], -1)


def _gathered(pool: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """(P, ps, Hkv, X) pool through flat positions (B, T) → (B, T, Hkv, X)."""
    return pool.reshape((pool.shape[0] * pool.shape[1],) + pool.shape[2:])[gidx]


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                               page_table: torch.Tensor, kv_len: torch.Tensor, *,
                               k_scale_pages: Optional[torch.Tensor] = None,
                               v_scale_pages: Optional[torch.Tensor] = None,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None) -> torch.Tensor:
    """Paged single-token decode attention (plain version of K4).

    q (B, Hkv, G, D); k/v pages (P, ps, Hkv, D); page_table (B, maxP) int
    (entries ≥ P are invalid: clamped here, masked by kv_len); kv_len (B,) valid
    lengths, the newest token at kv_len - 1. Gathers the logical (B, maxP·ps,
    Hkv, D) view and runs plain-softmax attention in f32. With int8 pools the
    (P, ps, Hkv, 1) scale pools multiply the score column (K, before softcap
    and mask) and the probability row (V, after the softmax).
    → (B, Hkv, G, D) in q's dtype."""
    P, ps = k_pages.shape[0], k_pages.shape[1]
    D = q.shape[-1]
    gidx = _page_gather_index(page_table, P, ps)
    kf = _gathered(k_pages, gidx).to(torch.float32)
    vf = _gathered(v_pages, gidx).to(torch.float32)

    def score_scales(pool):        # → (B, Hkv, 1, T)
        return _gathered(pool, gidx)[..., 0].permute(0, 2, 1)[:, :, None, :]

    s = torch.einsum("bhgd,bthd->bhgt", q.to(torch.float32), kf) * (D ** -0.5)
    if k_scale_pages is not None:
        s = s * score_scales(k_scale_pages)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    t_pos = torch.arange(gidx.shape[1], device=q.device)[None, None, None, :]
    cl = kv_len.reshape(-1, 1, 1, 1)
    valid = t_pos < cl
    if window is not None:
        valid = valid & ((cl - 1 - t_pos) < window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if v_scale_pages is not None:
        p = p * score_scales(v_scale_pages)
    return torch.einsum("bhgt,bthd->bhgd", p, vf).to(q.dtype)


def paged_verify_attention_ref(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                               page_table: torch.Tensor, kv_len: torch.Tensor,
                               q_len: torch.Tensor, *,
                               k_scale_pages: Optional[torch.Tensor] = None,
                               v_scale_pages: Optional[torch.Tensor] = None,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None) -> torch.Tensor:
    """Draft-window verify attention (plain version of K5).

    q (B, Hkv, W, G, D): W window tokens per slot, already scattered into the
    pools; kv_len (B,) total post-scatter length; q_len (B,) valid window rows
    (1 ≤ q_len ≤ W), window token i at absolute position kv_len - q_len + i.
    Per-row causal mask over the gathered view, otherwise exactly
    :func:`paged_decode_attention_ref`. Rows ≥ q_len clamp to the newest valid
    position (finite, discarded by callers). → (B, Hkv, W, G, D)."""
    P, ps = k_pages.shape[0], k_pages.shape[1]
    W, D = q.shape[2], q.shape[-1]
    gidx = _page_gather_index(page_table, P, ps)
    kf = _gathered(k_pages, gidx).to(torch.float32)
    vf = _gathered(v_pages, gidx).to(torch.float32)

    def score_scales(pool):        # → (B, Hkv, 1, 1, T)
        return _gathered(pool, gidx)[..., 0].permute(0, 2, 1)[:, :, None, None, :]

    s = torch.einsum("bhwgd,bthd->bhwgt", q.to(torch.float32), kf) * (D ** -0.5)
    if k_scale_pages is not None:
        s = s * score_scales(k_scale_pages)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kvl = kv_len.to(torch.int64)
    qln = q_len.to(torch.int64)
    q_pos = ((kvl - qln)[:, None]
             + torch.minimum(torch.arange(W, device=q.device)[None, :], (qln - 1)[:, None]))
    t_pos = torch.arange(gidx.shape[1], device=q.device)[None, None, None, None, :]
    qp = q_pos[:, None, :, None, None]
    valid = t_pos <= qp
    if window is not None:
        valid = valid & ((qp - t_pos) < window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if v_scale_pages is not None:
        p = p * score_scales(v_scale_pages)
    return torch.einsum("bhwgt,bthd->bhwgd", p, vf).to(q.dtype)


def ragged_prefill_attention_ref(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                                 page_table: torch.Tensor, q_start: torch.Tensor,
                                 q_len: torch.Tensor, kv_len: torch.Tensor, *, chunk_cap: int,
                                 k_scale_pages: Optional[torch.Tensor] = None,
                                 v_scale_pages: Optional[torch.Tensor] = None,
                                 window: Optional[int] = None,
                                 softcap: Optional[float] = None) -> torch.Tensor:
    """Ragged chunked-prefill attention (plain version of K6).

    q (N, Hkv, G, D) is a packed ragged block: slot b owns rows ``[q_start[b],
    q_start[b] + q_len[b])`` (``q_len ≤ chunk_cap``; 0 marks a dead slot).
    ``kv_len`` (B,) is each slot's visible length after the chunk's scatter, so
    the chunk starts at ``cs = kv_len - q_len`` and chunk token i attends keys at
    positions ≤ cs + i. Positions in ``[cs, kv_len)`` read the packed fp
    ``k_new``/``v_new`` (N, Hkv, D) rows instead of the pool, with int8 scales
    set to 1; earlier positions read the pool through the page table with the
    decode numerics. Rows no slot owns are zero. → (N, Hkv, G, D) in q's dtype."""
    P, ps = k_pages.shape[0], k_pages.shape[1]
    B, maxP = page_table.shape
    N, Hkv, G, D = q.shape
    C, T, dev = chunk_cap, maxP * ps, q.device
    gidx = _page_gather_index(page_table, P, ps)
    kf = _gathered(k_pages, gidx).to(torch.float32)              # (B, T, Hkv, D)
    vf = _gathered(v_pages, gidx).to(torch.float32)
    qs = q_start.to(torch.int64)
    qln = q_len.to(torch.int64)
    kvl = kv_len.to(torch.int64)
    cs = kvl - qln
    t_pos = torch.arange(T, device=dev)
    in_chunk = (t_pos[None] >= cs[:, None]) & (t_pos[None] < kvl[:, None])      # (B, T)
    ov = torch.clamp(qs[:, None] + t_pos[None] - cs[:, None], 0, N - 1)
    kf = torch.where(in_chunk[..., None, None], k_new[ov].to(torch.float32), kf)
    vf = torch.where(in_chunk[..., None, None], v_new[ov].to(torch.float32), vf)

    def score_scales(pool):        # → (B, Hkv, 1, 1, T), 1 on the chunk's own keys
        flat = _gathered(pool, gidx)[..., 0]
        flat = torch.where(in_chunk[..., None], torch.ones_like(flat), flat)
        return flat.permute(0, 2, 1)[:, :, None, None, :]

    ar = torch.arange(C, device=dev)
    ridx = torch.clamp(qs[:, None] + ar[None], 0, N - 1)                        # (B, C)
    qb = q[ridx].permute(0, 2, 1, 3, 4)                                          # (B,Hkv,C,G,D)
    s = torch.einsum("bhcgd,bthd->bhcgt", qb.to(torch.float32), kf) * (D ** -0.5)
    if k_scale_pages is not None:
        s = s * score_scales(k_scale_pages)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = cs[:, None] + torch.minimum(ar[None], torch.clamp_min(qln - 1, 0)[:, None])
    qp = q_pos[:, None, :, None, None]
    tp = t_pos[None, None, None, None, :]
    valid = tp <= qp
    if window is not None:
        valid = valid & ((qp - tp) < window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if v_scale_pages is not None:
        p = p * score_scales(v_scale_pages)
    ob = torch.einsum("bhcgt,bthd->bhcgd", p, vf).permute(0, 2, 1, 3, 4).to(q.dtype)
    out = torch.zeros((N + 1, Hkv, G, D), dtype=q.dtype, device=dev)
    tgt = torch.where(ar[None] < qln[:, None], qs[:, None] + ar[None], N)      # N: dropped
    out[tgt.reshape(-1)] = ob.reshape(B * C, Hkv, G, D)
    return out[:N]
