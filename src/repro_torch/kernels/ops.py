"""Wrappers for the hand-written kernels (port of ``repro/kernels/ops.py``).

Each wrapper checks device, dtype, shape and contiguity, then:

* for tensors on the CPU, runs the kernel's plain PyTorch version
  (:mod:`repro_torch.kernels.ref`);
* for tensors on a CUDA card, launches the CUDA kernel through its launcher
  module (``act_quantize``, ``qgemm``, ``flash_attention``, ``paged_attention``;
  built at first use by :mod:`repro_torch.kernels.build`) on the current stream,
  or raises. Nothing falls back: a failed build or launch is an error.

The sparse GEMM routes as the reference's ``lax.cond`` does: a leaf whose mask
leaves no weight tile empty runs the dense K2 (bitwise the same result), any
other runs K7 with the tile-occupancy table. The table is derived once per leaf
where the served tree is prepared (``models.quantize.with_tile_occupancy``) and
passed in, so a serving step does not sync the host once per linear; K7's bodies
read it on the card.

K1 has three bodies (:func:`repro_torch.kernels.act_quantize.act_quantize_plan`:
a cluster-split row for few rows, register-resident rows for more, two sweeps
beyond the registers). K2, K7 and K8 have three each:
:func:`repro_torch.kernels.qgemm.qgemm_w8a8_plan`, ``qgemm_w8a8_sparse_plan`` and
``qgemm_w4a8_plan`` send few activation rows to the split-K weight stream, more to
the ``wgmma`` body and shapes neither takes to the 64 × 64 tile body (K7's decode
and wgmma bodies skip the empty tiles); K3 and K4–K6 run a bf16 tensor-core body
or an f32 body by dtype.

Outputs are allocated with ``torch.empty``; the kernels allocate nothing. The
reference pads to block multiples; the kernels mask their ragged edges instead.
``act_quantize_experts`` and ``qgemm_w8a8_experts`` are K1's and K2's
expert-batched modes for an MoE's stacked linears: one launch per stacked linear
for all E experts (K1's rows carry their expert's column factors and exponent,
K2's grid carries the expert), counted under ``act_quantize`` and ``qgemm_w8a8``
and, per body, under ``act_quantize/experts_*`` and ``qgemm_w8a8/experts_*``.

``LAUNCHES`` counts kernel launches per op (never plain-version calls), so a run
can show that its path went through the kernels; ``BODY_LAUNCHES`` counts them
per body of the ops that have several (K1; K2; K7; K8; K3; K4–K6, whose bf16 body is
split tensor-core attention and whose f32 body runs on the CUDA cores).
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.act_quantize import DTYPE_CODE, act_quantize_cuda, act_quantize_plan
from repro_torch.kernels.flash_attention import BODIES, HEAD_DIMS, flash_attention_cuda
from repro_torch.kernels.paged_attention import (
    BODIES as PAGED_BODIES, HEAD_DIMS as PAGED_HEAD_DIMS, POOL_CODE, paged_attention_cuda,
    ragged_prefill_cuda,
)
from repro_torch.kernels.qgemm import (
    TILE_K, TILE_N, qgemm_w4a8_cuda, qgemm_w4a8_decode_cuda, qgemm_w4a8_plan,
    qgemm_w4a8_wgmma_cuda, qgemm_w8a8_cuda, qgemm_w8a8_decode_cuda, qgemm_w8a8_plan,
    qgemm_w8a8_sparse_cuda, qgemm_w8a8_sparse_decode_cuda, qgemm_w8a8_sparse_plan,
    qgemm_w8a8_sparse_wgmma_cuda, qgemm_w8a8_wgmma_cuda,
)

LAUNCHES = {"act_quantize": 0, "qgemm_w8a8": 0, "flash_attention": 0,
            "paged_decode_attention": 0, "paged_verify_attention": 0,
            "ragged_prefill_attention": 0, "qgemm_w8a8_sparse": 0, "qgemm_w4a8": 0}
BODY_LAUNCHES = {"act_quantize/split": 0, "act_quantize/rows": 0, "act_quantize/sweep": 0,
                 "act_quantize/experts_split": 0, "act_quantize/experts_rows": 0,
                 "act_quantize/experts_sweep": 0,
                 "qgemm_w8a8/decode": 0, "qgemm_w8a8/wgmma": 0, "qgemm_w8a8/tile": 0,
                 "qgemm_w8a8/experts_decode": 0, "qgemm_w8a8/experts_wgmma": 0,
                 "qgemm_w8a8/experts_tile": 0,
                 "qgemm_w8a8_sparse/decode": 0, "qgemm_w8a8_sparse/wgmma": 0,
                 "qgemm_w8a8_sparse/tile": 0,
                 "qgemm_w4a8/decode": 0, "qgemm_w4a8/wgmma": 0, "qgemm_w4a8/tile": 0,
                 "flash_attention/bf16_mma": 0, "flash_attention/f32": 0,
                 "paged_attention/bf16_mma": 0, "paged_attention/f32": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, BODY_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; all must share one device."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        _require(t.is_contiguous(), f"{name} must be contiguous")


def act_quantize(x: torch.Tensor, bcol: torch.Tensor,
                 alpha: Union[float, torch.Tensor] = 0.15, *, bits: int = 8):
    """Fused CrossQuant activation quantization. x (M, K) f32|bf16; bcol (K,) f32;
    ``alpha`` a float or a one-element f32 tensor on x's device (the prepared
    tree's per-layer ``qalpha``, read by the kernel from device memory so no
    host sync is needed). Returns (codes (M, K) int8, a (M, 1) f32)."""
    _require(x.ndim == 2, f"x must be (M, K), got {tuple(x.shape)}")
    K = x.shape[1]
    _require(bcol.shape == (K,), f"bcol must be ({K},), got {tuple(bcol.shape)}")
    alpha_t = alpha if isinstance(alpha, torch.Tensor) else None
    if not _on_cuda(x, bcol, *(() if alpha_t is None else (alpha_t,))):
        return ref.act_quantize_ref(x, bcol, bits, alpha)
    _require(x.dtype in DTYPE_CODE, f"x dtype {x.dtype} not in f32/bf16")
    _require(bcol.dtype == torch.float32, f"bcol dtype {bcol.dtype} is not f32")
    _contiguous(x=x, bcol=bcol)
    _require(2 <= bits <= 8, f"bits={bits} outside 2..8")
    if alpha_t is not None:
        _require(alpha_t.numel() == 1 and alpha_t.dtype == torch.float32,
                 "alpha tensor must hold one f32 value")
    body, splits = act_quantize_plan(*x.shape)
    out = act_quantize_cuda(x, bcol, alpha_t, 0.0 if alpha_t is not None else float(alpha),
                            bits, body, splits)
    LAUNCHES["act_quantize"] += 1
    BODY_LAUNCHES[f"act_quantize/{body}"] += 1
    return out


def qgemm_w8a8(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
               sw: torch.Tensor) -> torch.Tensor:
    """int8 GEMM + separable dequant. qx (M, K) int8; qw (K, N) int8; a (M, 1) f32;
    sw (N,) f32 → (M, N) f32 = (qx · qw) * a * sw."""
    _require(qx.ndim == 2 and qw.ndim == 2, "qx and qw must be 2-D")
    M, K = qx.shape
    _require(qw.shape[0] == K, f"contraction mismatch {tuple(qx.shape)} x {tuple(qw.shape)}")
    N = qw.shape[1]
    _require(a.shape in ((M, 1), (M,)), f"a must be ({M}, 1), got {tuple(a.shape)}")
    _require(sw.shape == (N,), f"sw must be ({N},), got {tuple(sw.shape)}")
    if not _on_cuda(qx, qw, a, sw):
        return ref.qgemm_w8a8_ref(qx, qw, a.reshape(M, 1), sw)
    _require(qx.dtype == torch.int8 and qw.dtype == torch.int8, "qx and qw must be int8")
    _require(a.dtype == torch.float32 and sw.dtype == torch.float32, "a and sw must be f32")
    _contiguous(qx=qx, qw=qw, a=a, sw=sw)
    aligned = qx.data_ptr() % 16 == 0 and qw.data_ptr() % 16 == 0
    body, splits = qgemm_w8a8_plan(M, K, N, aligned=aligned)
    if body == "decode":
        out = qgemm_w8a8_decode_cuda(qx, qw, a, sw, splits)
    elif body == "wgmma":
        out = qgemm_w8a8_wgmma_cuda(qx, qw, a, sw, splits)
    else:
        out = qgemm_w8a8_cuda(qx, qw, a, sw)
    LAUNCHES["qgemm_w8a8"] += 1
    BODY_LAUNCHES[f"qgemm_w8a8/{body}"] += 1
    return out


def act_quantize_experts(x: torch.Tensor, bcol: torch.Tensor,
                         alpha: Union[float, torch.Tensor] = 0.15, *, bits: int = 8):
    """Expert-batched K1 for a stacked-expert linear: each expert's (C, K) rows
    quantized with its own column factors and exponent, in one launch. x (E, C, K)
    f32|bf16; bcol (E, K) f32; ``alpha`` a float or the prepared tree's (E,) f32
    ``qalpha`` on x's device. Returns (codes (E, C, K) int8, a (E, C, 1) f32). The
    body is :func:`act_quantize_plan`'s for the launch's E·C independent rows."""
    _require(x.ndim == 3, f"x must be (E, C, K), got {tuple(x.shape)}")
    E, C, K = x.shape
    _require(bcol.shape == (E, K), f"bcol must be ({E}, {K}), got {tuple(bcol.shape)}")
    alpha_t = alpha if isinstance(alpha, torch.Tensor) else None
    if alpha_t is not None:
        _require(alpha_t.shape == (E,), f"alpha must be ({E},), got {tuple(alpha_t.shape)}")
    if not _on_cuda(x, bcol, *(() if alpha_t is None else (alpha_t,))):
        return ref.act_quantize_experts_ref(x, bcol, bits, alpha)
    _require(x.dtype in DTYPE_CODE, f"x dtype {x.dtype} not in f32/bf16")
    _require(bcol.dtype == torch.float32, f"bcol dtype {bcol.dtype} is not f32")
    _contiguous(x=x, bcol=bcol)
    _require(2 <= bits <= 8, f"bits={bits} outside 2..8")
    if alpha_t is not None:
        _require(alpha_t.dtype == torch.float32, "alpha must be f32")
        _contiguous(alpha=alpha_t)
    body, splits = act_quantize_plan(E * C, K)
    q, a = act_quantize_cuda(x.reshape(E * C, K), bcol, alpha_t,
                             0.0 if alpha_t is not None else float(alpha), bits, body, splits,
                             rows_per_expert=C)
    LAUNCHES["act_quantize"] += 1
    BODY_LAUNCHES[f"act_quantize/experts_{body}"] += 1
    return q.reshape(E, C, K), a.reshape(E, C, 1)


def qgemm_w8a8_experts(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                       sw: torch.Tensor) -> torch.Tensor:
    """Expert-batched K2 for a stacked-expert linear: every expert's int8 GEMM and
    separable dequant in one launch, the expert on the grid. qx (E, C, K) int8; qw
    (E, K, N) int8; a (E, C, 1) f32; sw (E, N) f32 → (E, C, N) f32 = (qx[e] ·
    qw[e]) * a[e] * sw[e]. The body is :func:`qgemm_w8a8_plan`'s for an expert's
    C rows, its K splits counted over all E experts' output tiles."""
    _require(qx.ndim == 3 and qw.ndim == 3, "qx and qw must be (E, C, K) and (E, K, N)")
    E, C, K = qx.shape
    _require(qw.shape[:2] == (E, K),
             f"expert/contraction mismatch {tuple(qx.shape)} x {tuple(qw.shape)}")
    N = qw.shape[2]
    _require(a.shape == (E, C, 1), f"a must be ({E}, {C}, 1), got {tuple(a.shape)}")
    _require(sw.shape == (E, N), f"sw must be ({E}, {N}), got {tuple(sw.shape)}")
    if not _on_cuda(qx, qw, a, sw):
        return ref.qgemm_w8a8_experts_ref(qx, qw, a, sw)
    _require(qx.dtype == torch.int8 and qw.dtype == torch.int8, "qx and qw must be int8")
    _require(a.dtype == torch.float32 and sw.dtype == torch.float32, "a and sw must be f32")
    _contiguous(qx=qx, qw=qw, a=a, sw=sw)
    aligned = qx.data_ptr() % 16 == 0 and qw.data_ptr() % 16 == 0
    body, splits = qgemm_w8a8_plan(C, K, N, aligned=aligned, experts=E)
    if body == "decode":
        out = qgemm_w8a8_decode_cuda(qx, qw, a, sw, splits, experts=E)
    elif body == "wgmma":
        out = qgemm_w8a8_wgmma_cuda(qx, qw, a, sw, splits, experts=E)
    else:
        out = qgemm_w8a8_cuda(qx, qw, a, sw, experts=E)
    LAUNCHES["qgemm_w8a8"] += 1
    BODY_LAUNCHES[f"qgemm_w8a8/experts_{body}"] += 1
    return out


def _check_rows(qx: torch.Tensor, a: torch.Tensor) -> None:
    M = qx.shape[0]
    _require(a.shape in ((M, 1), (M,)), f"a must be ({M}, 1), got {tuple(a.shape)}")


def tile_occupancy(mask: torch.Tensor, K: int) -> torch.Tensor:
    """(ceil(K/8), N) bit-packed keep-mask → (ceil(K/64), ceil(N/64)) int32, 1
    where the kernel's (64, 64) weight tile holds a surviving weight."""
    kb = TILE_K // 8                                   # packed rows per tile
    n_kt, n_nt = -(-K // TILE_K), -(-mask.shape[1] // TILE_N)
    m = F.pad(mask, (0, n_nt * TILE_N - mask.shape[1], 0, n_kt * kb - mask.shape[0]))
    occ = m.reshape(n_kt, kb, n_nt, TILE_N).amax(dim=(1, 3)) > 0
    return occ.to(torch.int32).contiguous()


def qgemm_w8a8_sparse(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                      sw: torch.Tensor, mask: torch.Tensor,
                      occ: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-sparse int8 GEMM over N:M-pruned weights (K7). qx (M, K) int8; qw
    (K, N) int8, zero wherever ``mask`` is; a (M, 1) f32; sw (N,) f32; ``mask``
    the leaf's (ceil(K/8), N) bit-packed uint8 keep-mask (the reference's wrapper
    takes it unpacked); ``occ`` its :func:`tile_occupancy`, given where some
    (64, 64) weight tile is empty. → (M, N) f32. With ``occ`` the card runs K7 on
    the body ``qgemm_w8a8_sparse_plan`` picks, which skips the empty tiles; without
    it K2, exact as well since qw is zero wherever the mask is. The plain version
    reads the mask."""
    _require(qx.ndim == 2 and qw.ndim == 2, "qx and qw must be 2-D")
    M, K = qx.shape
    _require(qw.shape[0] == K, f"contraction mismatch {tuple(qx.shape)} x {tuple(qw.shape)}")
    N = qw.shape[1]
    _check_rows(qx, a)
    _require(sw.shape == (N,), f"sw must be ({N},), got {tuple(sw.shape)}")
    _require(mask.shape == (-(-K // 8), N), f"mask must be ({-(-K // 8)}, {N}) bit-packed, "
             f"got {tuple(mask.shape)}")
    _require(mask.dtype == torch.uint8, f"mask dtype {mask.dtype} is not uint8")
    if not _on_cuda(qx, qw, a, sw, mask, *(() if occ is None else (occ,))):
        return ref.qgemm_w8a8_sparse_ref(qx, qw, a.reshape(M, 1), sw, mask)
    if occ is None:
        return qgemm_w8a8(qx, qw, a, sw)
    _require(occ.shape == (-(-K // TILE_K), -(-N // TILE_N)) and occ.dtype == torch.int32,
             f"occ must be ({-(-K // TILE_K)}, {-(-N // TILE_N)}) int32, got "
             f"{tuple(occ.shape)} {occ.dtype}")
    _require(qx.dtype == torch.int8 and qw.dtype == torch.int8, "qx and qw must be int8")
    _require(a.dtype == torch.float32 and sw.dtype == torch.float32, "a and sw must be f32")
    _contiguous(qx=qx, qw=qw, a=a, sw=sw, occ=occ)
    aligned = qx.data_ptr() % 16 == 0 and qw.data_ptr() % 16 == 0
    body, splits = qgemm_w8a8_sparse_plan(M, K, N, aligned=aligned)
    if body == "decode":
        out = qgemm_w8a8_sparse_decode_cuda(qx, qw, a, sw, occ, splits)
    elif body == "wgmma":
        out = qgemm_w8a8_sparse_wgmma_cuda(qx, qw, a, sw, occ, splits)
    else:
        out = qgemm_w8a8_sparse_cuda(qx, qw, a, sw, occ)
    LAUNCHES["qgemm_w8a8_sparse"] += 1
    BODY_LAUNCHES[f"qgemm_w8a8_sparse/{body}"] += 1
    return out


def qgemm_w4a8(qx: torch.Tensor, qw4: torch.Tensor, a: torch.Tensor, sw: torch.Tensor,
               *, group: int = 128) -> torch.Tensor:
    """W4A8 grouped GEMM (K8). qx (M, K) int8; qw4 (K/2, N) int8, two int4 codes
    per byte along K; a (M, 1) f32; sw (K/group, N) f32 → (M, N) f32. The kernel
    takes groups that are multiples of 64."""
    _require(qx.ndim == 2 and qw4.ndim == 2, "qx and qw4 must be 2-D")
    M, K = qx.shape
    N = qw4.shape[1]
    _require(K % group == 0 and qw4.shape[0] * 2 == K,
             f"qw4 {tuple(qw4.shape)} does not pack K={K} in groups of {group}")
    _check_rows(qx, a)
    _require(sw.shape == (K // group, N), f"sw must be ({K // group}, {N}), "
             f"got {tuple(sw.shape)}")
    if not _on_cuda(qx, qw4, a, sw):
        return ref.qgemm_w4a8_ref(qx, qw4, a.reshape(M, 1), sw, group)
    _require(qx.dtype == torch.int8 and qw4.dtype == torch.int8, "qx and qw4 must be int8")
    _require(a.dtype == torch.float32 and sw.dtype == torch.float32, "a and sw must be f32")
    _require(group % TILE_K == 0, f"the W4A8 kernel takes groups of multiples of {TILE_K}, "
             f"got {group}")
    _contiguous(qx=qx, qw4=qw4, a=a, sw=sw)
    aligned = all(t.data_ptr() % 16 == 0 for t in (qx, qw4, sw))
    body, splits = qgemm_w4a8_plan(M, K, N, group, aligned=aligned)
    if body == "decode":
        out = qgemm_w4a8_decode_cuda(qx, qw4, a, sw, group, splits)
    elif body == "wgmma":
        out = qgemm_w4a8_wgmma_cuda(qx, qw4, a, sw, group, splits)
    else:
        out = qgemm_w4a8_cuda(qx, qw4, a, sw, group)
    LAUNCHES["qgemm_w4a8"] += 1
    BODY_LAUNCHES[f"qgemm_w4a8/{body}"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[torch.Tensor] = None, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Fused flash attention (forward). q (B, H, Sq, D); k/v (B, Hkv, Sk, D) with
    H % Hkv == 0 → (B, H, Sq, D). ``kv_len`` (scalar or (B,) int) masks keys at
    positions ≥ kv_len[b]; it is clipped to [0, Sk] as the reference does."""
    _require(q.ndim == 4 and k.ndim == 4 and v.ndim == 4, "q, k, v must be 4-D")
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    _require(k.shape == (B, Hkv, Sk, D) and v.shape == k.shape,
             f"k/v must be (B, Hkv, Sk, D): {tuple(k.shape)}, {tuple(v.shape)}")
    _require(Hkv > 0 and H % Hkv == 0, f"H={H} not a multiple of Hkv={Hkv}")
    _require(q.dtype == k.dtype == v.dtype, "q, k, v must share a dtype")
    on_cuda = _on_cuda(q, k, v)
    kvl = None
    if kv_len is not None:
        kvl = torch.as_tensor(kv_len, device=q.device).reshape(-1).to(torch.int32)
        kvl = torch.clamp(kvl, 0, Sk).expand(B).contiguous()
    if not on_cuda:
        return ref.flash_attention_ref(q, k, v, kvl, causal=causal, window=window,
                                       softcap=softcap)
    _require(q.dtype in DTYPE_CODE, f"dtype {q.dtype} not in f32/bf16")
    _require(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    _contiguous(q=q, k=k, v=v)
    _require(window is None or window > 0, f"window must be positive, got {window}")
    _require(softcap is None or softcap > 0, f"softcap must be positive, got {softcap}")
    if q.dtype == torch.bfloat16:
        _require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
                 "bf16 q, k, v must be 16-byte aligned")
    out = flash_attention_cuda(q, k, v, kvl, causal=causal, window=window, softcap=softcap)
    LAUNCHES["flash_attention"] += 1
    BODY_LAUNCHES[f"flash_attention/{BODIES[q.dtype]}"] += 1
    return out


def _int_vec(x, B: int, device) -> torch.Tensor:
    """Scalar or (B,) int → contiguous (B,) int32 on ``device``."""
    return torch.as_tensor(x, device=device).reshape(-1).to(torch.int32).expand(B).contiguous()


def _check_pools(H: int, D: int, k_pages, v_pages, page_table, k_scale_pages,
                 v_scale_pages) -> None:
    """Shapes of the paged wrappers' pools, page table and scale pools."""
    _require(k_pages.ndim == 4 and v_pages.shape == k_pages.shape,
             f"pools must be (P, ps, Hkv, D): {tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    P, ps, Hkv = k_pages.shape[:3]
    _require(k_pages.shape[3] == D, f"pool head_dim {k_pages.shape[3]} != q's {D}")
    _require(Hkv > 0 and H % Hkv == 0, f"H={H} not a multiple of Hkv={Hkv}")
    _require(page_table.ndim == 2, f"page_table must be (B, maxP), got {tuple(page_table.shape)}")
    _require((k_scale_pages is None) == (v_scale_pages is None),
             "pass both scale pools or neither")
    if k_scale_pages is not None:
        _require(k_scale_pages.shape == (P, ps, Hkv, 1) == v_scale_pages.shape,
                 f"scale pools must be ({P}, {ps}, {Hkv}, 1)")


def _check_pools_cuda(q, k_pages, v_pages, k_scale_pages, v_scale_pages) -> None:
    """dtype and layout rules of the paged kernels, for tensors on a card."""
    _require(q.dtype in DTYPE_CODE, f"q dtype {q.dtype} not in f32/bf16")
    _require(k_pages.dtype in POOL_CODE and v_pages.dtype == k_pages.dtype,
             f"pool dtype {k_pages.dtype} not in f32/bf16/int8")
    _require((k_pages.dtype == torch.int8) == (k_scale_pages is not None),
             "int8 pools need their scale pools, and only they take them")
    if k_scale_pages is not None:
        _require(k_scale_pages.dtype == torch.float32 == v_scale_pages.dtype,
                 "scale pools must be f32")
        _contiguous(k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
    _require(q.shape[-1] in PAGED_HEAD_DIMS,
             f"head_dim {q.shape[-1]} not in {PAGED_HEAD_DIMS}")
    _contiguous(k_pages=k_pages, v_pages=v_pages)


def _check_paged(q, k_pages, v_pages, page_table, k_scale_pages, v_scale_pages) -> bool:
    """Shared checks of the decode/verify wrappers; True when the tensors lie on a
    card."""
    _require(q.ndim == 4, f"q must be (B, S, H, D), got {tuple(q.shape)}")
    B, _, H, D = q.shape
    _check_pools(H, D, k_pages, v_pages, page_table, k_scale_pages, v_scale_pages)
    _require(page_table.shape[0] == B,
             f"page_table must be ({B}, maxP), got {tuple(page_table.shape)}")
    scales = () if k_scale_pages is None else (k_scale_pages, v_scale_pages)
    if not _on_cuda(q, k_pages, v_pages, page_table, *scales):
        return False
    _check_pools_cuda(q, k_pages, v_pages, k_scale_pages, v_scale_pages)
    return True


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_table: torch.Tensor, kv_len, *,
                           k_scale_pages: Optional[torch.Tensor] = None,
                           v_scale_pages: Optional[torch.Tensor] = None,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Paged single-token decode attention (K4). q (B, 1, H, D) against (P, ps,
    Hkv, D) pools addressed through a (B, maxP) int page table, with per-slot
    valid lengths ``kv_len`` (scalar or (B,)) → (B, 1, H, D) in q's dtype. With
    ``k_scale_pages``/``v_scale_pages`` ((P, ps, Hkv, 1) f32) the pools hold int8
    codes; the pools may have another float dtype than q."""
    on_cuda = _check_paged(q, k_pages, v_pages, page_table, k_scale_pages, v_scale_pages)
    B, S, H, D = q.shape
    _require(S == 1, f"decode takes one token per slot, got {S}")
    Hkv = k_pages.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D)
    kvl = _int_vec(kv_len, B, q.device)
    if not on_cuda:
        out = ref.paged_decode_attention_ref(
            qg, k_pages, v_pages, page_table, kvl, k_scale_pages=k_scale_pages,
            v_scale_pages=v_scale_pages, window=window, softcap=softcap)
        return out.reshape(B, 1, H, D)
    _require(window is None or window > 0, f"window must be positive, got {window}")
    _require(softcap is None or softcap > 0, f"softcap must be positive, got {softcap}")
    out = paged_attention_cuda(qg.contiguous(), k_pages, v_pages, k_scale_pages,
                               v_scale_pages, page_table.to(torch.int32).contiguous(), kvl,
                               None, q_win=1, window=window, softcap=softcap)
    LAUNCHES["paged_decode_attention"] += 1
    BODY_LAUNCHES[f"paged_attention/{PAGED_BODIES[q.dtype]}"] += 1
    return out.reshape(B, 1, H, D)


def paged_verify_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_table: torch.Tensor, kv_len, q_len, *,
                           k_scale_pages: Optional[torch.Tensor] = None,
                           v_scale_pages: Optional[torch.Tensor] = None,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Paged draft-window verify attention (K5). q (B, W, H, D): W window tokens
    per slot, already scattered into the pools; ``kv_len`` each slot's total
    post-scatter length and ``q_len`` its valid window rows (window token i sits
    at kv_len - q_len + i; rows ≥ q_len are finite and meaningless) → (B, W, H,
    D). W == 1 forces q_len == 1, where the verify mask is the decode mask: it
    runs the decode path (kernel or plain version), so it is bitwise the decode
    result."""
    on_cuda = _check_paged(q, k_pages, v_pages, page_table, k_scale_pages, v_scale_pages)
    B, W, H, D = q.shape
    if W == 1:
        return paged_decode_attention(q, k_pages, v_pages, page_table, kv_len,
                                      k_scale_pages=k_scale_pages,
                                      v_scale_pages=v_scale_pages, window=window,
                                      softcap=softcap)
    Hkv = k_pages.shape[2]
    G = H // Hkv
    kvl = _int_vec(kv_len, B, q.device)
    qln = _int_vec(q_len, B, q.device)
    # (B, W, H, D) → (B, Hkv, W, G, D): rows ordered (window, group) per kv head
    qg = q.reshape(B, W, Hkv, G, D).permute(0, 2, 1, 3, 4)
    if not on_cuda:
        out = ref.paged_verify_attention_ref(
            qg, k_pages, v_pages, page_table, kvl, qln, k_scale_pages=k_scale_pages,
            v_scale_pages=v_scale_pages, window=window, softcap=softcap)
        return out.permute(0, 2, 1, 3, 4).reshape(B, W, H, D)
    _require(window is None or window > 0, f"window must be positive, got {window}")
    _require(softcap is None or softcap > 0, f"softcap must be positive, got {softcap}")
    out = paged_attention_cuda(qg.reshape(B, Hkv, W * G, D).contiguous(), k_pages, v_pages,
                               k_scale_pages, v_scale_pages,
                               page_table.to(torch.int32).contiguous(), kvl, qln, q_win=W,
                               window=window, softcap=softcap)
    LAUNCHES["paged_verify_attention"] += 1
    BODY_LAUNCHES[f"paged_attention/{PAGED_BODIES[q.dtype]}"] += 1
    return out.reshape(B, Hkv, W, G, D).permute(0, 2, 1, 3, 4).reshape(B, W, H, D)


def ragged_prefill_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                             k_pages: torch.Tensor, v_pages: torch.Tensor,
                             page_table: torch.Tensor, q_start, q_len, kv_len, *,
                             chunk_cap: int, k_scale_pages: Optional[torch.Tensor] = None,
                             v_scale_pages: Optional[torch.Tensor] = None,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None) -> torch.Tensor:
    """Ragged chunked-prefill attention over the paged pool (K6). q (Nt, H, D) is a
    packed block whose slot b owns rows ``[q_start[b], q_start[b] + q_len[b])``
    (``q_len ≤ chunk_cap``; 0 marks a dead slot); k_new/v_new (Nt, Hkv, D) are
    the packed tokens' fp K/V, already scattered into the pools; ``kv_len`` (B,)
    each slot's visible length after the scatter, so chunk token i sits at
    ``kv_len - q_len + i`` and attends keys up to its own position, its chunk's
    keys read from k_new/v_new (int8 scales 1). Pools, page table and scale pools
    as :func:`paged_decode_attention`. → (Nt, H, D) in q's dtype, zero at rows no
    slot owns."""
    _require(q.ndim == 3, f"q must be (Nt, H, D), got {tuple(q.shape)}")
    Nt, H, D = q.shape
    _check_pools(H, D, k_pages, v_pages, page_table, k_scale_pages, v_scale_pages)
    Hkv = k_pages.shape[2]
    _require(k_new.shape == (Nt, Hkv, D) == v_new.shape,
             f"k_new/v_new must be ({Nt}, {Hkv}, {D}): {tuple(k_new.shape)}, "
             f"{tuple(v_new.shape)}")
    B = page_table.shape[0]
    qs = _int_vec(q_start, B, q.device)
    qln = _int_vec(q_len, B, q.device)
    kvl = _int_vec(kv_len, B, q.device)
    scales = () if k_scale_pages is None else (k_scale_pages, v_scale_pages)
    if not _on_cuda(q, k_new, v_new, k_pages, v_pages, page_table, *scales):
        out = ref.ragged_prefill_attention_ref(
            q.reshape(Nt, Hkv, H // Hkv, D), k_new, v_new, k_pages, v_pages, page_table,
            qs, qln, kvl, chunk_cap=chunk_cap, k_scale_pages=k_scale_pages,
            v_scale_pages=v_scale_pages, window=window, softcap=softcap)
        return out.reshape(Nt, H, D)
    _check_pools_cuda(q, k_pages, v_pages, k_scale_pages, v_scale_pages)
    _require(k_new.dtype == q.dtype == v_new.dtype, "k_new/v_new must have q's dtype")
    _contiguous(q=q, k_new=k_new, v_new=v_new)
    _require(window is None or window > 0, f"window must be positive, got {window}")
    _require(softcap is None or softcap > 0, f"softcap must be positive, got {softcap}")
    _require(chunk_cap >= 1, f"chunk_cap must be positive, got {chunk_cap}")
    out = ragged_prefill_cuda(q, k_new, v_new, k_pages, v_pages, k_scale_pages, v_scale_pages,
                              page_table.to(torch.int32).contiguous(), qs, qln, kvl,
                              chunk_cap=chunk_cap, window=window, softcap=softcap)
    LAUNCHES["ragged_prefill_attention"] += 1
    BODY_LAUNCHES[f"paged_attention/{PAGED_BODIES[q.dtype]}"] += 1
    return out
