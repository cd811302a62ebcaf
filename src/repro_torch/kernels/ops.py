"""Wrappers for the hand-written kernels (port of ``repro/kernels/ops.py``).

Each wrapper checks device, dtype, shape and contiguity, then:

* for tensors on the CPU, runs the kernel's plain PyTorch version
  (:mod:`repro_torch.kernels.ref`);
* for tensors on a CUDA card, launches the CUDA kernel through its launcher
  module (``act_quantize``, ``qgemm``, ``flash_attention``, ``paged_attention``;
  built at first use by :mod:`repro_torch.kernels.build`) on the current stream,
  or raises. Nothing falls back: a failed build or launch is an error.

Outputs are allocated with ``torch.empty``; the kernels allocate nothing. The
reference pads to block multiples; the kernels mask their ragged edges instead.
``LAUNCHES`` counts kernel launches (never plain-version calls), so a run can
show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.act_quantize import DTYPE_CODE, act_quantize_cuda
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention_cuda
from repro_torch.kernels.paged_attention import POOL_CODE, paged_attention_cuda
from repro_torch.kernels.qgemm import qgemm_w8a8_cuda

LAUNCHES = {"act_quantize": 0, "qgemm_w8a8": 0, "flash_attention": 0,
            "paged_decode_attention": 0, "paged_verify_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    out = act_quantize_cuda(x, bcol, alpha_t, 0.0 if alpha_t is not None else float(alpha),
                            bits)
    LAUNCHES["act_quantize"] += 1
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
    out = qgemm_w8a8_cuda(qx, qw, a, sw)
    LAUNCHES["qgemm_w8a8"] += 1
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
    out = flash_attention_cuda(q, k, v, kvl, causal=causal, window=window, softcap=softcap)
    LAUNCHES["flash_attention"] += 1
    return out


def _int_vec(x, B: int, device) -> torch.Tensor:
    """Scalar or (B,) int → contiguous (B,) int32 on ``device``."""
    return torch.as_tensor(x, device=device).reshape(-1).to(torch.int32).expand(B).contiguous()


def _check_paged(q, k_pages, v_pages, page_table, k_scale_pages, v_scale_pages) -> bool:
    """Shared checks of the paged wrappers; True when the tensors lie on a card."""
    _require(q.ndim == 4, f"q must be (B, S, H, D), got {tuple(q.shape)}")
    _require(k_pages.ndim == 4 and v_pages.shape == k_pages.shape,
             f"pools must be (P, ps, Hkv, D): {tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, _, H, D = q.shape
    P, ps, Hkv = k_pages.shape[:3]
    _require(k_pages.shape[3] == D, f"pool head_dim {k_pages.shape[3]} != q's {D}")
    _require(Hkv > 0 and H % Hkv == 0, f"H={H} not a multiple of Hkv={Hkv}")
    _require(page_table.ndim == 2 and page_table.shape[0] == B,
             f"page_table must be ({B}, maxP), got {tuple(page_table.shape)}")
    _require((k_scale_pages is None) == (v_scale_pages is None),
             "pass both scale pools or neither")
    if k_scale_pages is not None:
        _require(k_scale_pages.shape == (P, ps, Hkv, 1) == v_scale_pages.shape,
                 f"scale pools must be ({P}, {ps}, {Hkv}, 1)")
    scales = () if k_scale_pages is None else (k_scale_pages, v_scale_pages)
    if not _on_cuda(q, k_pages, v_pages, page_table, *scales):
        return False
    _require(q.dtype in DTYPE_CODE, f"q dtype {q.dtype} not in f32/bf16")
    _require(k_pages.dtype in POOL_CODE and v_pages.dtype == k_pages.dtype,
             f"pool dtype {k_pages.dtype} not in f32/bf16/int8")
    _require((k_pages.dtype == torch.int8) == (k_scale_pages is not None),
             "int8 pools need their scale pools, and only they take them")
    if k_scale_pages is not None:
        _require(k_scale_pages.dtype == torch.float32 == v_scale_pages.dtype,
                 "scale pools must be f32")
        _contiguous(k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
    _require(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    _contiguous(k_pages=k_pages, v_pages=v_pages)
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
    return out.reshape(B, Hkv, W, G, D).permute(0, 2, 1, 3, 4).reshape(B, W, H, D)
