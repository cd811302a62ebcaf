"""Wrappers for the hand-written kernels (port of ``repro/kernels/ops.py``).

Each wrapper checks device, dtype, shape and contiguity, then:

* for tensors on the CPU, runs the kernel's plain PyTorch version
  (:mod:`repro_torch.kernels.ref`);
* for tensors on a CUDA card, launches the CUDA kernel through its launcher
  module (``act_quantize``, ``qgemm``, ``flash_attention``; built at first use by
  :mod:`repro_torch.kernels.build`) on the current stream, or raises. Nothing
  falls back: a failed build or launch is an error.

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
from repro_torch.kernels.qgemm import qgemm_w8a8_cuda

LAUNCHES = {"act_quantize": 0, "qgemm_w8a8": 0, "flash_attention": 0}


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
