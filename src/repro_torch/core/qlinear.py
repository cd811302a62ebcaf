"""Quantized linear layer (port of ``repro/core/qlinear.py``: the fp and int8 modes).

Params are plain dicts of tensors. A raw linear is ``{"w": (d_in, d_out)}`` (or a
stacked ``(L, d_in, d_out)``); :func:`prepare_int8` turns it into the prepared
``{"qw", "sw", "bcol", "qalpha"}`` leaves of static-c CrossQuant.

Execution of a prepared linear (``int_exec``):

* ``"ref"`` (default) — :func:`quantize_act_int8` then :func:`_int8_matmul_ref`, an
  exact integer product formed in float64 (|acc| < 2^53) outside any kernel.
* ``"kernel"``       — :func:`_int8_kernel`: ``act_quantize`` then the GEMM the
  leaf asks for in ``kernels/ops.py`` (hand-written CUDA on the card, plain torch
  on CPU): ``qgemm_w8a8``, ``qgemm_w8a8_sparse`` for a leaf with an N:M ``mask``,
  ``qgemm_w4a8`` for a packed-int4 ``qw4`` leaf (:func:`prepare_int4`).

The reference's ``fake`` mode and ``dequant`` backend are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.core import quantizers as Q


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantization behaviour for every quantized linear in a model."""

    mode: str = "fp"                 # fp | fake | int8
    a_bits: int = 8
    w_bits: int = 8
    alpha: float = 0.15              # CrossQuant activation exponent
    act_quant: str = "crossquant"    # per_token | crossquant | none
    w_quant: str = "per_channel"     # per_channel | group | crossquant_w
    w_group: int = 128

    def tag(self) -> str:
        if self.mode == "fp":
            return "fp16"
        g = f"-g{self.w_group}" if self.w_quant == "group" else ""
        return f"W{self.w_bits}A{self.a_bits}{g}[{self.act_quant},a={self.alpha}]"


FP = QuantConfig(mode="fp")
W4A8_G128 = QuantConfig(mode="fake", a_bits=8, w_bits=4, w_quant="group")
W8A8_INT8 = QuantConfig(mode="int8", a_bits=8, w_bits=8)


def init(gen: torch.Generator, d_in: int, d_out: int, *, n_stack: Optional[int] = None,
         device: torch.device) -> dict:
    shape = (d_in, d_out) if n_stack is None else (n_stack, d_in, d_out)
    return {"w": torch.randn(shape, generator=gen, device=device) * d_in ** -0.5}


# ======================================================================================
# int8 path: static-c CrossQuant
# ======================================================================================

def prepare_int8(params: dict, cfg: QuantConfig,
                 cmax: Optional[torch.Tensor] = None) -> dict:
    """Offline weight preparation: fold b_j = c_j^(1-α) into W, per-output-channel
    int8 quantization. Returns a prepared parameter dict (raw ``w`` dropped).
    Without column statistics α degrades to 1 (exact per-token int8)."""
    w = params["w"]
    cm = cmax if cmax is not None else params.get("cmax")
    alpha_eff = cfg.alpha if cm is not None else 1.0
    if cm is None:
        cm = torch.ones(w.shape[-2], dtype=w.dtype, device=w.device)
    cm = torch.as_tensor(cm, device=w.device)
    b = torch.clamp_min(cm, Q.EPS) ** (1.0 - alpha_eff)
    while b.ndim < w.ndim - 1:
        b = b[..., None, :]
    b = b.expand(w.shape[:-1])
    wb = w * b[..., :, None]
    sw = torch.clamp_min(wb.abs().amax(dim=-2, keepdim=True), Q.EPS) / Q.qmax(cfg.w_bits)
    qm = Q.qmax(cfg.w_bits)
    qw = torch.clamp(torch.round(wb / sw), -qm, qm).to(torch.int8)
    return {"qw": qw, "sw": sw.squeeze(-2).to(torch.float32),
            "bcol": b.to(torch.float32).contiguous(),
            "qalpha": torch.full(w.shape[:-2], alpha_eff, dtype=torch.float32,
                                 device=w.device)}


def prepare_int4(params: dict, cfg: QuantConfig,
                 cmax: Optional[torch.Tensor] = None) -> dict:
    """W4 preparation: group-quantize the b-folded weight along d_in with group
    ``cfg.w_group`` and pack the nibbles along d_in. Group scales are
    (..., d_in / group, d_out)."""
    w = params["w"]
    cm = cmax if cmax is not None else params.get("cmax")
    alpha_eff = cfg.alpha if cm is not None else 1.0
    if cm is None:
        cm = torch.ones(w.shape[-2], dtype=w.dtype, device=w.device)
    cm = torch.as_tensor(cm, device=w.device)
    b = torch.clamp_min(cm, Q.EPS) ** (1.0 - alpha_eff)
    while b.ndim < w.ndim - 1:
        b = b[..., None, :]
    b = b.expand(w.shape[:-1])
    wb = w * b[..., :, None]
    *lead, d_in, d_out = wb.shape
    g = cfg.w_group
    if d_in % g:
        raise ValueError(f"d_in={d_in} not divisible by group {g}")
    grouped = wb.reshape(*lead, d_in // g, g, d_out)
    sw = torch.clamp_min(grouped.abs().amax(dim=-2, keepdim=True), Q.EPS) / Q.qmax(4)
    qw = torch.clamp(torch.round(grouped / sw), -Q.qmax(4), Q.qmax(4)).to(torch.int8)
    return {"qw4": packing.pack_int4(qw.reshape(*lead, d_in, d_out), axis=-2),
            "sw": sw.squeeze(-2).to(torch.float32).contiguous(),
            "bcol": b.to(torch.float32).contiguous(),
            "qalpha": torch.full(w.shape[:-2], alpha_eff, dtype=torch.float32,
                                 device=w.device)}


def unpack_int4_weight(qw4: torch.Tensor) -> torch.Tensor:
    """(..., d_in/2, d_out) packed nibbles → (..., d_in, d_out) int8 codes."""
    return packing.unpack_int4(qw4, axis=-2)


def dequant_int4_weight(qw4: torch.Tensor, sw: torch.Tensor, group: int) -> torch.Tensor:
    """Unpack the nibbles and apply the (..., G, d_out) group scales → the f32
    b-folded weight (see :func:`prepare_int4`)."""
    qw = unpack_int4_weight(qw4).to(torch.float32)
    *lead, d_in, d_out = qw.shape
    grouped = qw.reshape(*lead, d_in // group, group, d_out)
    return (grouped * sw[..., :, None, :]).reshape(*lead, d_in, d_out)


def quantize_act_int8(x: torch.Tensor, bcol: torch.Tensor, cfg: QuantConfig, alpha=None):
    """Runtime activation quantization: divide by outer(a_i, b_j).

    ``alpha`` may be the prepared tree's ``qalpha`` tensor; it is broadcast as a
    dimensioned tensor so a bf16 ``t`` promotes to f32, as in the reference.
    ``a = t^α · (1/qmax)``: the reference serves this function under ``jit``,
    where XLA compiles the division by the constant qmax into a multiply by its
    f32 reciprocal."""
    alpha = cfg.alpha if alpha is None else alpha
    if isinstance(alpha, torch.Tensor):
        while alpha.ndim < x.ndim:
            alpha = alpha[..., None]
    while 2 <= bcol.ndim < x.ndim:
        bcol = bcol.unsqueeze(-2)
    t = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), Q.EPS)
    a = (t ** alpha) * (1.0 / Q.qmax(cfg.a_bits))
    qm = Q.qmax(cfg.a_bits)
    qx = torch.clamp(torch.round(x / (a * bcol)), -qm, qm)
    return qx.to(torch.int8), a.to(torch.float32)


def _int8_kernel(params: dict, x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Kernel pipeline for a 2-D prepared linear: ``act_quantize`` emits int8 codes
    and row scales straight into the leaf's GEMM (leading axes flatten to M): the
    sparse GEMM for an N:M leaf (it reads the bit-packed ``mask`` as stored, and
    the ``occ`` table where ``with_tile_occupancy`` attached one), the W4A8 GEMM for a ``qw4`` leaf, else the dense W8A8 GEMM."""
    from repro_torch.kernels import ops

    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    alpha = params.get("qalpha")
    qx, a = ops.act_quantize(x2, params["bcol"], cfg.alpha if alpha is None else alpha,
                             bits=cfg.a_bits)
    if "qw" in params:
        if "mask" in params:
            y = ops.qgemm_w8a8_sparse(qx, params["qw"], a, params["sw"], params["mask"],
                                      params.get("occ"))
        else:
            y = ops.qgemm_w8a8(qx, params["qw"], a, params["sw"])
    else:
        y = ops.qgemm_w4a8(qx, params["qw4"], a, params["sw"], group=cfg.w_group)
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


def _int8_matmul_ref(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                     sw: torch.Tensor) -> torch.Tensor:
    """Reference int8 GEMM + separable dequant: y = (qx·qw) * a_i * sw_k.

    The int32 accumulator is formed as a float64 product of the codes: exact,
    since |acc| ≤ 127²·K < 2^53, and its f32 conversion rounds as int32→f32 does."""
    if qw.ndim != 2:
        raise NotImplementedError("stacked-expert int8 GEMMs are not ported yet")
    acc = torch.matmul(qx.to(torch.float64), qw.to(torch.float64))
    return acc.to(torch.float32) * a * sw


def _int4_matmul_ref(qx: torch.Tensor, qw4: torch.Tensor, a: torch.Tensor,
                     sw: torch.Tensor, group: int) -> torch.Tensor:
    """Reference W4 GEMM: unpack the nibbles, per-group int32 partial sums (an
    exact float64 product), group dequant by ``sw`` (G, d_out), sum over the
    groups, then the row scale."""
    if qw4.ndim != 2:
        raise NotImplementedError("stacked-expert W4 GEMMs are not ported yet")
    qw = unpack_int4_weight(qw4)
    ngroups = qw.shape[-2] // group
    qx_g = qx.reshape(*qx.shape[:-1], ngroups, group).to(torch.float64)
    qw_g = qw.reshape(ngroups, group, qw.shape[-1]).to(torch.float64)
    acc = torch.einsum("...gk,gko->...go", qx_g, qw_g)
    return (acc.to(torch.float32) * sw).sum(dim=-2) * a


def apply(params: dict, x: torch.Tensor, cfg: QuantConfig = FP, *, name: str = "",
          observer=None, use_kernels: bool = False,
          int_exec: Optional[str] = None) -> torch.Tensor:
    """y = x @ W under the configured quantization mode (fp | int8).

    ``observer`` (calibration) records column absmax. Prepared trees run on the
    ``int_exec`` backend (``"ref"`` | ``"kernel"``); ``use_kernels=True`` is
    shorthand for ``"kernel"`` (it also routes prefill attention to the flash
    kernel — see models/layers.py)."""
    if observer is not None:
        observer.observe(name, x)
    if int_exec not in (None, "ref", "kernel"):
        raise ValueError(f"unknown int_exec {int_exec!r}; pick one of 'ref', 'kernel'")
    if "qw" in params or "qw4" in params:
        exec_mode = "kernel" if use_kernels else (int_exec or "ref")
        wq = params.get("qw", params.get("qw4"))
        if exec_mode == "kernel" and wq.ndim == 2 and x.ndim >= 2:
            return _int8_kernel(params, x, cfg)
        qx, a = quantize_act_int8(x, params["bcol"], cfg, alpha=params.get("qalpha"))
        if "qw" in params:
            return _int8_matmul_ref(qx, params["qw"], a, params["sw"]).to(x.dtype)
        return _int4_matmul_ref(qx, params["qw4"], a, params["sw"],
                                cfg.w_group).to(x.dtype)

    w = params["w"]
    if cfg.mode == "fp":
        return x @ w.to(x.dtype)
    if cfg.mode == "int8":
        # int8 on unprepared weights (calibration): dynamic-c preparation on the fly
        if "cmax" in params:
            cmax = params["cmax"]
        else:
            cmax = x.abs().amax(dim=tuple(range(x.ndim - 1)))
        prepared = prepare_int8({"w": w}, cfg, cmax=cmax)
        return apply(prepared, x, cfg, use_kernels=use_kernels, int_exec=int_exec)
    raise NotImplementedError(f"quant mode {cfg.mode!r} is not ported yet")
