"""Quantized linear layer (port of ``repro/core/qlinear.py``).

Params are plain dicts of tensors. A raw linear is ``{"w": (d_in, d_out)}`` (or a
stacked ``(L, d_in, d_out)``), optionally with a calibrated ``cmax`` (d_in,);
:func:`prepare_int8` turns it into the prepared ``{"qw", "sw", "bcol", "qalpha"}``
leaves of static-c CrossQuant.

Modes of a raw linear (``QuantConfig.mode``):

* ``fp``   — the fp product (the FP16 baseline of every paper table).
* ``fake`` — the paper's evaluation path: dynamic activation scales (per-token or
  CrossQuant eq. 5), per-channel / group weight scales, quantize → dequantize →
  fp product; SmoothQuant, AWQ and the "remove kernel" ablations ride on it.
* ``int8`` — static-c CrossQuant prepared on the fly from this batch's columns.

Execution of a prepared linear (``int_exec``):

* ``"ref"`` (default) — :func:`quantize_act_int8` then :func:`_int8_matmul_ref`, an
  exact integer product formed in float64 (|acc| < 2^53) outside any kernel.
* ``"dequant"``      — the same codes scaled back to f32 before an fp product
  (:func:`_int8_dequant_fp`, :func:`_int4_dequant_fp`): the dequant-fp serving
  baseline, plain torch.
* ``"kernel"``       — :func:`_int8_kernel`: ``act_quantize`` then the GEMM the
  leaf asks for in ``kernels/ops.py`` (hand-written CUDA on the card, plain torch
  on CPU): ``qgemm_w8a8``, ``qgemm_w8a8_sparse`` for a leaf with an N:M ``mask``,
  ``qgemm_w4a8`` for a packed-int4 ``qw4`` leaf (:func:`prepare_int4`).

Stacked-expert linears (an MoE layer's ``(E, d_in, d_out)`` weights against its
``(E, C, d_in)`` dispatch buffer) take every mode and backend. On the kernel
backend a prepared W8A8 expert stack runs :func:`_int8_experts_kernel`, the
expert-batched K1 and K2 (one launch each for all E experts); a W4 stack runs the
plain group product on every device, as the reference's kernel path does.
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
    act_quant: str = "crossquant"    # per_token | crossquant | smoothquant | none |
                                     # remove_kernel | remove_true_kernel
    w_quant: str = "per_channel"     # per_channel | group | crossquant_w | awq
    w_group: int = 128               # group size for w_quant="group" (g128)
    alpha_w: float = 0.55            # CrossQuant-on-weights exponent (App. B.1)
    static_c: bool = False           # use calibrated cmax when present (fake mode)
    w_prequantized: bool = False     # weights fake-quantized offline: skip in-graph
                                     # weight quantization
    remove_frac: float = 0.0         # act_quant="remove_kernel": fraction zeroed

    def tag(self) -> str:
        if self.mode == "fp":
            return "fp16"
        g = f"-g{self.w_group}" if self.w_quant == "group" else ""
        return f"W{self.w_bits}A{self.a_bits}{g}[{self.act_quant},a={self.alpha}]"


FP = QuantConfig(mode="fp")
W8A8_CROSSQUANT = QuantConfig(mode="fake", a_bits=8, w_bits=8)
W8A8_PER_TOKEN = QuantConfig(mode="fake", a_bits=8, w_bits=8, act_quant="per_token")
W8A8_SMOOTHQUANT = QuantConfig(mode="fake", a_bits=8, w_bits=8, act_quant="smoothquant")
W4A8_G128 = QuantConfig(mode="fake", a_bits=8, w_bits=4, w_quant="group")
W4A8_G128_PER_TOKEN = QuantConfig(mode="fake", a_bits=8, w_bits=4, w_quant="group",
                                  act_quant="per_token")
# AWQ weight-only baseline (paper Table 2) with per-token activations, and the
# paper's CrossQuant+AWQ combination
W4A8_G128_AWQ = QuantConfig(mode="fake", a_bits=8, w_bits=4, w_quant="awq",
                            act_quant="per_token")
W4A8_G128_CQ_AWQ = QuantConfig(mode="fake", a_bits=8, w_bits=4, w_quant="awq")
# App. B.1 rescue: CrossQuant applied to the weights themselves at W4A4
W4A4_CQW = QuantConfig(mode="fake", a_bits=4, w_bits=4, w_quant="crossquant_w")
W4A4 = QuantConfig(mode="fake", a_bits=4, w_bits=4)
W4A4_PER_TOKEN = QuantConfig(mode="fake", a_bits=4, w_bits=4, act_quant="per_token")
W8A8_INT8 = QuantConfig(mode="int8", a_bits=8, w_bits=8)


def remove_kernel_cfg(frac: float, w_bits: int = 8) -> QuantConfig:
    """'W8-Remove Kernel' of Fig. 6/7: quantize the weights, zero the smallest
    ``frac`` of activation entries, quantize nothing else."""
    return QuantConfig(mode="fake", w_bits=w_bits, act_quant="remove_kernel",
                       remove_frac=frac)


REMOVE_TRUE_KERNEL = QuantConfig(mode="fake", w_bits=8, act_quant="remove_true_kernel")


def init(gen: torch.Generator, d_in: int, d_out: int, *, n_stack: Optional[int] = None,
         device: torch.device) -> dict:
    shape = (d_in, d_out) if n_stack is None else (n_stack, d_in, d_out)
    return {"w": torch.randn(shape, generator=gen, device=device) * d_in ** -0.5}


# ======================================================================================
# Fake-quant application (the paper's evaluation path)
# ======================================================================================

def _fake_act(x: torch.Tensor, cfg: QuantConfig, cmax) -> torch.Tensor:
    if cfg.act_quant == "none":
        return x
    if cfg.act_quant == "per_token":
        return Q.fake_per_token(x, cfg.a_bits)
    if cfg.act_quant == "crossquant":
        col = cmax if (cfg.static_c and cmax is not None) else None
        return Q.fake_crossquant(x, cfg.a_bits, cfg.alpha, col_max=col)
    raise ValueError(cfg.act_quant)


def _fake_weight(w: torch.Tensor, cfg: QuantConfig, cmax=None) -> torch.Tensor:
    if cfg.w_quant == "per_channel":
        # paper eq. (2): reduce over the output axis -> per-input-channel scale
        return Q.fake_per_channel(w, cfg.w_bits, axis=-1)
    if cfg.w_quant == "group":
        return Q.fake_group(w, cfg.w_bits, cfg.w_group)
    if cfg.w_quant == "crossquant_w":
        # App. B.1: CrossQuant on the weight matrix itself (rows = input channels)
        return Q.fake_crossquant(w, cfg.w_bits, cfg.alpha_w)
    if cfg.w_quant == "awq":
        from repro_torch.core import awq
        if cmax is None:
            cmax = torch.ones(w.shape[-2], dtype=torch.float32, device=w.device)
        return awq.awq_weight(w, cmax, bits=cfg.w_bits, group=cfg.w_group)
    raise ValueError(cfg.w_quant)


def _col_absmax(x: torch.Tensor) -> torch.Tensor:
    """This batch's column absmax over every token row (dynamic column stats)."""
    return x.abs().amax(dim=tuple(range(x.ndim - 1)))


def _apply_fake(params: dict, x: torch.Tensor, cfg: QuantConfig):
    """(x, w) after the fake-quant mode's activation and weight treatment."""
    w = params["w"]
    cm = params.get("cmax")
    if cfg.act_quant == "smoothquant":
        # SmoothQuant: migrate difficulty to the weights through s_j, then
        # per-token A-quant and per-channel W-quant; column stats from calibration
        # when present, else this batch's
        from repro_torch.core import smoothquant as sq
        if cm is None:
            cm = _col_absmax(x)
        s = sq.smoothing_scale(cm.to(torch.float32),
                               w.abs().amax(dim=-1).to(torch.float32), alpha=0.5)
        x = Q.fake_per_token(x / s.to(x.dtype), cfg.a_bits)
        w = Q.fake_per_channel(w * s[..., :, None].to(w.dtype), cfg.w_bits, axis=-1)
        return x, w
    if cfg.act_quant in ("remove_kernel", "remove_true_kernel"):
        from repro_torch.core import kernel_analysis as KA
        if cfg.act_quant == "remove_kernel":
            # Fig. 6/7: zero ONLY the smallest-|x| fraction; quantize nothing else
            x = KA.remove_kernel_fraction(x, cfg.remove_frac)
        else:
            # Fig. 1/9: zero exactly K(Q) under the per-token scale, leave every
            # other element unquantized
            x = KA.remove_kernel(x, Q.per_token_scale(x, cfg.a_bits))
        return x, (w if cfg.w_prequantized else _fake_weight(w, cfg))
    x_cm = cm
    if cfg.w_quant == "awq" and x_cm is None:
        x_cm = _col_absmax(x)
    x = _fake_act(x, cfg, cm)
    return x, (w if cfg.w_prequantized else _fake_weight(w, cfg, cmax=x_cm))


# ======================================================================================
# int8 path: static-c CrossQuant
# ======================================================================================

def prepare_int8(params: dict, cfg: QuantConfig,
                 cmax: Optional[torch.Tensor] = None, *, jitted: bool = False) -> dict:
    """Offline weight preparation: fold b_j = c_j^(1-α) into W, per-output-channel
    int8 quantization. Returns a prepared parameter dict (raw ``w`` dropped).
    Without column statistics α degrades to 1 (exact per-token int8).

    ``jitted=True`` divides by qmax as the reference does inside a jitted step
    (XLA multiplies by the f32 reciprocal): the form of the on-the-fly
    preparation in :func:`apply`, which the reference runs inside its serving
    steps; offline ``quantize_tree`` runs eagerly there, a true division."""
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
    wmax = torch.clamp_min(wb.abs().amax(dim=-2, keepdim=True), Q.EPS)
    sw = wmax * (1.0 / Q.qmax(cfg.w_bits)) if jitted else wmax / Q.qmax(cfg.w_bits)
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


def _int8_experts_kernel(params: dict, x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Kernel pipeline for a prepared W8A8 expert stack: x (E, C, d_in) through
    the expert-batched ``act_quantize`` (each expert's ``bcol`` and ``qalpha``)
    into the expert-batched W8A8 GEMM, one launch each. The reference quantizes
    experts with its jnp quantizer and multiplies in an int32 einsum, outside any
    Pallas kernel; both are exact integer arithmetic with the same epilogue."""
    from repro_torch.kernels import ops

    alpha = params.get("qalpha")
    qx, a = ops.act_quantize_experts(x.contiguous(), params["bcol"],
                                     cfg.alpha if alpha is None else alpha, bits=cfg.a_bits)
    return ops.qgemm_w8a8_experts(qx, params["qw"], a, params["sw"]).to(x.dtype)


def _stacked(qx: torch.Tensor, w: torch.Tensor) -> bool:
    """An expert stack: (E, C, d_in) codes against (E, d_in, d_out) weights."""
    return w.ndim == 3 and qx.ndim == 3


def _int8_dequant_fp(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                     sw: torch.Tensor) -> torch.Tensor:
    """Dequantize-then-fp-product baseline: the codes are scaled back to f32 before
    the contraction (xdq ≈ x/b rows, wdq ≈ w·b columns; the b factors cancel).
    It carries the integer path's quantization error at fp throughput. An expert
    stack scales each expert's weight columns by its ``sw`` (E, d_out) first."""
    xdq = qx.to(torch.float32) * a
    if _stacked(qx, qw):
        return xdq @ (qw.to(torch.float32) * sw[:, None, :])
    return xdq @ qw.to(torch.float32) * sw


def _int4_dequant_fp(qx: torch.Tensor, qw4: torch.Tensor, a: torch.Tensor,
                     sw: torch.Tensor, group: int) -> torch.Tensor:
    """W4 variant of :func:`_int8_dequant_fp`: unpack the nibbles and apply the
    group scales to the weight, then the fp product (batched over an expert
    stack's leading axis)."""
    return (qx.to(torch.float32) * a) @ dequant_int4_weight(qw4, sw, group)


def _int8_matmul_ref(qx: torch.Tensor, qw: torch.Tensor, a: torch.Tensor,
                     sw: torch.Tensor) -> torch.Tensor:
    """Reference int8 GEMM + separable dequant: y = (qx·qw) * a_i * sw_k; an
    expert stack (qx (E, C, d_in), qw (E, d_in, d_out), sw (E, d_out)) multiplies
    per expert.

    The int32 accumulator is formed as a float64 product of the codes: exact,
    since |acc| ≤ 127²·K < 2^53, and its f32 conversion rounds as int32→f32 does."""
    acc = torch.matmul(qx.to(torch.float64), qw.to(torch.float64))
    return acc.to(torch.float32) * a * sw[..., None, :]


def _int4_matmul_ref(qx: torch.Tensor, qw4: torch.Tensor, a: torch.Tensor,
                     sw: torch.Tensor, group: int) -> torch.Tensor:
    """Reference W4 GEMM: unpack the nibbles, per-group int32 partial sums (an
    exact float64 product), group dequant by ``sw`` (G, d_out), sum over the
    groups, then the row scale. An expert stack (qx (E, C, d_in), qw4 (E, d_in/2,
    d_out), sw (E, G, d_out)) multiplies per expert."""
    qw = unpack_int4_weight(qw4)
    ngroups = qw.shape[-2] // group
    if _stacked(qx, qw):
        E, C, _ = qx.shape
        qx_g = qx.reshape(E, C, ngroups, group).to(torch.float64)
        qw_g = qw.reshape(E, ngroups, group, qw.shape[-1]).to(torch.float64)
        acc = torch.einsum("ecgk,egko->ecgo", qx_g, qw_g)
        return (acc.to(torch.float32) * sw[:, None]).sum(dim=-2) * a
    qx_g = qx.reshape(*qx.shape[:-1], ngroups, group).to(torch.float64)
    qw_g = qw.reshape(ngroups, group, qw.shape[-1]).to(torch.float64)
    acc = torch.einsum("...gk,gko->...go", qx_g, qw_g)
    return (acc.to(torch.float32) * sw).sum(dim=-2) * a


def apply(params: dict, x: torch.Tensor, cfg: QuantConfig = FP, *, name: str = "",
          observer=None, use_kernels: bool = False,
          int_exec: Optional[str] = None) -> torch.Tensor:
    """y = x @ W under the configured quantization mode (fp | fake | int8).

    ``observer`` (calibration) records column absmax. Prepared trees run on the
    ``int_exec`` backend (``"ref"`` | ``"dequant"`` | ``"kernel"``);
    ``use_kernels=True`` is shorthand for ``"kernel"`` (it also routes prefill
    attention to the flash kernel — see models/layers.py)."""
    if observer is not None:
        observer.observe(name, x)
    if int_exec not in (None, "ref", "dequant", "kernel"):
        raise ValueError(f"unknown int_exec {int_exec!r}; "
                         "pick one of 'ref', 'dequant', 'kernel'")
    if "qw" in params or "qw4" in params:
        exec_mode = "kernel" if use_kernels else (int_exec or "ref")
        wq = params.get("qw", params.get("qw4"))
        if exec_mode == "kernel" and wq.ndim == 2 and x.ndim >= 2:
            return _int8_kernel(params, x, cfg)
        if exec_mode == "kernel" and "qw" in params and _stacked(x, wq):
            return _int8_experts_kernel(params, x, cfg)
        qx, a = quantize_act_int8(x, params["bcol"], cfg, alpha=params.get("qalpha"))
        if "qw" in params:
            if exec_mode == "dequant":
                return _int8_dequant_fp(qx, params["qw"], a, params["sw"]).to(x.dtype)
            return _int8_matmul_ref(qx, params["qw"], a, params["sw"]).to(x.dtype)
        if exec_mode == "dequant":
            return _int4_dequant_fp(qx, params["qw4"], a, params["sw"],
                                    cfg.w_group).to(x.dtype)
        return _int4_matmul_ref(qx, params["qw4"], a, params["sw"],
                                cfg.w_group).to(x.dtype)

    if cfg.mode == "int8":
        # int8 on unprepared weights (an untied lm_head, calibration): dynamic-c
        # preparation on the fly, in the form the reference's jitted steps run
        cmax = params["cmax"] if "cmax" in params else _col_absmax(x)
        prepared = prepare_int8({"w": params["w"]}, cfg, cmax=cmax, jitted=True)
        return apply(prepared, x, cfg, use_kernels=use_kernels, int_exec=int_exec)
    if cfg.mode == "fp":
        w = params["w"]
    elif cfg.mode == "fake":
        x, w = _apply_fake(params, x, cfg)
    else:
        raise ValueError(cfg.mode)
    return x @ w.to(x.dtype)
