"""Mamba2 (state-space duality, SSD) block (port of ``repro/models/ssm.py``).

The chunked SSD scan is a Python loop over sequence chunks that carries the
inter-chunk state, so peak memory stays O(chunk²) per chunk. Per chunk (length l,
heads h, head dim p, state n; decay dA = dt·A ≤ 0):

  L[i,j]   = exp(Σ_{k=j+1..i} dA_k)              intra-chunk decay (lower-tri)
  y_diag   = (C·Bᵀ ⊙ L) · (dt·x)                 intra-chunk "attention"
  y_off    = C · S_prev, decayed by exp(cum dA)  the carried state's part
  S_new    = S_prev·exp(Σ dA) + Σ_s B_s ⊗ (dt·x)_s · exp(Σ_{k>s} dA_k)

Decode is the O(1) recurrence  S ← S·exp(dt·A) + dt·x⊗B,  y = C·S + D·x.

The in and out projections are quantized linears (``ctx.linear``: K1 and K2 on
the fused-int8 path); the conv, the scan and the gated norm stay plain PyTorch,
as the reference keeps them in plain ``jnp``. The recurrent state and the conv
window are f32 whatever the model's dtype. Caches are updated in place.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import qlinear as ql
from repro_torch.models.layers import QuantContext, _scatter_rows


def _conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def init_mamba(gen: torch.Generator, cfg: ModelConfig, *, device,
               n_stack: Optional[int] = None) -> dict:
    """Random f32 Mamba2 params, every leaf with a leading ``(n_stack,)`` layer axis
    when given: in_proj (d, 2·d_inner + 2·G·N + H) producing z, x, B, C and dt;
    the depthwise conv (K, C) and its bias; A_log = log(linspace(1, 16, H)); D = 1;
    dt_bias the inverse softplus of a log-uniform dt in [1e-3, 1e-1]; the gated
    norm's scale; out_proj (d_inner, d)."""
    d, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    G, N, K = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    lead = () if n_stack is None else (n_stack,)
    C = _conv_channels(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    lo, hi = math.log(0.001), math.log(0.1)
    dt = torch.exp(torch.rand(lead + (H,), generator=gen, **f32) * (hi - lo) + lo)
    return {
        "in_proj": ql.init(gen, d, 2 * di + 2 * G * N + H, n_stack=n_stack, device=device),
        "conv_w": torch.randn(lead + (K, C), generator=gen, **f32) * 0.1,
        "conv_b": torch.zeros(lead + (C,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)).expand(lead + (H,)).clone(),
        "D": torch.ones(lead + (H,), **f32),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),          # inverse softplus
        "norm_scale": torch.ones(lead + (di,), **f32),
        "out_proj": ql.init(gen, di, d, n_stack=n_stack, device=device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (logaddexp(x, 0)); ``F.softplus`` switches to x above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d by shift-sum, tap k = 0..K-1 then the bias, as the
    reference sums. x (B, S, C); w (K, C)."""
    K, S = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for k in range(K):
        xs = F.pad(x, (0, 0, K - 1 - k, 0))[:, :S]
        out = out + xs * w[k]
    return out + b


def _conv_step(x_t: torch.Tensor, buf: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """One-token causal conv over the rolling window. x_t (B, C); buf (B, K-1, C)
    the previous K-1 pre-conv inputs. Returns (y (B, C), the new window)."""
    window = torch.cat([buf, x_t[:, None]], dim=1)                     # (B, K, C)
    y = window[:, 0] * w[0]
    for k in range(1, w.shape[0]):
        y = y + window[:, k] * w[k]
    return y + b, window[:, 1:]


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    """in_proj's output → (z, xBC, dt), views over its last axis."""
    di, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    c = di + 2 * G * N
    return proj[..., :di], proj[..., di:di + c], proj[..., di + c:]


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA (B, l, H) → (B, H, l, l), T[i, j] = Σ_{k=j+1..i} dA_k (−inf above the
    diagonal)."""
    cum = torch.cumsum(dA, dim=1).transpose(1, 2)                      # (B, H, l)
    T = cum[:, :, :, None] - cum[:, :, None, :]
    l = dA.shape[1]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=dA.device))
    return torch.where(mask, T, torch.full_like(T, float("-inf")))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x (B, S, H, P); dt (B, S, H); A (H,); Bm/Cm (B, S, N) (one
    group). Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32).

    S pads to a chunk multiple with dt = 0 there, so padding decays by 1 and
    updates by 0 and the final state is the exact-length one. The three-operand
    contractions are formed pairwise without a (B, l, N, H, P) intermediate:
    C·Bᵀ ⊙ L first, then one batched product over the chunk; the state update
    folds its decay into dt·x before contracting over the chunk."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    f32 = torch.float32
    xf, dtf, Bf, Cf = (t.to(f32) for t in (x, dt, Bm, Cm))
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    state = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device) if init_state is None
             else init_state.to(f32))
    ys = []
    for c0 in range(0, S + pad, chunk):
        xb, dtb = xf[:, c0:c0 + chunk], dtf[:, c0:c0 + chunk]
        Bb, Cb = Bf[:, c0:c0 + chunk], Cf[:, c0:c0 + chunk]
        dA = dtb * A                                                  # (B, l, H), ≤ 0
        cum = torch.cumsum(dA, dim=1)                                 # (B, l, H)
        xdt = (xb * dtb[..., None]).transpose(1, 2)                   # (B, H, l, P)
        L = torch.exp(_segsum(dA))                                    # (B, H, l, l)
        scores = torch.matmul(Cb, Bb.transpose(1, 2))                 # (B, l, l)
        y_diag = torch.matmul(scores[:, None] * L, xdt)               # (B, H, l, P)
        decay_out = torch.exp(cum).transpose(1, 2)[..., None]         # (B, H, l, 1)
        y_off = torch.matmul(Cb[:, None], state.transpose(-1, -2)) * decay_out
        chunk_decay = torch.exp(cum[:, -1])                           # (B, H)
        decay_states = torch.exp(cum[:, -1:] - cum).transpose(1, 2)   # (B, H, l)
        upd = torch.matmul((xdt * decay_states[..., None]).transpose(-1, -2),
                           Bb[:, None])                               # (B, H, P, N)
        state = state * chunk_decay[:, :, None, None] + upd
        ys.append((y_diag + y_off).transpose(1, 2))                   # (B, l, H, P)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(x.dtype), state


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(1) recurrence. state (B, H, P, N); x (B, H, P); dt (B, H); Bm/Cm (B, N).
    Returns (new state, y (B, H, P))."""
    dA = torch.exp(dt * A)                                            # (B, H)
    upd = (x * dt[..., None])[..., None] * Bm[:, None, None, :]
    state = state * dA[..., None, None] + upd
    y = torch.matmul(state, Cm[:, None, :, None])[..., 0]
    return state, y


def mamba_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, ctx: QuantContext, *,
                cache: Optional[dict] = None, decode: bool = False,
                cur_len: Optional[torch.Tensor] = None,
                state_table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full Mamba2 block, x (B, S, d). The dense ``cache`` {"state" (B, H, P, N),
    "conv" (B, K-1, C)} holds each slot's state; the paged one {"state_pages" (nP,
    H, P, N), "conv_pages" (nP, K-1, C)} is addressed through ``state_table`` (B,)
    int: the sentinel id nP gathers a clamped page and writes nowhere, so a retired
    slot neither reads nor writes state. Caches update in place; returns (out,
    cache).

    ``cur_len`` (B,) marks each row's valid prompt length on a right-padded
    prefill: dt is 0 at padded positions, which then neither decay nor update
    the state, and the conv window keeps the last K-1 *valid* pre-conv inputs,
    so the final state is the exact-length one. A paged prefill is always a
    fresh admission and starts from a zero state (the gathered page may hold a
    retired sequence's checkpoint); a dense one starts from the cache's."""
    Bsz, S, _ = x.shape
    H, P, N, di = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    A = -torch.exp(params["A_log"])
    f32 = torch.float32

    paged = cache is not None and "state_pages" in cache
    pools = None
    if paged:
        if state_table is None:
            raise ValueError("paged SSM cache needs a state_table")
        pools = cache
        nP = pools["state_pages"].shape[0]
        tbl = state_table.reshape(-1).to(torch.int64)
        safe = torch.clamp(tbl, 0, nP - 1)
        cache = {"state": pools["state_pages"][safe], "conv": pools["conv_pages"][safe]}

    proj = ctx.linear(params["in_proj"], x, "in_proj")
    z, xbc, dt_raw = _split_proj(proj, cfg)
    dt = _softplus(dt_raw.to(f32) + params["dt_bias"])

    if decode:
        if S != 1 or cache is None:
            raise ValueError("SSM decode takes one token per slot against a cache")
        xbc_t, conv_buf = _conv_step(xbc[:, 0].to(f32), cache["conv"], params["conv_w"],
                                     params["conv_b"])
        xbc_t = F.silu(xbc_t)
        xi, Bm, Cm = xbc_t[:, :di], xbc_t[:, di:di + N], xbc_t[:, di + N:]
        xh = xi.reshape(Bsz, H, P)
        state, y = ssd_decode_step(cache["state"], xh, dt[:, 0], A, Bm, Cm)
        y = (y + params["D"][:, None] * xh).reshape(Bsz, 1, di)
        new = {"state": state, "conv": conv_buf}
    else:
        cur = None
        if cur_len is not None:
            cur = cur_len.reshape(-1).to(torch.int64).expand(Bsz)
            valid = torch.arange(S, device=x.device)[None, :, None] < cur[:, None, None]
            dt = torch.where(valid, dt, torch.zeros((), dtype=f32, device=x.device))
        xbc_raw = xbc.to(f32)                     # the cache keeps pre-conv inputs
        xbc_c = F.silu(_causal_conv(xbc_raw, params["conv_w"], params["conv_b"]))
        xi, Bm, Cm = xbc_c[..., :di], xbc_c[..., di:di + N], xbc_c[..., di + N:]
        xh = xi.reshape(Bsz, S, H, P)
        init_state = None if paged or cache is None else cache["state"]
        y, final_state = ssd_scan(xh, dt, A, Bm, Cm, min(cfg.ssm_chunk, S),
                                  init_state=init_state)
        y = (y + params["D"][None, None, :, None] * xh).reshape(Bsz, S, di)
        new = None
        if cache is not None:
            K = cfg.ssm_conv
            if cur is None:
                conv_buf = (xbc_raw[:, S - (K - 1):] if S >= K - 1
                            else F.pad(xbc_raw, (0, 0, K - 1 - S, 0)))
            else:
                # the last K-1 valid pre-conv inputs per row, zeros before position 0
                idx = cur[:, None] - (K - 1) + torch.arange(K - 1, device=x.device)[None, :]
                gathered = torch.take_along_dim(
                    xbc_raw, torch.clamp(idx, 0, S - 1)[:, :, None], dim=1)
                conv_buf = torch.where((idx >= 0)[:, :, None], gathered,
                                       torch.zeros((), dtype=f32, device=x.device))
            new = {"state": final_state, "conv": conv_buf}

    if new is not None:
        if paged:
            # sentinel rows (id nP) write nowhere, as the reference's scatter drops them
            src, dst = _scatter_rows(tbl, nP)
            pools["state_pages"][dst] = new["state"][src]
            pools["conv_pages"][dst] = new["conv"][src]
        else:
            cache["state"].copy_(new["state"])
            cache["conv"].copy_(new["conv"])

    # gated RMSNorm (its eps is 1e-6 whatever cfg.norm_eps), then the out projection
    g = y * F.silu(z.to(y.dtype))
    g = g * torch.rsqrt((g * g).mean(dim=-1, keepdim=True) + 1e-6)
    g = (g * params["norm_scale"]).to(x.dtype)
    out = ctx.linear(params["out_proj"], g, "out_proj")
    return out, (pools if paged else cache)
