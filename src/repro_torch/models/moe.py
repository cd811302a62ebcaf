"""Mixture-of-Experts layer (port of ``repro/models/moe.py``): deterministic top-k
routing with a per-expert capacity, sort-based dispatch into an ``(E, C, d)``
expert buffer, stacked-expert linears and a Switch-style load-balancing loss.

Only the reference's ``G == 1`` global dispatch is ported: serving always runs it
(the reference's serving steps trace ``token_groups=False``), and so do
calibration and eager runs. The grouped ``G > 1`` dispatch, one capacity per
data-parallel token group, belongs to sharded serving and waits for it.

Activation quantization inside the experts: the linears see the stacked (E, C, d)
buffer, zero capacity rows included, so CrossQuant's row and column statistics
are taken per expert over the tokens routed to it, as in the reference; the
calibrated column table of ``blocks/{i}/moe/up`` is shared by the experts.

Everything here runs on the device without a host sync: the slot positions come
from a stable sort and ``searchsorted`` (no ``bincount``, whose CUDA version
reads its maximum back), overflow scatters into a sentinel expert that is sliced
off, and the combine sums each token's K contributions in k order, with no
atomics, so a step is deterministic on the card.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import QuantContext, init_mlp, mlp_apply


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, device, n_stack=None) -> dict:
    """Router (d, E) f32, stacked experts (E, d, d_ff_expert) / (E, d_ff_expert, d)
    and, with ``n_shared_experts``, a shared MLP of width d_ff · n_shared_experts;
    every leaf with a leading ``(n_stack,)`` layer axis when given."""
    d, dff, E = cfg.d_model, cfg.d_ff_expert or cfg.d_ff, cfg.n_experts
    lead = () if n_stack is None else (n_stack,)

    def w(shape, fan_in):
        return torch.randn(lead + shape, generator=gen, device=device) * fan_in ** -0.5

    p = {"router": {"w": w((d, E), d)},
         "up": {"w": w((E, d, dff), d)},
         "down": {"w": w((E, dff, d), dff)}}
    if cfg.act.endswith("_glu"):
        p["gate"] = {"w": w((E, d, dff), d)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, device=device, n_stack=n_stack,
                               d_ff=cfg.d_ff * cfg.n_shared_experts)
    return p


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``n_tokens`` routed tokens: ceil(N·k·factor/E), rounded
    up to a multiple of 8, at least 8."""
    c = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, -(-c // 8) * 8)


def _expert_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: QuantContext) -> torch.Tensor:
    """x (E, C, d) stacked per expert. The linears' names are their parameter
    paths, so calibration tables attach (``calibration.stack_tables``)."""
    up = ctx.linear(p["up"], x, "up")
    if cfg.act == "silu_glu":
        h = F.silu(ctx.linear(p["gate"], x, "gate")) * up
    elif cfg.act == "gelu_glu":
        h = F.gelu(ctx.linear(p["gate"], x, "gate"), approximate="tanh") * up
    elif cfg.act == "relu2":
        h = torch.square(F.relu(up))
    else:
        h = F.gelu(up, approximate="tanh")
    return ctx.linear(p["down"], h, "down")


def _route_group(xf: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig):
    """Routing and sort-based slot assignment for one token group.

    xf (Ng, d). Returns (gate_w (Ng, K), e_idx (Ng·K,), pos (Ng·K,), keep, aux):
    the top K experts of each token, lower expert index first on equal
    probabilities (``jax.lax.top_k``'s order, here a stable descending sort),
    renormalised when K > 1; each (token, k) pair's position within its expert in
    token order; pairs past the capacity get expert id E and position 0."""
    Ng = xf.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(Ng, cfg)
    logits = xf.to(torch.float32) @ router_w                          # router stays f32
    probs = torch.softmax(logits, dim=-1)                             # (Ng, E)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_idx = srt.values[:, :K], srt.indices[:, :K]
    if K > 1:
        gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)

    flat_e = gate_idx.reshape(-1)                                     # (Ng·K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(E, device=xf.device, dtype=flat_e.dtype)
    starts = torch.searchsorted(sorted_e, experts)                    # first slot of each
    counts = torch.searchsorted(sorted_e, experts, right=True) - starts

    # Switch-style load-balancing aux loss
    me = probs.mean(dim=0)
    ce = counts.to(torch.float32) / (Ng * K)
    aux = E * torch.sum(me * ce)

    pos_sorted = torch.arange(Ng * K, device=xf.device) - starts[sorted_e]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < C
    e_idx = torch.where(keep, flat_e, E)
    pos_c = torch.where(keep, pos, 0)
    return gate_w, e_idx, pos_c, keep, aux


def _dispatch_group(xf: torch.Tensor, e_idx: torch.Tensor, pos_c: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Scatter one group's (token, k) rows into its (E, C, d) expert buffer. The
    overflow rows land in a sentinel expert E, sliced off (the reference drops
    them with an out-of-range scatter, which would fault on a card)."""
    Ng, d = xf.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(Ng, cfg)
    expanded = xf.repeat_interleave(K, dim=0)                         # (Ng·K, d)
    buf = torch.zeros((E + 1, C, d), dtype=xf.dtype, device=xf.device)
    buf[e_idx, pos_c] = expanded
    return buf[:E]


def _combine_group(expert_out: torch.Tensor, gate_w: torch.Tensor, e_idx: torch.Tensor,
                   pos_c: torch.Tensor, keep: torch.Tensor, cfg: ModelConfig,
                   dtype: torch.dtype) -> torch.Tensor:
    """Gather one group's expert outputs back to token order and mix them by gate:
    each token's K contributions summed in k order from zero, as the reference's
    scatter-add does, with no atomics."""
    E, C, d = expert_out.shape
    K = cfg.top_k
    out_rows = expert_out[torch.clamp_max(e_idx, E - 1), pos_c]       # (Ng·K, d)
    gathered = torch.where(keep[:, None], out_rows, torch.zeros((), dtype=out_rows.dtype,
                                                                 device=out_rows.device))
    contrib = (gathered * gate_w.reshape(-1)[:, None].to(dtype)).reshape(-1, K, d)
    y = torch.zeros(contrib.shape[0], d, dtype=dtype, device=contrib.device)
    for k in range(K):
        y = y + contrib[:, k]
    return y


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: QuantContext) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, d), aux_loss scalar): one global dispatch over all
    B·S token rows (padding rows and idle slots included: the capacity and the
    drop set depend on them), the experts' stacked linears, the gated combine and,
    with a shared expert, its MLP over every token."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    gate_w, e_idx, pos_c, keep, aux = _route_group(xf, params["router"]["w"], cfg)
    expert_in = _dispatch_group(xf, e_idx, pos_c, cfg)
    expert_out = _expert_ffn(params, expert_in, cfg, ctx)
    y = _combine_group(expert_out, gate_w, e_idx, pos_c, keep, cfg, x.dtype)
    if cfg.n_shared_experts:
        y = y + mlp_apply(params["shared"], xf[None], cfg, ctx)[0]
    return y.reshape(B, S, d), aux
