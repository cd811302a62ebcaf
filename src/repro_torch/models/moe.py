"""Mixture-of-Experts layer (port of ``repro/models/moe.py``): deterministic top-k
routing with a per-expert capacity, sort-based dispatch into an ``(E, C, d)``
expert buffer, stacked-expert linears and a Switch-style load-balancing loss.

Two dispatches, as in the reference. The global one (``G == 1``) routes every
token row of the call with one capacity: serving always runs it, sharded or not
(the reference's serving steps trace ``token_groups=False``;
``sharding.collectives.token_group_count``), and so does calibration. The
grouped one (``G > 1``, ``QuantContext.token_groups``: a training step's data
axes' size, where it divides the call's tokens) splits the rows into G
contiguous groups, each routed, dispatched and combined with its own capacity;
the experts run on the G groups' buffers folded into one capacity axis, and the
aux loss is the mean over the groups. Under a data mesh a rank's rows are one
group of the global microbatch, so it dispatches them alone (G == 1) and the
loss averages the ranks' aux terms (``models.model.loss_fn``).

Expert parallelism (a rank's ``ShardContext`` with an ``expert_axis``): the
router and the dispatch stay replicated, every rank computes the same (E, C, d)
buffer, runs its E/ep experts (its shard of the stacked leaves, whole experts)
through the expert-batched K1/K2, and the experts' outputs are gathered in
expert order before the combine, so the step is bitwise the single-device one.
Under autograd the buffer passes the f op before a rank takes its experts (their
gradients sum across the ranks) and the gather hands each rank its experts'
gradient.
Expert-internal TP (``ShardContext.expert_tp``: E does not divide the model axis,
d_ff_expert does): every rank holds every expert's d_ff_expert / tp columns of
up and gate and the matching rows of down, the router and the dispatch stay
replicated (so the capacity and the drop set are the single device's), up and
gate run column-parallel on the whole buffer and down row-parallel, its int32
accumulators summed across the ranks before the dequant (``qlinear``).

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


def _rank_experts(node: dict, e0: int, n: int, n_experts: int) -> dict:
    """A stacked expert linear's leaves for experts [e0, e0 + n): the planner
    splits the weights over the expert-parallel axis, but under ``ep`` (experts
    over "model") it keeps the prepared scale leaves (``sw``, ``bcol``,
    ``qalpha``) whole on every rank, as the reference does; those are sliced here."""
    return {k: v[e0:e0 + n] if k != "cmax" and v.shape[:1] == (n_experts,) and n < n_experts
            else v for k, v in node.items()}


def _tp_expert_leaves(node: dict, name: str, r: int) -> dict:
    """A stacked expert linear's leaves on the rank at model coordinate ``r`` under
    expert-internal TP: the planner splits the weights' d_ff_expert and keeps the
    prepared scale leaves whole; up/gate's ``sw`` (E, d_ff_expert), or a W4 stack's
    (E, G, d_ff_expert), and down's ``bcol`` (E, d_ff_expert) are sliced here to the
    rank's columns (down's W4 group scales in ``qlinear._w4_gathered``)."""
    w = node.get("qw", node.get("qw4", node.get("w")))
    rows = w.shape[-2] * (2 if "qw4" in node else 1)         # packed int4: two a byte
    key, n = ("bcol", rows) if name == "down" else ("sw", w.shape[-1])
    out = dict(node)
    if key in node and node[key].shape[-1] != n:
        out[key] = node[key][..., r * n:(r + 1) * n].contiguous()
    return out


def _experts(params: dict, expert_in: torch.Tensor, cfg: ModelConfig,
             ctx: QuantContext) -> torch.Tensor:
    """The stacked experts on the (E, C, d) buffer: this rank's experts under
    expert parallelism (then every rank's, in order), its d_ff_expert slice under
    expert-internal TP, all of them otherwise."""
    sh = ctx.shard
    if sh is not None and sh.expert_axis is not None:
        up = params["up"]
        e_local = up.get("qw", up.get("qw4", up.get("w"))).shape[0]
        e0 = sh.coll.mesh.axis_index(sh.expert_axis) * e_local
        local = {name: _rank_experts(params[name], e0, e_local, cfg.n_experts)
                 for name in ("up", "gate", "down") if name in params}
        mine = sh.coll.copy_to(expert_in, sh.expert_axis)[e0:e0 + e_local]
        return sh.coll.gather_experts(_expert_ffn(local, mine, cfg, ctx), sh.expert_axis)
    if sh is not None and sh.expert_tp:
        local = {name: _tp_expert_leaves(params[name], name, sh.tp_index)
                 for name in ("up", "gate", "down") if name in params}
        return _expert_ffn(local, expert_in, cfg, ctx)
    return _expert_ffn(params, expert_in, cfg, ctx)


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: QuantContext) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, d), aux_loss scalar): the dispatch over all B·S token
    rows (padding rows and idle slots included: the capacity and the drop set
    depend on them), in one group or, with ``ctx.token_groups`` G dividing them,
    in G contiguous groups of rows; the experts' stacked linears, the gated
    combine and, with a shared expert, its MLP over every token."""
    from repro_torch.sharding.collectives import token_group_count

    B, S, d = x.shape
    N, E = B * S, cfg.n_experts
    xf = x.reshape(N, d)
    G = 1 if ctx.observer is not None else token_group_count(N, ctx.token_groups)
    if G == 1:
        gate_w, e_idx, pos_c, keep, aux = _route_group(xf, params["router"]["w"], cfg)
        expert_out = _experts(params, _dispatch_group(xf, e_idx, pos_c, cfg), cfg, ctx)
        y = _combine_group(expert_out, gate_w, e_idx, pos_c, keep, cfg, x.dtype)
    else:
        xg = xf.reshape(G, N // G, d)
        routes = [_route_group(xg[g], params["router"]["w"], cfg) for g in range(G)]
        aux = torch.stack([r[4] for r in routes]).mean()
        expert_in = torch.stack([_dispatch_group(xg[g], r[1], r[2], cfg)
                                 for g, r in enumerate(routes)])          # (G, E, C, d)
        C = expert_in.shape[2]
        # the experts see every group's slots: G folds into the capacity axis
        flat_out = _experts(params, expert_in.transpose(0, 1).reshape(E, G * C, d), cfg, ctx)
        expert_out = flat_out.reshape(E, G, C, d).transpose(0, 1)
        y = torch.cat([_combine_group(expert_out[g], gw, ei, pc, kp, cfg, x.dtype)
                       for g, (gw, ei, pc, kp, _) in enumerate(routes)])
    if cfg.n_shared_experts:
        y = y + mlp_apply(params["shared"], xf[None], cfg, ctx)[0]
    return y.reshape(B, S, d), aux
