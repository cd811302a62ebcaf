"""The collectives of sharded serving, in one place (the port's counterpart of
``repro/sharding/hints.py``).

Under GSPMD the reference pins activation layouts with sharding constraints and
lets the partitioner insert the communication. Here every rank runs the model on
its own shard (Megatron-style) and the few collectives it needs are explicit
calls on :class:`Collectives`, which reaches the model through the
:class:`ShardContext` its ``QuantContext`` carries (no context variables):

* ``sum_i32``: a row-parallel linear's int32 accumulators, summed before the f32
  dequant (the reference's ``constrain_gemm_acc`` ordering), so the product is
  bitwise the single-device one;
* ``max_f32``: the row maxima a row-parallel linear's K1 takes in its given-max
  mode (and the fake path's per-channel weight maxima of a column-parallel
  linear): a MAX is exact;
* ``sum_f32``: the partial products of the fp, fake and dequant-fp row-parallel
  linears (not bitwise, as the reference's are not), and the vocab-parallel
  embedding's rows (one rank holds each token's row, the others add zeros:
  exact);
* ``gather_vocab``: a vocab-sharded head's logits (``constrain_vocab``);
* ``gather_experts``: the expert-parallel MoE's outputs, each rank's experts
  concatenated in expert order;
* ``gather_groups``: a row-parallel W4 linear's per-group products f32(acc)·sw
  (K8's group-acc partials scaled by the rank's own group scales, elementwise),
  concatenated along the groups in rank order before the group sum;
* ``gather_cols``: a Mamba2 block's column-parallel ``in_proj`` output and its
  per-head scan output, concatenated along the last axis in rank order (the conv
  runs on every channel, the gated norm on all of d_inner);
* ``gather_slots``: data-parallel serving's final hidden rows, each data rank's
  slots concatenated in slot order before the head (every rank then computes and
  samples the whole batch's logits; the hidden rows are d_model wide, the logits
  vocab wide);
* ``gather_pages``: data-parallel paged serving's K/V rows of one model call,
  every paged layer's packed into one buffer, so each rank writes the others'
  rows into its whole page pool (:func:`exchange_pages`);
* ``broadcast``: rank 0's sampled tokens where the sampler draws at random.

Each call on an axis of more than one rank is counted in ``COUNTS`` (as
``kernels/ops.py`` counts launches); an axis of one rank is the identity and
counts nothing. The process group's backend is the caller's: gloo on the CPU
and for several ranks on one card (it takes CUDA tensors for every collective
here, staging them through host memory itself), NCCL with a card per rank.

Training (``training/trainer.py`` with a mesh) needs collectives autograd can
pass through. These are Megatron's pair, ``torch.autograd.Function``s over the
same process groups, each counted under a name of its own:

* ``copy_to`` (the *f* op): the identity forward, the SUM of the gradient across
  the axis backward (counted as ``f_sum`` when the backward runs). It stands
  wherever a rank feeds a replicated tensor into rank-local work: a
  column-parallel linear's input, the tied head's input under a vocab split, the
  expert-parallel dispatch buffer before a rank takes its experts, and the kv
  projections a ``tp_kv_rep`` rank slices;
* ``sum_f32`` on a tensor that requires grad (the *g* op, ``g_sum``): the SUM
  forward (a row-parallel linear's partial products, the vocab-parallel
  embedding's rows), the identity backward; ``sum_rows`` is the same op over the
  batch axes (``loss_sum``: the loss's numerator, count and aux terms);
* ``gather_vocab`` / ``gather_experts`` on a tensor that requires grad
  (``g_gather``): the gather forward, this rank's own slice of the gradient
  backward.

Outside autograd (serving runs under ``torch.no_grad()``) ``copy_to`` is the
identity and the rest are the calls above, with their counts. The data axes'
traffic of FSDP is counted as ``fsdp_gather`` (a leaf's shard gathered before
use), ``grad_sum`` (gradients summed over the data axes) and ``norm_sum`` (the
clip norm's partial sums), each one packed call for many leaves
(``training/layout.py``).

``token_group_count`` is the reference's rule for the grouped MoE dispatch;
serving forces one group (``token_groups=False``), as the reference's serving
steps do; training passes the data axes' size.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

COUNTS: Dict[str, int] = {"sum_i32": 0, "max_f32": 0, "sum_f32": 0, "gather_vocab": 0,
                          "gather_experts": 0, "gather_groups": 0, "gather_cols": 0,
                          "gather_slots": 0, "gather_pages": 0, "broadcast": 0,
                          # training: autograd's collectives and FSDP's packed calls
                          "f_sum": 0, "g_sum": 0, "g_gather": 0, "loss_sum": 0,
                          "fsdp_gather": 0, "grad_sum": 0, "norm_sum": 0}
_lock = threading.Lock()


def reset_counts() -> None:
    with _lock:
        for k in COUNTS:
            COUNTS[k] = 0


def _count(name: str) -> None:
    with _lock:
        COUNTS[name] += 1


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _CopyTo(torch.autograd.Function):
    """Megatron's f: the identity forward, the SUM of the gradient backward."""

    @staticmethod
    def forward(ctx, x, coll, axes):
        ctx.coll, ctx.axes = coll, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.axes,
                                   dist.ReduceOp.SUM, "f_sum"), None, None


class _SumOver(torch.autograd.Function):
    """Megatron's g: the SUM forward (into a fresh tensor), the identity backward."""

    @staticmethod
    def forward(ctx, x, coll, axes, name):
        return coll.all_reduce(x.clone(memory_format=torch.contiguous_format), axes,
                               dist.ReduceOp.SUM, name)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _GatherOwn(torch.autograd.Function):
    """The gather along ``dim`` forward, this rank's own slice of the gradient
    backward."""

    @staticmethod
    def forward(ctx, x, coll, axis, dim):
        ctx.dim, ctx.n, ctx.index = dim, x.shape[dim], coll.mesh.axis_index(axis)
        return coll._gather(x, axis, dim, "g_gather")

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None


class Collectives:
    """Collectives over a mesh's axes (``launch.mesh.Mesh``)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def size(self, axis: str) -> int:
        return self.mesh.axis_size(axis)

    def size_of(self, axes: Tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= self.size(a)
        return n

    def all_reduce(self, t: torch.Tensor, axes, op, name: str) -> torch.Tensor:
        """``t`` reduced in place over ``axes`` (an axis name or a tuple of them)
        and returned; the identity, uncounted, where they hold one rank."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if self.size_of(axes) == 1:
            return t
        t = t.contiguous()
        dist.all_reduce(t, op=op, group=self.mesh.group_of(axes))
        _count(name)
        return t

    def sum_i32(self, acc: torch.Tensor, axis: str = "model") -> torch.Tensor:
        if acc.dtype != torch.int32:
            raise TypeError(f"sum_i32 takes int32 accumulators, got {acc.dtype}")
        return self.all_reduce(acc, axis, dist.ReduceOp.SUM, "sum_i32")

    def max_f32(self, t: torch.Tensor, axis: str = "model") -> torch.Tensor:
        return self.all_reduce(t.to(torch.float32), axis, dist.ReduceOp.MAX, "max_f32")

    def sum_f32(self, t: torch.Tensor, axis: str = "model") -> torch.Tensor:
        if _needs_grad(t) and self.size(axis) > 1:
            return _SumOver.apply(t, self, (axis,), "g_sum")
        return self.all_reduce(t, axis, dist.ReduceOp.SUM, "sum_f32")

    def sum_rows(self, t: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        """The SUM over the batch axes of each rank's terms (autograd's g op: every
        rank's gradient passes through unchanged)."""
        if self.size_of(axes) == 1:
            return t
        return _SumOver.apply(t, self, tuple(axes), "loss_sum")

    def copy_to(self, t: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """Megatron's f op: ``t`` (replicated over ``axis``) unchanged; under
        autograd its gradient is summed across the axis."""
        if not _needs_grad(t) or self.size(axis) == 1:
            return t
        return _CopyTo.apply(t, self, (axis,))

    def _gather(self, t: torch.Tensor, axis: str, dim: int, name: str) -> torch.Tensor:
        n = self.size(axis)
        if n == 1:
            return t
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self.mesh.groups[axis])
        _count(name)
        return torch.cat(parts, dim=dim)

    def _gather_own(self, t: torch.Tensor, axis: str, dim: int, name: str) -> torch.Tensor:
        if _needs_grad(t) and self.size(axis) > 1:
            return _GatherOwn.apply(t, self, axis, dim % t.ndim)
        return self._gather(t, axis, dim, name)

    def gather_vocab(self, logits: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """(..., V/n) logits of each rank's vocab slice → (..., V), in rank order."""
        return self._gather_own(logits, axis, -1, "gather_vocab")

    def gather_experts(self, out: torch.Tensor, axis: str) -> torch.Tensor:
        """(E/n, C, d) outputs of each rank's experts → (E, C, d), in expert order."""
        return self._gather_own(out, axis, 0, "gather_experts")

    def gather_groups(self, part: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """(M, G/n, N) per-group products of each rank's groups → (M, G, N)."""
        return self._gather(part, axis, -2, "gather_groups")

    def gather_cols(self, t: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """(..., C/n) column slices of each rank → (..., C), in rank order."""
        return self._gather(t, axis, -1, "gather_cols")

    def _gather_ranks(self, t: torch.Tensor, axes: Tuple[str, ...], name: str) -> torch.Tensor:
        """Each data rank's ``t`` concatenated along dim 0 in data-rank order: the
        ranks lie row-major over ``axes`` (the plan's data axes), so the last axis
        is gathered first."""
        for axis in reversed(axes):
            t = self._gather(t, axis, 0, name)
        return t

    def gather_slots(self, t: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        """(B/dp, ...) rows of each data rank → (B, ...) in slot order."""
        return self._gather_ranks(t, axes, "gather_slots")

    def gather_pages(self, buf: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        """(n,) bytes of each data rank → (dp·n,), in data-rank order."""
        return self._gather_ranks(buf, axes, "gather_pages")

    def broadcast(self, t: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        """Rank 0's ``t`` on every rank of the mesh (over each axis in turn)."""
        t = t.contiguous()
        for axis in axes:
            if self.size(axis) > 1:
                dist.broadcast(t, src=dist.get_global_rank(self.mesh.groups[axis], 0),
                               group=self.mesh.groups[axis])
                _count("broadcast")
        return t


@dataclasses.dataclass(frozen=True)
class ShardContext:
    """What a rank's model needs to run its shard: the plan, the collectives,
    each 2-D linear's role (``planner.linear_roles``), the attention heads it
    holds and the vocab and expert slices."""
    plan: object
    coll: Collectives
    roles: Dict[str, Optional[str]]
    q_heads: int                    # query heads of this rank
    kv_proj_heads: int              # kv heads its wk/wv project
    kv_lo: int                      # first projected kv head its queries read
    kv_heads: int                   # kv heads it stores and attends
    embed_split: bool               # the embedding's vocab rows over "model"
    head_split: bool                # the head's vocab columns over "model"
    expert_axis: Optional[str]      # the axis experts split over, or None
    tp_index: int                   # this rank's coordinate on "model"
    # expert-internal TP: the stacked up/gate split d_ff_expert on their output
    # (column-parallel), down on its input (row-parallel)
    expert_tp: bool = False
    state_heads: int = 0            # SSM heads of this rank (its state), 0 without SSM
    state_lo: int = 0               # its first SSM head
    # data-parallel slots: the slot table splits over the plan's data axes into dp
    # contiguous groups, this rank's is dp_index; dp == 1: the slots are whole on
    # every rank (replicated over any data axis)
    dp: int = 1
    dp_index: int = 0
    # the paged K/V rows this rank wrote in the current model call, layer by layer:
    # (the layer's pools, flat pool positions, {pool name: rows})
    kv_log: list = dataclasses.field(default_factory=list)
    # training: the axes this rank's batch rows split over (the plan's data axes);
    # the loss's numerator, count and aux terms SUM over them (models.model.loss_fn)
    batch_axes: Tuple[str, ...] = ()

    def role(self, name: str) -> Optional[str]:
        return self.roles.get(name)


def exchange_pages(shard: Optional[ShardContext]) -> None:
    """Data-parallel paged serving keeps a whole page pool on every rank (one
    allocator, the single device's page ids). After a model call each rank has
    written its own rows' K/V; this writes every other data rank's rows into this
    rank's pools. Every data rank's ``kv_log`` has the same layout (the same
    layers, row counts and dtypes), so one gather of the packed bytes carries the
    whole call's rows. A rank's own rows are already in place; the others never
    read a page a row of this call wrote, so the order of the writes is free."""
    from repro_torch.models.layers import _pool_scatter, _scatter_rows

    if shard is None or shard.dp == 1 or not shard.kv_log:
        return
    log = list(shard.kv_log)
    shard.kv_log.clear()
    flat_bytes = lambda t: t.contiguous().reshape(-1).view(torch.uint8)  # noqa: E731
    buf = torch.cat([flat_bytes(t) for _, flat, rows in log
                     for t in [flat] + [rows[k] for k in sorted(rows)]])
    n = buf.numel()
    every = shard.coll.gather_pages(buf, shard.plan.dp_axes)
    for d in range(shard.dp):
        if d == shard.dp_index:
            continue
        theirs, off = every[d * n:(d + 1) * n], 0

        def take(like: torch.Tensor) -> torch.Tensor:
            nonlocal off
            nb = like.numel() * like.element_size()
            out = theirs[off:off + nb].clone().view(like.dtype).reshape(like.shape)
            off += nb
            return out

        for pools, flat, rows in log:
            kp = pools["k_pages"]
            route = _scatter_rows(take(flat), kp.shape[0] * kp.shape[1])
            for name in sorted(rows):
                _pool_scatter(pools[f"{name}_pages"], route, take(rows[name]))


def make_shard_context(cfg, tree, plan, mesh, coll: Collectives,
                       split_slots: bool = False) -> ShardContext:
    """The :class:`ShardContext` of ``mesh``'s rank for the full ``tree`` under
    ``plan``. Attention: ``tp_full`` holds H/tp query and Hkv/tp kv heads in
    contiguous blocks; ``tp_kv_rep`` H/tp query heads, the kv projections whole
    and, stored, the kv heads its queries read (query head h reads kv head h //
    (H/Hkv) of the global h); ``tp_ffn`` everything. SSM state: H/tp heads in a
    contiguous block where the heads divide the model axis (the reference's
    ``state`` placement), else all. ``split_slots``: the slots split over the
    plan's data axes (the caller decides where they may)."""
    from repro_torch.sharding import planner

    roles = planner.linear_roles(tree, cfg, plan, mesh)
    tp, r = mesh.axis_size("model"), mesh.axis_index("model")
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    q_heads, kv_proj, kv_lo, kv_heads = H, Hkv, 0, Hkv
    if roles.get("wq") == "col":
        q_heads = H // tp
        if roles.get("wk") == "col":
            kv_proj = kv_heads = Hkv // tp
        else:
            G = H // Hkv
            h0, h1 = r * q_heads, (r + 1) * q_heads - 1
            kv_lo, kv_hi = h0 // G, h1 // G
            kv_heads = kv_hi - kv_lo + 1
            if q_heads % kv_heads or any((h0 + j) // G - kv_lo != j // (q_heads // kv_heads)
                                         for j in range(q_heads)):
                raise planner.ShardingUnsupportedError(
                    f"tp_kv_rep with {H} q / {Hkv} kv heads at tp={tp}: a rank's query "
                    f"heads do not read whole, evenly shared kv heads")
    embed_spec = planner.param_spec("embed/w", (cfg.vocab_padded, cfg.d_model), cfg, plan,
                                    mesh)
    embed_split = tp > 1 and embed_spec[-2] == "model"
    head_split = embed_split if cfg.tie_embeddings else roles.get("lm_head") == "col"
    expert_axis = None
    if cfg.n_experts:
        ax = plan.ep_axis if plan.moe_mode == "expert_axis" else (
            "model" if plan.moe_mode == "ep" else None)
        expert_axis = ax if ax is not None and mesh.axis_size(ax) > 1 else None
    state_heads = state_lo = 0
    if cfg.family in ("ssm", "hybrid"):
        state_heads = cfg.ssm_heads
        if tp > 1 and cfg.ssm_heads % tp == 0 and plan.tier != "dp_only":
            state_heads = cfg.ssm_heads // tp
            state_lo = r * state_heads
    dp, dp_index = 1, 0
    if split_slots:
        dp = plan.dp
        for ax in plan.dp_axes:                      # row-major over the data axes
            dp_index = dp_index * mesh.axis_size(ax) + mesh.axis_index(ax)
    return ShardContext(plan, coll, roles, q_heads, kv_proj, kv_lo, kv_heads, embed_split,
                        head_split, expert_axis, r,
                        expert_tp=plan.moe_mode == "expert_tp" and tp > 1,
                        state_heads=state_heads, state_lo=state_lo, dp=dp,
                        dp_index=dp_index)


def token_group_count(n_tokens: int, dp: Optional[int] = None,
                      token_groups: bool = True) -> int:
    """Number of dp-aligned token groups for the grouped MoE dispatch: the data
    axes' size ``dp`` where it divides the token count, else 1. Serving passes
    ``token_groups=False`` (one global dispatch: the same capacity arithmetic as
    one device); so does every path without data axes (``dp`` None). A training
    step on one device passes its ``token_groups`` (``QuantContext``); under a
    data mesh each rank's rows are one group of the global microbatch and it
    dispatches them alone."""
    if not token_groups or dp is None:
        return 1
    if dp >= (1 << 62) or n_tokens % dp != 0:
        return 1
    return dp
