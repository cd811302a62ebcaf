"""Divisibility-aware sharding planner (port of ``repro/sharding/planner.py``).

The planner chooses, per (arch × workload), the strongest tier whose
divisibility constraints hold, and places every leaf of the params and cache
trees: for each dim, the mesh axis (or axes) it splits over, or ``None``.
A dimension that does not divide its axis is replicated, never an error.

Tiers (attention handling):
  tp_full    q, kv heads and ffn sharded over "model"
  tp_kv_rep  kv replicated (the GQA grouping stays shard-local), q + ffn sharded
  tp_ffn     attention replicated, ffn/vocab sharded
MoE: experts over a dedicated "expert" axis when the mesh has one and E divides
it (``expert_axis``), else over "model" when E divides (``ep``), else
expert-internal TP (``expert_tp``) when d_ff_expert divides.

A placement is the reference's ``PartitionSpec`` as a tuple: one entry per dim,
``None``, an axis name, or a tuple of axis names (training's FSDP dims). Here it
is the storage of a rank's shard (:func:`shard_tree` cuts it; in training
``training.layout`` gathers the FSDP dims back before a step) and it decides how
the model computes: a 2-D linear whose weight splits its output dim is
column-parallel, one that splits its input dim row-parallel
(:func:`linear_roles`). The dense KV cache's reference placement splits the
sequence (storage only there, since its kernels gather); the port's dense
cache holds a rank's kv heads instead, as the paged pools do. Under a data axis
the dense cache holds a rank's slots, as the reference's places B; the paged
pools, which the reference places over data as storage, stay whole on every rank
(one allocator; ``ServeEngine`` exchanges each call's K/V rows).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

Spec = Tuple[object, ...]


class ShardingUnsupportedError(NotImplementedError):
    """A sharded combination the port does not run: the subclasses below, and in
    serving fake quantization other than per-channel weights with crossquant /
    per-token / no activation quantization on a split linear."""


class ShardedW4A8Error(ShardingUnsupportedError):
    """A packed-int4 (W4A8) leaf split over the mesh where its groups do not split
    with it: a row-parallel W4 linear needs the model axis to divide its group
    count (the planner's ``sw`` rule), and a stacked W4 expert linear under
    expert-internal TP has no group-acc expert mode (K8 is not expert-batched)."""


class ExpertTPError(ShardingUnsupportedError):
    """``moe_mode == "expert_tp"`` (d_ff_expert split over "model") forced on a
    config whose d_ff_expert the model axis does not divide."""


class ShardedTrainingError(ShardingUnsupportedError):
    """A sharded training case the port does not run (:func:`check_train`); the
    message names the ROADMAP item that would lift it."""


def check_train(cfg: ModelConfig, plan: Plan, mesh, quant=None,
                compression=None) -> None:
    """Raise :class:`ShardedTrainingError` for the training cases the port leaves
    out, before any collective: in ROADMAP A's order,

    * A4: a model axis of more than one rank over the SSM, hybrid, vision or
      audio families (their state heads, ``gather_cols`` and frontends have no
      autograd path; under data axes alone they train);
    * A5: experts split inside (``expert_tp``) or over a dedicated expert axis
      (``expert_axis``);
    * A6: quantized training (QAT, ``mode="fake"``, or ``mode="int8"``) under a
      mesh: only ``mode="fp"`` trains sharded;
    * A7: gradient compression under a model axis (its CrossQuant statistics span
      the whole leaf, which a rank holds only a slice of)."""
    model_split = mesh.shape.get(plan.tp_axis, 1) > 1 and plan.tier != "dp_only"
    if model_split and cfg.family not in ("dense", "moe"):
        raise ShardedTrainingError(
            f"training {cfg.name} ({cfg.family}) under a model axis of "
            f"{mesh.shape[plan.tp_axis]} (ROADMAP A4): only the dense and MoE families "
            f"train tensor-parallel; under data axes alone (or tier dp_only) it trains")
    if plan.moe_mode in ("expert_tp", "expert_axis"):
        raise ShardedTrainingError(
            f"training {cfg.name} with moe_mode {plan.moe_mode!r} (ROADMAP A5): experts "
            f"train whole on one rank (ep over the model axis) or replicated")
    if quant is not None and quant.mode != "fp":
        raise ShardedTrainingError(
            f"training under quantization mode {quant.mode!r} ({quant.tag()}) on a mesh "
            f"(ROADMAP A6): sharded training runs mode='fp'")
    if compression is not None and model_split:
        raise ShardedTrainingError(
            f"gradient compression under a model axis of {mesh.shape[plan.tp_axis]} "
            f"(ROADMAP A7): its scales span the whole leaf; compress under data axes")


@dataclasses.dataclass(frozen=True)
class Plan:
    tier: str                  # tp_full | tp_kv_rep | tp_ffn | dp_only
    moe_mode: str              # none | ep | expert_tp | expert_axis
    dp_axes: Tuple[str, ...]   # batch axes, e.g. ("pod", "data")
    tp_axis: str               # "model"
    dp: int
    tp: int
    fsdp: bool                 # shard weight free dims over dp axes (training)
    seq_shard_kv: bool         # decode caches: T over model (reference placement)
    # the dedicated expert-parallel axis ("expert") when the mesh has one that
    # divides n_experts; stacked (E, ...) expert trees then shard E over it
    ep_axis: Optional[str] = None
    ep: int = 1

    def describe(self) -> dict:
        return dataclasses.asdict(self)


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


def make_serve_plan(cfg: ModelConfig, mesh, force_tier: Optional[str] = None) -> Plan:
    """Serving-mode plan for ``ServeEngine``: a decode-kind plan whose placements
    also cover prepared integer trees (``qw``/``qw4`` and their ``sw``, ``bcol``,
    ``qalpha`` and packed ``mask`` leaves follow their weight's model-axis
    split) and slot-table KV caches with their int8-KV scale leaves."""
    shape = ShapeConfig(name="serve", seq_len=0, global_batch=0, kind="decode")
    return make_plan(cfg, shape, mesh, force_tier=force_tier)


def make_plan(cfg: ModelConfig, shape: ShapeConfig, mesh,
              force_tier: Optional[str] = None) -> Plan:
    """``mesh`` is anything with a ``shape`` dict of axis sizes (a :class:`Mesh`
    of ``launch.mesh``, or a stand-in in tests)."""
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    tp = mesh.shape["model"]
    dp = _axis_size(mesh, dp_axes)

    if cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0:
        tier = "tp_full"
    elif cfg.n_heads % tp == 0:
        tier = "tp_kv_rep"
    else:
        tier = "tp_ffn"
    if force_tier:
        tier = force_tier
    if tier == "dp_only":
        # the model axis folds into data parallelism: batch over (data, model),
        # weights FSDP over the whole mesh, no TP collectives
        dp_axes = dp_axes + ("model",)
        dp = _axis_size(mesh, dp_axes)

    ep_axis = None
    ep = 1
    moe_mode = "none"
    if cfg.n_experts and "expert" in mesh.shape and tier != "dp_only" \
            and cfg.n_experts % mesh.shape["expert"] == 0:
        # each expert's product runs whole on one ep shard: bitwise vs one device
        ep_axis, ep, moe_mode = "expert", mesh.shape["expert"], "expert_axis"
    elif cfg.n_experts and tier != "dp_only":
        if cfg.n_experts % tp == 0:
            moe_mode = "ep"
        elif (cfg.d_ff_expert or cfg.d_ff) % tp == 0:
            moe_mode = "expert_tp"

    return Plan(
        tier=tier, moe_mode=moe_mode, dp_axes=dp_axes, tp_axis="model",
        dp=dp, tp=tp, fsdp=(shape.kind == "train"), ep_axis=ep_axis, ep=ep,
        seq_shard_kv=(shape.kind in ("decode", "prefill")),
    )


# ======================================================================================
# Parameter placements
# ======================================================================================

def _maybe(axis, dim: int, mesh):
    """The axis if the dim divides it, else None (replicate)."""
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def _norm(spec) -> Spec:
    """A placement as ``PartitionSpec`` holds it: a one-axis tuple is the axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def param_spec(pathstr: str, shape: Tuple[int, ...], cfg: ModelConfig, plan: Plan,
               mesh) -> Spec:
    """The placement of the leaf at ``pathstr`` ("blocks/0/attn/wq/qw") of
    ``shape``: the reference's ``_param_spec``, rule for rule."""
    return _norm(_param_spec(pathstr, shape, cfg, plan, mesh))


def _param_spec(pathstr: str, shape: Tuple[int, ...], cfg: ModelConfig, plan: Plan,
                mesh) -> Spec:
    names = pathstr.split("/")
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    tp, dpa = plan.tp_axis, plan.dp_axes
    nd = len(shape)
    repl = (None,) * nd

    def build(out_axis: Optional[int], model_ok: bool, fsdp_axis: Optional[int] = None):
        """``model`` on dim ``out_axis`` where it divides, and the FSDP dim (over
        the dp axes, or the whole mesh where the weight holds no model split)."""
        spec: list = [None] * nd
        placed_model = False
        if model_ok and out_axis is not None and _maybe(tp, shape[out_axis], mesh):
            spec[out_axis] = tp
            placed_model = True
        if plan.fsdp and fsdp_axis is not None and spec[fsdp_axis] is None:
            full = dpa if tp in dpa else tuple(dpa) + (tp,)
            candidates = (dpa,) if placed_model else (full, dpa)
            for axes in candidates:
                if _maybe(axes, shape[fsdp_axis], mesh):
                    spec[fsdp_axis] = axes
                    break
        return tuple(spec)

    # scalars / vectors (norms, biases, SSM leaves, the router) replicate; the
    # quantization metadata is placed with its weight below
    if parent in ("router",) or leaf in ("scale", "bias", "conv_w", "conv_b", "A_log",
                                         "D", "dt_bias", "norm_scale"):
        return repl

    if plan.tier == "dp_only":
        if leaf in ("w", "qw", "qw4") and nd >= 2:
            if _maybe(dpa, shape[-2], mesh):
                return build(out_axis=None, model_ok=False, fsdp_axis=-2)
            return build(out_axis=None, model_ok=False, fsdp_axis=-1)
        return repl

    if parent == "embed":
        spec: list = [None] * nd
        placed = False
        if _maybe(tp, shape[-2], mesh):
            spec[-2] = tp                                    # vocab over model
            placed = True
        if plan.fsdp:
            full = dpa if tp in dpa else tuple(dpa) + (tp,)
            for axes in ((dpa,) if placed else (full, dpa)):
                if _maybe(axes, shape[-1], mesh):
                    spec[-1] = axes
                    break
        return tuple(spec)
    if parent == "lm_head":
        return build(out_axis=-1, model_ok=True, fsdp_axis=-2)

    # a shared expert is a plain dense MLP: d_ff over model like any MLP
    moe = "moe" in names and parent in ("up", "gate", "down") and "shared" not in names
    if moe:
        if plan.ep_axis is not None:
            # every stacked expert leaf (weights, scales, masks) splits E over the
            # expert axis; expert-internal dims stay whole
            e_dim = 1 if names[0] == "blocks" else 0
            spec = [None] * nd
            if nd > e_dim and _maybe(plan.ep_axis, shape[e_dim], mesh):
                spec[e_dim] = plan.ep_axis
            return tuple(spec)
        if nd < 3 or leaf not in ("w", "qw", "qw4"):
            return repl                  # prepared scale vectors: tiny, replicated
        if plan.moe_mode == "ep":
            spec = [None] * nd
            spec[-3] = tp                                    # experts over model
            if plan.fsdp and _maybe(dpa, shape[-2], mesh):
                spec[-2] = dpa
            return tuple(spec)
        if plan.moe_mode == "expert_tp":
            ax = -1 if parent in ("up", "gate") else -2      # shard d_ff_expert
            return build(out_axis=ax, model_ok=True, fsdp_axis=(-2 if ax == -1 else -1))
        return build(out_axis=None, model_ok=False, fsdp_axis=-2)

    attn_ok = plan.tier in ("tp_full", "tp_kv_rep")
    table = {
        "wq":  (-1, attn_ok, -2),
        "wk":  (-1, plan.tier == "tp_full", -2),
        "wv":  (-1, plan.tier == "tp_full", -2),
        "wo":  (-2, attn_ok, -1),
        "up":   (-1, True, -2),
        "gate": (-1, True, -2),
        "down": (-2, True, -1),
        "in_proj":  (-1, True, -2),
        "out_proj": (-2, True, -1),
        "proj": (-1, True, -2),                              # frontend stub
    }
    if parent in table and leaf in ("w", "qw", "qw4"):
        ax, ok, fa = table[parent]
        return build(out_axis=ax, model_ok=ok, fsdp_axis=fa)
    if parent in table and leaf == "sw":
        # follows the weight: column-parallel splits d_out; row-parallel int4
        # ((..., G, d_out) group scales) splits G where tp divides it; the layer
        # stack axis never splits
        ax, ok, _ = table[parent]
        rank = nd - (1 if names[0] == "blocks" else 0)
        if ok and ax == -1 and _maybe(tp, shape[-1], mesh):
            return (None,) * (nd - 1) + (tp,)
        if ok and ax == -2 and rank == 2 and _maybe(tp, shape[-2], mesh):
            return (None,) * (nd - 2) + (tp, None)
        return repl
    if parent in table and leaf == "bcol":
        # divides the activation's columns: splits d_in with a row-parallel weight
        ax, ok, _ = table[parent]
        if ok and ax == -2 and _maybe(tp, shape[-1], mesh):
            return (None,) * (nd - 1) + (tp,)
        return repl
    if parent in table and leaf == "mask":
        # the bit-packed N:M keep-mask rides its weight's split: d_out when
        # column-parallel, the packed d_in axis (byte granularity) when row-parallel
        ax, ok, _ = table[parent]
        if ok and ax == -1 and _maybe(tp, shape[-1], mesh):
            return (None,) * (nd - 1) + (tp,)
        if ok and ax == -2 and _maybe(tp, shape[-2], mesh):
            return (None,) * (nd - 2) + (tp, None)
        return repl
    # qalpha, a calibration table, an occupancy table (rebuilt per shard) and
    # anything else replicate
    return repl


def _walk(tree, fn, path=()):
    """Map ``fn(path, leaf)`` over a nested dict/list tree of tensors."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_placements(tree, cfg: ModelConfig, plan: Plan, mesh):
    """The params tree (raw, prepared int8/int4, masked) → the same tree of
    placements (:func:`param_spec`)."""
    return _walk(tree, lambda path, t: param_spec("/".join(path), tuple(t.shape), cfg,
                                                  plan, mesh))


def cache_placements(cache_tree, cfg: ModelConfig, plan: Plan, mesh):
    """KV caches (B, T, Hkv, D) [+ the leading n_blocks when stacked]: B → dp, T →
    model (decode); int8-KV scale leaves as their codes. Paged pools (P, ps, Hkv,
    D|1): pages → dp, kv heads → model where they divide; the routing tables and
    anything else replicate. SSM caches: B → dp, heads → model where they divide.
    The reference's ``cache_shardings``, rule for rule."""
    def one(path, leaf):
        names = list(path)
        stacked = "tail" not in names
        nd = len(leaf.shape)
        off = 1 if stacked else 0
        spec: list = [None] * nd
        last = names[-1]
        shp = leaf.shape
        if last in ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages"):
            if _maybe(plan.dp_axes, shp[off + 0], mesh):
                spec[off + 0] = plan.dp_axes
            if _maybe(plan.tp_axis, shp[off + 2], mesh):
                spec[off + 2] = plan.tp_axis
        elif last in ("k", "v", "k_scale", "v_scale"):
            if _maybe(plan.dp_axes, shp[off + 0], mesh):
                spec[off + 0] = plan.dp_axes
            if plan.seq_shard_kv and _maybe(plan.tp_axis, shp[off + 1], mesh):
                spec[off + 1] = plan.tp_axis
        elif last == "state_pages":                  # (P, H, Pd, N)
            if _maybe(plan.dp_axes, shp[off + 0], mesh):
                spec[off + 0] = plan.dp_axes
            if _maybe(plan.tp_axis, shp[off + 1], mesh):
                spec[off + 1] = plan.tp_axis
        elif last == "conv_pages":                   # (P, K-1, C)
            if _maybe(plan.dp_axes, shp[off + 0], mesh):
                spec[off + 0] = plan.dp_axes
        elif last == "state":                        # (B, H, P, N)
            if _maybe(plan.dp_axes, shp[off + 0], mesh):
                spec[off + 0] = plan.dp_axes
            if _maybe(plan.tp_axis, shp[off + 1], mesh):
                spec[off + 1] = plan.tp_axis
        elif last == "conv":                         # (B, K-1, C)
            if _maybe(plan.dp_axes, shp[off + 0], mesh):
                spec[off + 0] = plan.dp_axes
        return _norm(spec)

    return _walk(cache_tree, one)


# ======================================================================================
# Shards
# ======================================================================================

def _coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """Rank → its coordinate on each axis (row-major over the axes in order)."""
    names = list(shape)
    return dict(zip(names, list(itertools.product(*(range(shape[a]) for a in names)))[rank]))


def _slices(spec: Spec, dims: Tuple[int, ...], shape: Dict[str, int],
            coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The slice of a full leaf of ``dims`` that the rank at ``coords`` holds."""
    out = []
    for entry, d in zip(spec, dims):
        if entry is None:
            out.append(slice(None))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n, idx = 1, 0
        for a in axes:                              # row-major over the entry's axes
            idx = idx * shape[a] + coords[a]
            n *= shape[a]
        step = d // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard_tree(tree, placements, mesh):
    """This rank's shard of a full tree: every leaf cut along its placement and
    copied into memory of its own (contiguous), so the full tree can be freed."""
    shape, coords = dict(mesh.shape), dict(mesh.coords)

    def cut(t: torch.Tensor, spec: Spec) -> torch.Tensor:
        if all(e is None for e in spec):
            return t
        return t[_slices(spec, tuple(t.shape), shape, coords)].clone(
            memory_format=torch.contiguous_format)

    return _map2(tree, placements, cut)


def unshard_tree(shards, placements, shape: Dict[str, int]):
    """Inverse of :func:`shard_tree`: ``shards[r]`` is rank r's shard on a mesh of
    axis sizes ``shape``; returns the full tree (each leaf from the ranks' pieces)."""
    def join(path, spec):
        pieces = [_leaf(s, path) for s in shards]
        if all(e is None for e in spec):
            return pieces[0]
        factor = [1] * len(spec)
        for i, entry in enumerate(spec):
            if entry is not None:
                axes = (entry,) if isinstance(entry, str) else tuple(entry)
                factor[i] = math.prod(shape[a] for a in axes)
        full_dims = tuple(d * f for d, f in zip(pieces[0].shape, factor))
        full = torch.empty(full_dims, dtype=pieces[0].dtype, device=pieces[0].device)
        for r, piece in enumerate(pieces):
            full[_slices(spec, full_dims, shape, _coords(shape, r))] = piece
        return full

    return _walk(placements, lambda path, spec: join(path, spec))


def _leaf(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _map2(tree, other, fn):
    if isinstance(tree, dict):
        return {k: _map2(v, other[k], fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map2(v, o, fn) for v, o in zip(tree, other)]
    return fn(tree, other)


def linear_roles(tree, cfg: ModelConfig, plan: Plan, mesh) -> Dict[str, Optional[str]]:
    """How each 2-D linear of the model computes under the plan, by its name
    (``wq``, ``wo``, ``up``, ``down``, ``lm_head``, ...): ``"col"`` where its weight
    splits the output dim over a model axis of more than one rank
    (column-parallel: each rank its output columns), ``"row"`` where it splits the
    input dim (row-parallel: partial products summed across ranks), ``None``
    where it is whole on every rank. Stacked expert linears are not listed: an
    expert runs whole on the rank that holds it. Raises where one name would take
    two roles."""
    roles: Dict[str, Optional[str]] = {}
    tp = plan.tp_axis

    def visit(path, t):
        names = list(path)
        if names[-1] not in ("w", "qw", "qw4") or len(names) < 2:
            return
        parent = names[-2]
        if parent in ("embed", "router") or (
                "moe" in names and parent in ("up", "gate", "down") and "shared" not in names):
            return
        spec = param_spec("/".join(names), tuple(t.shape), cfg, plan, mesh)
        role = None
        if mesh.shape[tp] > 1:
            role = "col" if spec[-1] == tp else "row" if spec[-2] == tp else None
        if roles.setdefault(parent, role) != role:
            raise ValueError(f"linear {parent!r} takes two roles under the plan: "
                             f"{roles[parent]!r} and {role!r}")

    _walk(tree, visit)
    return roles
