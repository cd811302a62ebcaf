"""How a mesh rank holds the train state, and the packed collectives that move it
(the port's counterpart of the reference's ``planner.param_shardings`` under
``hints.sharding_hints`` in ``repro/launch/train.py``).

A leaf's placement (``sharding.planner.param_placements`` under a training plan,
``fsdp=True``) splits some of its dims over mesh axes. A dim split over the model
axis alone is the *compute* split: the rank computes on that slice (a column- or
row-parallel linear's columns or rows, the vocab-parallel embedding's rows, the
experts it holds under ``ep``). Every other split is FSDP storage: a dim over the
data axes, or over data and model where the weight holds no model split (or
under ``dp_only``). A rank stores only its storage shard of the params and of
both Adam moments; at the start of a step :meth:`TrainLayout.gather` rebuilds
its compute slices (``fsdp_gather``), the gradients of those slices are summed
over the data axes (``grad_sum``) and :meth:`TrainLayout.to_shards` keeps the
rank's shard of the sum (all-reduce, then slice). Each is one call per group of
leaves that gather over the same axes, not one per leaf.

The batch: microbatch i is global rows [i·B_m, (i+1)·B_m) and data rank r takes
rows [r·B_m/dp, (r+1)·B_m/dp) of it (``hints.constrain_microbatches``' layout:
the data axes on axis 1 of the (n_micro, B_m, ...) stack), data ranks counted
row-major over the plan's data axes. Every rank builds the global batch and
takes its rows (:meth:`TrainLayout.rows`). ``trainer.make_train_step(...,
mesh=)`` builds the layout (:func:`train_layout`) and returns it as the step's
``layout``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import init_params, leaves, map_tensors
from repro_torch.sharding import collectives as SC
from repro_torch.sharding import planner
from repro_torch.training.optimizer import OptState


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _specs(placements, like) -> list:
    """The placements of ``like``'s leaves, in :func:`leaves` order (a placement
    is a tuple: ``like``'s structure says where the leaves are)."""
    if isinstance(like, dict):
        return [s for k in sorted(like) for s in _specs(placements[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [s for i, v in enumerate(like) for s in _specs(placements[i], v)]
    return [placements]


def _rebuild(like, values: list):
    """``like``'s tree with its leaves (in :func:`leaves` order) replaced."""
    it = iter(values)

    def walk(t):
        if isinstance(t, dict):
            out = dict.fromkeys(t)                   # the keys in their own order,
            for k in sorted(t):                      # filled in leaves() order
                out[k] = walk(t[k])
            return out
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)

    return walk(like)


@dataclasses.dataclass
class TrainLayout:
    mesh: object
    plan: planner.Plan
    coll: SC.Collectives
    template: dict            # the full tree's shapes (meta tensors)
    placements: dict          # storage placements of the full tree
    shard_ctx: SC.ShardContext

    def __post_init__(self):
        mesh, plan = self.mesh, self.plan
        self._specs = _specs(self.placements, self.template)
        self._compute = [self._compute_spec(s) for s in self._specs]
        self._full = [tuple(t.shape) for t in leaves(self.template)]
        wide = [a for a in mesh.axis_names if mesh.axis_size(a) > 1]
        # a leaf's storage shard counts towards the clip norm on one rank of each
        # group holding the same piece: the one at coordinate 0 of every axis the
        # leaf is replicated over
        self.owned = [all(mesh.axis_index(a) == 0 for a in wide
                          if a not in {x for e in spec for x in _axes(e)})
                      for spec in self._specs]
        self.dp_index = 0
        for ax in plan.dp_axes:
            self.dp_index = self.dp_index * mesh.axis_size(ax) + mesh.axis_index(ax)

    def _compute_spec(self, spec) -> tuple:
        """The part of a storage placement the rank computes on: its model-axis
        split (none under ``dp_only``, where the model axis is a data axis)."""
        if self.plan.tier == "dp_only":
            return (None,) * len(spec)
        return tuple(e if e == self.plan.tp_axis else None for e in spec)

    # -- the state --------------------------------------------------------------------

    def shard(self, tree):
        """This rank's storage shard of a full tree (params, or either moment)."""
        return planner.shard_tree(tree, self.placements, self.mesh)

    def state_placements(self, state: dict) -> dict:
        """Placements of ``{"params", "opt"[, "err"]}``: the moments as the params,
        the step and the error-feedback state (whole leaves) replicated."""
        out = {"params": self.placements,
               "opt": OptState((), self.placements, self.placements)}
        if "err" in state:
            out["err"] = planner._walk(state["err"], lambda _, t: (None,) * t.ndim)
        return out

    def init_error_state(self, device) -> dict:
        """Gradient compression's error state: f32 zeros of each whole (≥ 2-D) leaf,
        the same on every rank (the data-summed gradient it follows is)."""
        return map_tensors(self.template, lambda p: torch.zeros(
            p.shape if p.ndim >= 2 else (), dtype=torch.float32, device=device))

    def unshard(self, shards):
        """The full tree from every rank's shards (a collective: every rank of the
        mesh calls it and gets the tree; a leaf no axis splits is the shard
        itself)."""
        return _rebuild(shards, self._gather(leaves(shards), self._specs,
                                             [(None,) * len(s) for s in self._specs],
                                             "fsdp_gather"))

    # -- one step ----------------------------------------------------------------------

    def rows(self, batch: Dict[str, torch.Tensor], i: int, n_micro: int):
        """This data rank's rows of microbatch ``i`` of the global ``batch``."""
        out = {}
        for k, v in batch.items():
            B = v.shape[0]
            if B % (n_micro * self.plan.dp):
                raise ValueError(f"global batch {B} does not split into {n_micro} "
                                 f"microbatches over {self.plan.dp} data ranks")
            bm, local = B // n_micro, B // n_micro // self.plan.dp
            lo = i * bm + self.dp_index * local
            out[k] = v[lo:lo + local]
        return out

    def gather(self, shards):
        """The rank's compute slices of the params from the storage shards."""
        return _rebuild(shards, self._gather(leaves(shards), self._specs, self._compute,
                                             "fsdp_gather"))

    def sum_grads(self, grads) -> None:
        """Gradients of the compute slices summed over the data axes, in place (one
        packed all-reduce)."""
        axes = self.plan.dp_axes
        if self.coll.size_of(axes) == 1:
            return
        gl = leaves(grads)
        flat = torch.cat([g.reshape(-1) for g in gl])
        self.coll.all_reduce(flat, axes, dist.ReduceOp.SUM, "grad_sum")
        off = 0
        for g in gl:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()

    def to_shards(self, compute_tree):
        """The rank's storage shards of a tree of compute slices (the summed
        gradients)."""
        out = []
        for t, spec, keep, full in zip(leaves(compute_tree), self._specs, self._compute,
                                       self._full):
            if spec == keep:
                out.append(t)
                continue
            rel = self._relative(spec, keep, full, self.mesh.coords)
            out.append(t[rel].clone(memory_format=torch.contiguous_format))
        return _rebuild(compute_tree, out)

    def norm_sum(self, parts: torch.Tensor) -> torch.Tensor:
        """The clip norm's per-leaf partial sums of squares, summed over the mesh."""
        return self.coll.all_reduce(parts, tuple(self.mesh.axis_names),
                                    dist.ReduceOp.SUM, "norm_sum")

    # -- the packed gather -------------------------------------------------------------

    def _relative(self, spec, keep, full, coords) -> Tuple[slice, ...]:
        """The slice of the piece at ``coords`` (under ``spec``) within the slice
        ``keep`` leaves whole: ``keep`` splits a dim as ``spec`` does or not at
        all."""
        shape = dict(self.mesh.shape)
        piece = planner._slices(spec, full, shape, coords)
        return tuple(slice(None) if k is not None else p for k, p in zip(keep, piece))

    def _gather(self, ts: List[torch.Tensor], specs: list, keeps: list,
                name: str) -> List[torch.Tensor]:
        """Each leaf's slice under its ``keeps`` entry, gathered from the ranks
        holding its pieces under ``specs``: one all-gather per (axes, dtype)."""
        mesh, out = self.mesh, list(ts)
        buckets: Dict[tuple, List[int]] = {}
        for i, (t, spec, keep) in enumerate(zip(ts, specs, keeps)):
            axes = {a for e, k in zip(spec, keep) if e != k for a in _axes(e)
                    if mesh.axis_size(a) > 1}
            if axes:
                order = tuple(a for a in mesh.axis_names if a in axes)
                buckets.setdefault((order, t.dtype), []).append(i)
        for (axes, _), idx in buckets.items():
            flat = torch.cat([ts[i].reshape(-1) for i in idx])
            dims = [mesh.axis_size(a) for a in axes]
            parts = [torch.empty_like(flat) for _ in range(math.prod(dims))]
            dist.all_gather(parts, flat, group=mesh.group_of(axes))
            SC._count(name)
            for i in idx:
                full, keep = self._full[i], keeps[i]
                shape = tuple(f // math.prod(mesh.axis_size(a) for a in _axes(k))
                              for f, k in zip(full, keep))
                out[i] = torch.empty(shape, dtype=ts[i].dtype, device=ts[i].device)
            for j, part in enumerate(parts):
                coords, rem = dict(mesh.coords), j
                for a, d in zip(reversed(axes), reversed(dims)):   # row-major over axes
                    coords[a], rem = rem % d, rem // d
                off = 0
                for i in idx:
                    n = ts[i].numel()
                    rel = self._relative(specs[i], keeps[i], self._full[i], coords)
                    out[i][rel] = part[off:off + n].view(ts[i].shape)
                    off += n
        return out


def train_layout(cfg: ModelConfig, mesh, plan=None) -> TrainLayout:
    """The layout of ``cfg``'s train state on ``mesh`` under ``plan`` (default:
    ``make_plan(cfg, ShapeConfig(kind="train"), mesh)``)."""
    if plan is None:
        plan = planner.make_plan(cfg, ShapeConfig(name="train", seq_len=0, global_batch=0,
                                                  kind="train"), mesh)
    template = init_params(torch.Generator(), cfg, device="meta")
    placements = planner.param_placements(template, cfg, plan, mesh)
    coll = SC.Collectives(mesh)
    sh = SC.make_shard_context(cfg, template, plan, mesh, coll)
    sh = dataclasses.replace(sh, batch_axes=plan.dp_axes if plan.dp > 1 else ())
    return TrainLayout(mesh, plan, coll, template, placements, sh)
