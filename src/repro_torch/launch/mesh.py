"""The device mesh of sharded serving and training (port of
``repro/launch/mesh.py``'s ``make_debug_mesh`` and ``parse_mesh_arg``).

A :class:`Mesh` names its axes (``data``, ``model`` and, with an expert axis,
``expert``), their sizes, this process's coordinate on each, one
``torch.distributed`` process group per axis (the ranks that share every other
coordinate) and one over the whole mesh. Ranks lie on the mesh row-major, as
``numpy.reshape(data, model, expert)`` lays the reference's devices: mesh rank =
(d·model + m)·expert + e. :func:`make_mesh` lays a mesh over the first ranks of
a larger world (``runtime.elastic.make_elastic_mesh``: the survivors of a
shrunk data axis); its mesh rank is then the process's world rank.

One process per rank (SPMD): the caller starts them (``torchrun``,
``torch.multiprocessing.spawn``) and calls ``torch.distributed.init_process_group``
with the backend it wants (gloo on the CPU or for several ranks on one card, NCCL
with a card per rank) before building the mesh. A mesh of one rank needs no
process group. ``make_production_mesh`` (the TPU pod layout) is not ported.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Tuple

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]                 # axis -> size, as the reference's mesh.shape
    coords: Dict[str, int]                # this rank's coordinate on each axis
    rank: int
    groups: Dict[str, Optional[object]]   # axis -> process group (None: one rank)
    group: Optional[object] = None        # the whole mesh's process group (None: one rank)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group_of(self, axes: Tuple[str, ...]):
        """The process group over ``axes``: one axis's, or the whole mesh's where
        ``axes`` hold every axis of more than one rank."""
        wide = tuple(a for a in axes if self.axis_size(a) > 1)
        if len(wide) == 1:
            return self.groups[wide[0]]
        if set(wide) == {a for a in self.axis_names if self.axis_size(a) > 1}:
            return self.group
        raise ValueError(f"no process group over {axes} of the mesh {self.shape}")


def _axis_groups(names: Tuple[str, ...], dims: Tuple[int, ...], pos: int,
                 members: Tuple[int, ...]):
    """One process group per axis holding the mesh position ``pos``, over the world
    ranks ``members`` (mesh position i is world rank members[i]). Every process of
    the world creates every group, in one order, as ``new_group`` requires."""
    coords_of = list(itertools.product(*(range(d) for d in dims)))   # pos -> coords
    mine: Dict[str, Optional[object]] = {}
    for ax, name in enumerate(names):
        if dims[ax] == 1:
            mine[name] = None
            continue
        others = [range(d) for i, d in enumerate(dims) if i != ax]
        for rest in itertools.product(*others):
            ps = [p for p, c in enumerate(coords_of)
                  if tuple(v for i, v in enumerate(c) if i != ax) == rest]
            group = dist.new_group([members[p] for p in ps])
            if pos in ps:
                mine[name] = group
    return mine


def make_mesh(data: int = 1, model: int = 1, expert: int = 1,
              ranks: Optional[Tuple[int, ...]] = None) -> Optional[Mesh]:
    """A (data, model[, expert]) mesh over the world ranks ``ranks`` (default: the
    first data·model·expert of the default process group). Every process of the
    world calls it (process groups are made collectively); one outside ``ranks``
    gets None."""
    n = data * model * expert
    world = dist.get_world_size() if dist.is_initialized() else 1
    members = tuple(range(n)) if ranks is None else tuple(sorted(ranks))
    if len(members) != n or max(members) >= world:
        raise RuntimeError(f"a (data={data}, model={model}, expert={expert}) mesh needs "
                           f"{n} of the world's {world} ranks, got {members}")
    names: Tuple[str, ...] = ("data", "model", "expert") if expert > 1 else ("data", "model")
    dims = (data, model, expert) if expert > 1 else (data, model)
    me = dist.get_rank() if dist.is_initialized() else 0
    pos = members.index(me) if me in members else -1
    if n == 1:
        groups, whole = {name: None for name in names}, None
    else:
        groups = _axis_groups(names, dims, pos, members)
        whole = (dist.group.WORLD if members == tuple(range(world))
                 else dist.new_group(list(members)))
    if pos < 0:
        return None
    coords = dict(zip(names, list(itertools.product(*(range(d) for d in dims)))[pos]))
    return Mesh(names, dict(zip(names, dims)), coords, me, groups, whole)


def make_debug_mesh(data: int = 1, model: int = 1, expert: int = 1) -> Mesh:
    """A (data, model[, expert]) mesh over the ranks of the default process group
    (``expert > 1`` appends the dedicated expert-parallel axis). Raises when the
    world does not hold ``data·model·expert`` ranks, with the hint to launch
    them."""
    n = data * model * expert
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(
            f"need {n} processes for a (data={data}, model={model}, expert={expert}) "
            f"debug mesh, have {world} — launch them with torchrun --nproc_per_node {n} "
            f"(or torch.multiprocessing.spawn, each calling "
            f"torch.distributed.init_process_group), or shrink the mesh")
    return make_mesh(data, model, expert)


def parse_mesh_arg(spec: str) -> Mesh:
    """``"data,model"`` or ``"data,model,expert"`` CLI string (e.g. ``"2,1"`` for
    data-parallel slots, ``"1,2"`` for tensor parallelism, ``"2,2"`` for both,
    ``"1,2,2"`` with an expert axis) → debug mesh. The serving launcher's
    ``--mesh`` flag."""
    try:
        dims = [int(x) for x in spec.split(",")]
        if len(dims) not in (2, 3) or min(dims) < 1:
            raise ValueError(spec)
    except ValueError:
        raise SystemExit(
            f"--mesh expects DATA,MODEL[,EXPERT] (e.g. --mesh 2,1, --mesh 1,2, "
            f"--mesh 2,2 or --mesh 1,2,2), got {spec!r}")
    return make_debug_mesh(*dims)
