"""The device mesh of sharded serving (port of ``repro/launch/mesh.py``'s
``make_debug_mesh`` and ``parse_mesh_arg``).

A :class:`Mesh` names its axes (``data``, ``model`` and, with an expert axis,
``expert``), their sizes, this process's coordinate on each, and one
``torch.distributed`` process group per axis: the ranks that share every other
coordinate. Ranks lie on the mesh row-major, as ``numpy.reshape(data, model,
expert)`` lays the reference's devices: rank = (d·model + m)·expert + e.

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

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)


def _axis_groups(names: Tuple[str, ...], dims: Tuple[int, ...], rank: int):
    """One process group per axis holding this rank. Every rank creates every
    group, in one order, as ``new_group`` requires."""
    coords_of = list(itertools.product(*(range(d) for d in dims)))   # rank -> coords
    mine: Dict[str, Optional[object]] = {}
    for ax, name in enumerate(names):
        if dims[ax] == 1:
            mine[name] = None
            continue
        others = [range(d) for i, d in enumerate(dims) if i != ax]
        for rest in itertools.product(*others):
            ranks = [r for r, c in enumerate(coords_of)
                     if tuple(v for i, v in enumerate(c) if i != ax) == rest]
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[name] = group
    return mine


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
    names: Tuple[str, ...] = ("data", "model", "expert") if expert > 1 else ("data", "model")
    dims = (data, model, expert) if expert > 1 else (data, model)
    rank = dist.get_rank() if dist.is_initialized() else 0
    coords = dict(zip(names, list(itertools.product(*(range(d) for d in dims)))[rank]))
    groups = (_axis_groups(names, dims, rank) if n > 1
              else {name: None for name in names})
    return Mesh(names, dict(zip(names, dims)), coords, rank, groups)


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
