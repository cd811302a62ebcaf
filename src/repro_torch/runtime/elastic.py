"""Elastic mesh rebuild (port of ``repro/runtime/elastic.py``): shrink or grow
the mesh and reshard live state.

When the supervisor evicts a straggler or loses a host, the surviving rank count
changes and training continues on a smaller (or, after repair, larger) mesh:

* :func:`plan_mesh_shape` picks the largest (data, model) grid over the
  surviving ranks with the model axis held fixed (the tensor-parallel degree is
  a property of the weight layout; the data axis absorbs the change), the data
  size cut to one that divides the global batch (:func:`usable_dp`);
* :func:`make_elastic_mesh` lays that grid over the first data·model of the
  ranks (``launch.mesh.make_mesh``: every process of the world calls it, and
  the ones left out get None);
* :func:`reshard` cuts a full tree to this rank's shards under the new
  placements (``planner.shard_tree``); with ``CheckpointManager.restore``'s
  placements the same path restores a checkpoint onto the new mesh.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple


def usable_dp(n_avail_dp: int, global_batch: int) -> int:
    """Largest dp ≤ n_avail_dp dividing global_batch (keeps per-replica batch whole)."""
    for dp in range(min(n_avail_dp, global_batch), 0, -1):
        if global_batch % dp == 0:
            return dp
    return 1


def plan_mesh_shape(n_devices: int, model_parallel: int,
                    global_batch: Optional[int] = None) -> Tuple[int, int]:
    """(data, model) for the surviving rank count; model axis held fixed."""
    if n_devices < model_parallel:
        raise ValueError(
            f"cannot keep tp={model_parallel} with {n_devices} devices — "
            f"weight layout requires at least one full model-parallel group")
    dp = n_devices // model_parallel
    if global_batch is not None:
        dp = usable_dp(dp, global_batch)
    return dp, model_parallel


def make_elastic_mesh(ranks: Sequence[int], model_parallel: int,
                      global_batch: Optional[int] = None):
    """A (data, model) mesh over the first data·model of the surviving world
    ``ranks`` (``launch.mesh.Mesh``; None on a rank left out). Every process of
    the world calls it."""
    from repro_torch.launch.mesh import make_mesh

    dp, tp = plan_mesh_shape(len(ranks), model_parallel, global_batch)
    return make_mesh(dp, tp, ranks=tuple(sorted(ranks))[:dp * tp])


def reshard(tree, placements, mesh):
    """This rank's shards of the full ``tree`` under ``placements`` on ``mesh``
    (e.g. a ``TrainLayout``'s for the new mesh)."""
    from repro_torch.sharding import planner

    return planner.shard_tree(tree, placements, mesh)
