"""Async checkpoint manager (port of ``repro/checkpoint/manager.py``), with the
reference's on-disk layout, so each manager reads the other's params checkpoints:

    ckpt_dir/
      step_000042/
        manifest.json        # step; per leaf its shape, dtype and crc32
        arrays.npz           # flattened { "a/b/0/w": array } archive
      step_000042.tmp/       # staging dir, renamed atomically on commit
      LATEST                 # text file naming the last committed step

* **Atomic commit**: the arrays and then the manifest land in ``.tmp``, which is
  renamed into place; LATEST is replaced after it. A crash mid-write never leaves
  a half-written step that LATEST names.
* **Async save**: ``save()`` copies every leaf to host memory before it returns
  (training may go on updating the tree in place at once) and hands the disk
  I/O to a writer thread; writes commit in the order of the saves, and
  ``wait()`` joins the outstanding ones.
* **Integrity**: every leaf's bytes carry a crc32, checked on restore.
* **keep_n GC**: committed steps beyond the retention window are deleted after a
  successful commit, never before.
* **Elastic restore**: a sharded state (``placements=`` and ``mesh=``, e.g.
  ``TrainLayout.state_placements``) is saved as the unsharded logical tree: every
  rank of the mesh joins the gathers and the rank at the mesh's origin writes.
  ``restore`` with placements returns this rank's shards of the logical arrays
  on any mesh, so a step saved at data 2 restores on one device and the
  reverse.

Leaf keys are the tree's path joined by ``/``: dict keys, list indices, and for an
:class:`~repro_torch.training.optimizer.OptState` its field names (``opt/step``,
``opt/m/...``, ``opt/v/...``: the port's own layout for the optimizer state; the
reference's keys for its ``OptState`` differ). A bf16 leaf is stored as 2-byte
void records with manifest dtype ``bfloat16``, which is how the reference's npz
holds an ``ml_dtypes`` bf16 array.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch


def _path_items(tree, prefix: str = ""):
    """(key, leaf) pairs of a nested dict/list/NamedTuple tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _path_items(v, f"{prefix}/{k}" if prefix else str(k))


def _rebuild(template, fn, prefix: str = ""):
    """``template``'s structure with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(template, dict):
        return {k: _rebuild(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(v, fn, f"{prefix}/{k}" if prefix else k)
                                for k, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, fn, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(template))
    return fn(prefix, template)


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf (bf16 as 2-byte void records)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.array(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _from_host(arr: np.ndarray, dtype: str, like, device):
    """A restored array placed as ``like`` is: a tensor on ``device`` (or on
    ``like``'s device), or a numpy array."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.asarray(arr, order="C").view(np.int16)).view(torch.bfloat16)
    elif isinstance(like, torch.Tensor) or device is not None:
        t = torch.from_numpy(np.asarray(arr, order="C"))
    else:
        return arr
    dev = device if device is not None else (like.device if isinstance(like, torch.Tensor)
                                             else "cpu")
    return t.to(dev)


def _spec_items(tree, placements, prefix: str = ""):
    """(key, leaf, placement) triples: ``tree``'s structure leads (a placement is a
    tuple, which only the tree's leaf positions mark as one)."""
    if isinstance(tree, dict):
        items = ((k, tree[k], placements[k]) for k in tree)
    elif isinstance(tree, (list, tuple)):
        names = tree._fields if hasattr(tree, "_fields") else range(len(tree))
        items = zip(names, tree, placements)
    else:
        yield prefix, tree, placements
        return
    for k, v, p in items:
        yield from _spec_items(v, p, f"{prefix}/{k}" if prefix else str(k))


def _split(spec, mesh) -> bool:
    axes = [a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)]
    return any(mesh.axis_size(a) > 1 for a in axes)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_n: int = 3, placements=None, mesh=None):
        """``placements`` and ``mesh``: the default layout of a sharded state, for
        callers that save and restore without naming one (the ``Supervisor``)."""
        self.dir = directory
        self.keep_n = keep_n
        self.placements, self.mesh = placements, mesh
        os.makedirs(directory, exist_ok=True)
        self._pending: List[threading.Thread] = []
        self._lock = threading.Lock()

    def _sharded(self, placements, mesh):
        placements = self.placements if placements is None else placements
        mesh = self.mesh if mesh is None else mesh
        return (placements, mesh) if placements is not None and mesh is not None \
            and mesh.size > 1 else (None, None)

    # -- save --------------------------------------------------------------------------

    def save(self, step: int, tree, *, blocking: bool = False, placements=None,
             mesh=None) -> None:
        """Snapshot ``tree`` at ``step``: host copies now, the write on a thread
        (joined here when ``blocking``). With ``placements`` on ``mesh``, ``tree``
        is this rank's shards: every rank of the mesh calls this, the logical
        leaves are gathered (``planner.unshard_tree``) and the rank at the mesh's
        origin writes them."""
        placements, mesh = self._sharded(placements, mesh)
        if placements is None:
            flat = {k: _to_host(v) for k, v in _path_items(tree)}
        else:
            flat = self._gather(tree, placements, mesh)
            if any(mesh.coords.values()):
                if blocking:
                    self.wait()
                return
        with self._lock:
            prev = self._pending[-1] if self._pending else None
            t = threading.Thread(target=self._write, args=(step, flat, prev), daemon=True)
            self._pending.append(t)
            t.start()
        if blocking:
            self.wait()

    @staticmethod
    def _gather(tree, placements, mesh) -> Dict[str, np.ndarray]:
        """Host copies of the logical leaves of the shards ``tree`` (a collective
        over the mesh)."""
        import torch.distributed as dist

        from repro_torch.sharding import planner

        flat = {}
        for key, leaf, spec in _spec_items(tree, placements):
            if isinstance(leaf, torch.Tensor) and _split(spec, mesh):
                src = leaf.detach().contiguous()
                pieces = [torch.empty_like(src) for _ in range(mesh.size)]
                dist.all_gather(pieces, src, group=mesh.group)
                leaf = planner.unshard_tree(pieces, spec, dict(mesh.shape))
            flat[key] = _to_host(leaf)
        return flat

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               prev: Optional[threading.Thread]) -> None:
        if prev is not None:        # commit in save order: LATEST names the last save
            prev.join()
        name = f"step_{step:09d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": _dtype_name(v),
                           "crc32": _crc32(v)} for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)                       # atomic commit
        latest_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(name)
        os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()

    def wait(self) -> None:
        """Join the outstanding writes (on a mesh, every rank's: the writer's)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for t in pending:
            t.join()
        _, mesh = self._sharded(self.placements, self.mesh)
        if mesh is not None:
            import torch.distributed as dist
            dist.barrier(group=mesh.group)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)

    # -- restore -----------------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if os.path.exists(path):
            with open(path) as f:
                name = f.read().strip()
            if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                return int(name[5:])
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, *, step: Optional[int] = None, device=None,
                verify: bool = True, placements=None, mesh=None):
        """Load the committed ``step`` (default: the latest) into the structure of
        ``template``. Returns (tree, step). A tensor leaf comes back on ``device``,
        or on its template leaf's device; a numpy leaf as numpy (on ``device`` as a
        tensor when one is given). With ``placements`` on ``mesh`` each leaf is
        this rank's shard of the saved logical array (``planner.shard_tree``):
        elastic restore onto any mesh."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        if verify:
            for k, meta in manifest["leaves"].items():
                got = _crc32(flat[k])
                if got != meta["crc32"]:
                    raise IOError(f"checkpoint corruption at leaf {k!r} "
                                  f"(crc {got} != {meta['crc32']})")
        dev = None if device is None else torch.device(device)

        def load(key, like):
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            return _from_host(flat[key], manifest["leaves"][key]["dtype"], like, dev)

        tree = _rebuild(template, load)
        placements, mesh = self._sharded(placements, mesh)
        if placements is not None:
            from repro_torch.sharding import planner
            cut = {k: planner.shard_tree(v, spec, mesh)
                   for k, v, spec in _spec_items(tree, placements)}
            tree = _rebuild(template, lambda key, _: cut[key])
        return tree, step
