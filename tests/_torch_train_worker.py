"""Cases and the per-rank worker of tests/test_torch_sharded_training.py.

A module of its own, importing torch and the port only: every spawned rank
imports it (and not the test module, which imports the JAX reference).
"""
import dataclasses
import datetime
import os
import pickle
import traceback

import torch

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get as tget
from repro_torch.data import make_train_batches
from repro_torch.models.model import leaves, map_tensors
from repro_torch.sharding import collectives as SC
from repro_torch.sharding import planner as SP
from repro_torch.training import compression as TC, optimizer as TO, trainer as TT

ARCH = {"sc": "starcoder2-7b", "granite": "granite-moe-3b-a800m", "mamba": "mamba2-130m"}
OPT = dict(lr=5e-3, warmup_steps=2, total_steps=40)
STEPS, N_MICRO, SEQ = 2, 2, 32


def cfg_of(arch):
    return dataclasses.replace(tget(ARCH[arch], smoke=True), dtype="float32")


def case(arch="sc", dims=(2, 1), tier=None, compress=False):
    """A training case: the arch, the (data, model) mesh, a forced tier and
    gradient compression. Its global batch is 2 rows for each of the n_micro
    microbatches' data ranks."""
    dp = dims[0] * (dims[1] if tier == "dp_only" else 1)
    return dict(arch=arch, dims=dims, tier=tier, compress=compress, batch=2 * N_MICRO * dp)


CASES = {
    "sc-data2": case(), "granite-data2": case("granite"), "mamba-data2": case("mamba"),
    "sc-data2-compress": case(compress=True),
    "sc-model2": case(dims=(1, 2)), "granite-model2": case("granite", dims=(1, 2)),
    "sc-data2xmodel2": case(dims=(2, 2)), "sc-data2xmodel2-dp_only": case(
        dims=(2, 2), tier="dp_only"),
}
WORLDS = {2: [k for k, c in CASES.items() if c["dims"] in ((2, 1), (1, 2))],
          4: [k for k, c in CASES.items() if c["dims"] == (2, 2)]}
#: the elastic case: sc-data2's 2 steps end in a checkpoint of the logical arrays
ELASTIC = "sc-data2"
#: the launcher's supervised run at data 2: a failure at step 3, a checkpoint every 2
LAUNCH = dict(steps=4, global_batch=4, seq_len=SEQ, n_micro=N_MICRO, ckpt_every=2,
              log_every=100, device="cpu")


def token_groups(c) -> int:
    """The grouped dispatch's G one device runs for the case: the data axes' size."""
    return c["dims"][0] * (c["dims"][1] if c["tier"] == "dp_only" else 1)


def batches(c, steps=STEPS):
    f = make_train_batches(cfg_of(c["arch"]).vocab, SEQ, c["batch"], seed=3)
    return [f(s) for s in range(steps)]


def opt_cfg():
    return TO.AdamWConfig(**OPT)


def _numpy_state(layout, params, opt, err):
    """Copies of the gathered state (a replicated leaf of ``unshard`` is the live
    shard, which the next step updates in place)."""
    host = lambda tree: convert.params_to_numpy(map_tensors(tree, torch.clone))  # noqa: E731
    out = {"params": host(layout.unshard(params)), "m": host(layout.unshard(opt.m)),
           "v": host(layout.unshard(opt.v)), "step": int(opt.step)}
    if err is not None:
        out["err"] = host(err)
    return out


def train(trees, c, mesh, steps=STEPS, ckpt_dir=None):
    """Case ``c`` on ``mesh`` for ``steps`` steps from the numpy tree: each step's
    metrics and the unsharded state after it (rank 0's copy), the counts, the
    plan and the share of the elements a rank stores."""
    cfg = cfg_of(c["arch"])
    plan = SP.make_plan(cfg, SP.ShapeConfig(name="train", seq_len=0, global_batch=0,
                                            kind="train"), mesh, force_tier=c["tier"])
    comp = TC.CompressionConfig() if c["compress"] else None
    step = TT.make_train_step(cfg, opt_cfg(), n_micro=N_MICRO, compression=comp, mesh=mesh,
                              plan=plan)
    layout = step.layout
    params = layout.shard(convert.params_from_numpy(trees[c["arch"]], device="cpu"))
    opt = TO.init(params)
    err = layout.init_error_state("cpu") if comp else None
    share = (sum(t.numel() for t in leaves(params))
             / sum(t.numel() for t in leaves(layout.template)))
    out = []
    SC.reset_counts()
    for b in batches(c, steps):
        b = {k: torch.as_tensor(v) for k, v in b.items()}
        if comp:
            params, opt, err, m = step(params, opt, err, b)
        else:
            params, opt, m = step(params, opt, b)
        out.append(({k: float(v) for k, v in m.items()}, _numpy_state(layout, params, opt,
                                                                        err)))
    counts = dict(SC.COUNTS)
    if ckpt_dir is not None:
        ckpt = CheckpointManager(ckpt_dir, keep_n=1)
        state = {"params": params, "opt": opt}
        ckpt.save(steps, state, blocking=True, placements=layout.state_placements(state),
                  mesh=mesh)
    return out, counts, plan.describe(), share


def elastic_mesh(trees):
    """World 4: the mesh rebuilt over the 3 survivors of rank 3 at a global batch
    of 4 (data 2, model 1 over ranks 0 and 1; ranks 2 and 3 are left out), the
    full params cut to its shards (``reshard``) and gathered back, and one train
    step on it."""
    import torch.distributed as dist

    from repro_torch.runtime.elastic import make_elastic_mesh, reshard

    mesh = make_elastic_mesh([0, 1, 2], model_parallel=1, global_batch=4)
    if mesh is None:
        return None
    cfg = cfg_of("sc")
    step = TT.make_train_step(cfg, opt_cfg(), n_micro=N_MICRO, mesh=mesh)
    layout = step.layout
    full = convert.params_from_numpy(trees["sc"], device="cpu")
    shards = reshard(full, layout.placements, mesh)
    back = layout.unshard(shards)
    b = {k: torch.as_tensor(v) for k, v in batches(CASES[ELASTIC], 1)[0].items()}
    _, _, m = step(shards, TO.init(shards), b)
    same = all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(full)))
    return dict(shape=dict(mesh.shape), rank=mesh.rank, roundtrip=same,
                loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                group_size=dist.get_world_size(mesh.group))


def launch(mesh, ckpt_dir):
    """``launch.train.run`` at data 2 with a failure at step 3 and without: the
    restarts and whether the final params (gathered) are bitwise equal."""
    from repro_torch.launch.train import run
    from repro_torch.training.layout import train_layout

    cfg = cfg_of("sc")
    runs = [run(cfg, ckpt_dir=os.path.join(ckpt_dir, name), fail_at=fail, mesh=mesh,
                **LAUNCH) for name, fail in (("faulty", (3,)), ("clean", ()))]
    layout = train_layout(cfg, mesh)
    a, b = (layout.unshard(r.state["params"]) for r in runs)
    return dict(restarts=[r.restarts for r in runs],
                steps=[[h["step"] for h in r.metrics_history] for r in runs],
                bitwise=all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b))),
                loss=runs[1].metrics_history[-1]["loss"])


def worker(rank, world, port, trees_file, ckpt_dir, queue):
    """One rank: join the gloo world, then train every case of the world size's
    meshes (sc-data2 ends in the elastic case's checkpoint; the world of 2 also
    runs the launcher's supervised restart, the world of 4 the elastic mesh);
    report (rank, "ok", results) or the traceback."""
    try:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_debug_mesh
        with open(trees_file, "rb") as f:
            trees = pickle.load(f)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        out = {}
        for key in WORLDS[world]:
            c = CASES[key]
            out[key] = train(trees, c, make_debug_mesh(*c["dims"]), ckpt_dir=os.path.join(
                ckpt_dir, "elastic") if key == ELASTIC else None)
        if world == 2:
            out["launch"] = launch(make_debug_mesh(2, 1), os.path.join(ckpt_dir, "launch"))
        else:
            out["elastic-mesh"] = elastic_mesh(trees)
        queue.put((rank, "ok", out))
        dist.destroy_process_group()
    except Exception:
        queue.put((rank, "error", traceback.format_exc()))
        raise
