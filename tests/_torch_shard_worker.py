"""Cases, serving and the per-rank worker of tests/test_torch_sharded_serving.py.

A module of its own, importing torch and the port only: every spawned rank
imports it (and not the test module, which imports the JAX reference).
"""
import dataclasses
import datetime
import traceback

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get as tget
from repro_torch.core import qlinear as tql
from repro_torch.serving import engine as TE
from repro_torch.serving.config import EngineConfig
from repro_torch.sharding import collectives as SC
from repro_torch.sharding import planner as SP

LENS, MAX_NEW = [4, 7, 12, 9], [4, 3, 5, 2]        # tests/test_sharded_serving.py
PMAX_NEW, SMAX_NEW = [4, 3, 5, 4], [16, 12, 20]
COMBOS = [("fake", "fp"), ("fake", "int8"), ("dequant-fp", "fp"), ("dequant-fp", "int8"),
          ("fused-int8", "fp"), ("fused-int8", "int8")]
ARCH = {"sc": "starcoder2-7b", "granite": "granite-moe-3b-a800m",
        "llama": "llama4-scout-17b-a16e"}
QUANTS = {"fake": tql.W8A8_CROSSQUANT, "int8": tql.W8A8_INT8}


def cfg_of(arch):
    return dataclasses.replace(tget(ARCH[arch], smoke=True), dtype="float32")


def prompts_of(arch, kind):
    """The reference file's workloads: mixed lengths, shared prefixes, motifs."""
    vocab = cfg_of(arch).vocab
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, vocab, size=n).astype(np.int32) for n in LENS]
    if kind == "mixed":
        return prompts, MAX_NEW
    shared = rng.integers(1, vocab, size=16).astype(np.int32)
    pprompts = prompts[:2] + [np.concatenate([shared, rng.integers(
        1, vocab, size=4 + i).astype(np.int32)]) for i in range(2)]
    if kind == "shared":
        return pprompts, PMAX_NEW
    motif = rng.integers(1, vocab, size=4).astype(np.int32)
    return [np.tile(motif, 3), pprompts[1], np.tile(motif[:3], 2)], SMAX_NEW


def case(arch="sc", path="fused-int8", kv="int8", prompts="mixed", tier=None, **extra):
    """A serving case: the tree (raw for fake, prepared int8 otherwise), path, KV
    mode, workload, extra ``EngineConfig`` fields and a forced tier."""
    tree, quant = ("raw", "fake") if path == "fake" else ("int8", "int8")
    return dict(arch=arch, tree=tree, quant=quant, path=path, kv=kv, prompts=prompts,
                extra=extra, tier=tier)


TP2 = {**{f"dense-{p}-{k}": case(path=p, kv=k) for p, k in COMBOS},
       "sparse-2:4": case(sparsity="2:4"),
       **{f"paged-{p}-{k}": case(path=p, kv=k, prompts="shared", cache_layout="paged",
                                 page_size=8) for p, k in COMBOS},
       "spec4": case(prompts="spec", cache_layout="paged", page_size=8, speculate=4),
       "chunked": case(path="dequant-fp", kv="fp", prompts="shared", cache_layout="paged",
                       page_size=8, chunked=True, token_budget=10),
       "tp_ffn-fused-int8-int8": case(tier="tp_ffn"),
       "tp_ffn-fake-fp": case(path="fake", kv="fp", tier="tp_ffn"),
       "sampled": case(temperature=0.7, top_k=8),
       # experts over "model" (moe_mode "ep": E divides tp, no expert axis), the
       # attention tp_full and llama4's shared expert column/row-parallel beside them
       **{f"{a}-ep-model": case(arch=a) for a in ("granite", "llama")}}
TP4 = {f"dense-{p}-{k}": case(path=p, kv=k) for p, k in COMBOS}
MOE = {f"{a}-fused-int8-int8": case(arch=a) for a in ("granite", "llama")}
# granite's raw tree under mode="int8": the experts prepared on the fly each step
EP2 = {**MOE, "granite-fake-fp": case("granite", "fake", "fp"),
       "granite-int8-raw": dict(case("granite"), tree="raw")}
#: mesh name -> (dims, cases); one spawn per world size serves its meshes in turn
MESHES = {"tp2": ((1, 2), TP2), "ep2": ((1, 1, 2), EP2),
          "tp4": ((1, 4), TP4), "tp2xep2": ((1, 2, 2), MOE)}
WORLDS = {2: ("tp2", "ep2"), 4: ("tp4", "tp2xep2")}
#: what a sharded case is held against: the single-device run of another case
BASELINE = {"spec4": "spec4-single", "chunked": "chunked-single",
            "granite-ep-model": "granite-fused-int8-int8",
            "llama-ep-model": "llama-fused-int8-int8",
            "tp_ffn-fused-int8-int8": "dense-fused-int8-int8",
            "tp_ffn-fake-fp": "dense-fake-fp"}
SINGLE = {**TP2, **TP4, **EP2,
          "spec4-single": case(prompts="spec", cache_layout="paged", page_size=8),
          "chunked-single": case(path="dequant-fp", kv="fp", prompts="shared",
                                 cache_layout="paged", page_size=8)}


def serve(trees, c, mesh=None, plan=None):
    """Serve case ``c`` on the numpy ``trees``; returns (tokens by rid, engine
    counters, the logits every sampler call saw (numpy), the plan or None)."""
    cfg = cfg_of(c["arch"])
    params = convert.params_from_numpy(trees[c["arch"]][c["tree"]], device="cpu")
    prompts, max_new = prompts_of(c["arch"], c["prompts"])
    seen = []
    make = TE._make_sampler

    def recording(temperature, top_k):
        inner = make(temperature, top_k)

        def sample(logits, gen):
            seen.append(logits.numpy().copy())
            return inner(logits, gen)
        return sample

    TE._make_sampler = recording
    try:
        config = EngineConfig(batch_size=2, max_len=32, path=c["path"], kv_cache=c["kv"],
                              **c["extra"])
        eng = TE.ServeEngine(cfg, params, config=config, quant=QUANTS[c["quant"]],
                             device="cpu", mesh=mesh, plan=plan)
        eng.submit([p.copy() for p in prompts], max_new=list(max_new))
        done = eng.run()
    finally:
        TE._make_sampler = make
    return ({r.rid: r.out for r in done}, dict(eng.counters), seen,
            None if eng.plan is None else eng.plan.describe())


def worker(rank, world, port, trees, queue):
    """One rank: join the gloo world, then serve every case of each of the world
    size's meshes; report (rank, "ok", {mesh: {case: result + counts}}) or the
    traceback."""
    try:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_debug_mesh
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        out = {}
        for name in WORLDS[world]:
            dims, cases = MESHES[name]
            mesh = make_debug_mesh(*dims)
            out[name] = {}
            for key, c in cases.items():
                plan = (SP.make_serve_plan(cfg_of(c["arch"]), mesh, force_tier=c["tier"])
                        if c["tier"] else None)
                SC.reset_counts()
                out[name][key] = serve(trees, c, mesh, plan) + (dict(SC.COUNTS),)
        queue.put((rank, "ok", out))
        dist.destroy_process_group()
    except Exception:
        queue.put((rank, "error", traceback.format_exc()))
        raise
