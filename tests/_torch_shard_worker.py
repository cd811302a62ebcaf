"""Cases, serving and the per-rank worker of tests/test_torch_sharded_serving.py.

A module of its own, importing torch and the port only: every spawned rank
imports it (and not the test module, which imports the JAX reference).
"""
import dataclasses
import datetime
import pickle
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
        "llama": "llama4-scout-17b-a16e", "mamba": "mamba2-130m", "zamba": "zamba2-1.2b"}
#: a prepared W4A8 g32 tree (the smoke widths' groups) served on the integer path
W4 = dataclasses.replace(tql.W4A8_G128, mode="int8", w_group=32)
QUANTS = {"fake": tql.W8A8_CROSSQUANT, "int8": tql.W8A8_INT8, "w4": W4}


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


def case(arch="sc", path="fused-int8", kv="int8", prompts="mixed", tier=None, moe_mode=None,
         **extra):
    """A serving case: the tree (raw for fake, prepared int8 otherwise), path, KV
    mode, workload, extra ``EngineConfig`` fields, a forced tier and a forced MoE
    mode."""
    tree, quant = ("raw", "fake") if path == "fake" else ("int8", "int8")
    return dict(arch=arch, tree=tree, quant=quant, path=path, kv=kv, prompts=prompts,
                extra=extra, tier=tier, moe_mode=moe_mode)


def combos(**kw):
    """The dense and paged (shared-prefix radix hits) fake / dequant-fp / fused-int8
    × fp / int8 KV matrix."""
    return {**{f"dense-{p}-{k}": case(path=p, kv=k, **kw) for p, k in COMBOS},
            **{f"paged-{p}-{k}": case(path=p, kv=k, prompts="shared", cache_layout="paged",
                                      page_size=8, **kw) for p, k in COMBOS}}


W4_CASE = dict(case(), tree="w4", quant="w4")
#: mamba2 / zamba2 fused-int8 at tp=2: the state heads over "model"
SSM = {f"{a}-{lay}-{k}": case(arch=a, kv=k, **({} if lay == "dense" else dict(
           cache_layout="paged", page_size=8, prefix_reuse=False)))
       for a in ("mamba", "zamba") for lay in ("dense", "paged") for k in ("fp", "int8")}
#: granite with its experts forced to expert-internal TP (d_ff_expert over "model")
ETP = {"granite-etp-fused-int8-int8": case(arch="granite", moe_mode="expert_tp"),
       "granite-etp-fake-fp": case("granite", "fake", "fp", moe_mode="expert_tp"),
       "granite-etp-int8-raw": dict(case("granite", moe_mode="expert_tp"), tree="raw")}


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
       **{f"{a}-ep-model": case(arch=a) for a in ("granite", "llama")},
       "w4a8-fused-int8-int8": W4_CASE, **ETP, **SSM,
       # tier dp_only: the model axis folds into data parallelism (the slots over
       # (data, model), the weights whole)
       "dp_only-fused-int8-int8": case(tier="dp_only")}
TP4 = {f"dense-{p}-{k}": case(path=p, kv=k) for p, k in COMBOS}
MOE = {f"{a}-fused-int8-int8": case(arch=a) for a in ("granite", "llama")}
# granite's raw tree under mode="int8": the experts prepared on the fly each step
EP2 = {**MOE, "granite-fake-fp": case("granite", "fake", "fp"),
       "granite-int8-raw": dict(case("granite"), tree="raw")}
#: data-parallel slots (B = 2 over data 2): the matrix splits its slots except the
#: fake path and the MoE, whose rows share a statistic and replicate
DP2 = {**combos(), "granite-fused-int8-int8": case(arch="granite")}
DP2XTP2 = {**combos(), "w4a8-fused-int8-int8": W4_CASE}
#: mesh name -> (dims, cases); one spawn per world size serves its meshes in turn
MESHES = {"tp2": ((1, 2), TP2), "ep2": ((1, 1, 2), EP2), "dp2": ((2, 1), DP2),
          "tp4": ((1, 4), TP4), "tp2xep2": ((1, 2, 2), MOE), "dp2xtp2": ((2, 2), DP2XTP2)}
WORLDS = {2: ("tp2", "ep2", "dp2"), 4: ("tp4", "tp2xep2", "dp2xtp2")}
#: what a sharded case is held against: the single-device run of another case
BASELINE = {"spec4": "spec4-single", "chunked": "chunked-single",
            "granite-ep-model": "granite-fused-int8-int8",
            "llama-ep-model": "llama-fused-int8-int8",
            "tp_ffn-fused-int8-int8": "dense-fused-int8-int8",
            "dp_only-fused-int8-int8": "dense-fused-int8-int8",
            "tp_ffn-fake-fp": "dense-fake-fp",
            "granite-etp-fused-int8-int8": "granite-fused-int8-int8",
            "granite-etp-fake-fp": "granite-fake-fp",
            "granite-etp-int8-raw": "granite-int8-raw"}
SINGLE = {**TP2, **TP4, **EP2,
          "spec4-single": case(prompts="spec", cache_layout="paged", page_size=8),
          "chunked-single": case(path="dequant-fp", kv="fp", prompts="shared",
                                 cache_layout="paged", page_size=8)}


def plan_of(c, mesh):
    """The case's forced plan on ``mesh``, or None (the engine's own)."""
    if not (c["tier"] or c["moe_mode"]):
        return None
    plan = SP.make_serve_plan(cfg_of(c["arch"]), mesh, force_tier=c["tier"])
    return dataclasses.replace(plan, moe_mode=c["moe_mode"]) if c["moe_mode"] else plan


def weight_share(eng, trees, c):
    """The elements of a rank's params tree over the full tree's."""
    def n(t):
        if isinstance(t, dict):
            return sum(n(v) for k, v in t.items() if k != "occ")
        if isinstance(t, list):
            return sum(n(v) for v in t)
        return t.size if isinstance(t, np.ndarray) else t.numel()
    return n(eng.params) / n(trees[c["arch"]][c["tree"]])


def serve(trees, c, mesh=None, plan=None):
    """Serve case ``c`` on the numpy ``trees``; returns (tokens by rid, engine
    counters, the logits every sampler call saw (numpy), the plan or None, the
    rank's share of the tree's elements)."""
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
            None if eng.plan is None else eng.plan.describe(), weight_share(eng, trees, c))


def worker(rank, world, port, trees_file, queue):
    """One rank: load the trees, join the gloo world, then serve every case of
    each of the world size's meshes; report (rank, "ok", {mesh: {case: result +
    counts}}) or the traceback."""
    try:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_debug_mesh
        torch.set_num_threads(1)
        with open(trees_file, "rb") as f:
            trees = pickle.load(f)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        out = {}
        for name in WORLDS[world]:
            dims, cases = MESHES[name]
            mesh = make_debug_mesh(*dims)
            out[name] = {}
            for key, c in cases.items():
                SC.reset_counts()
                r = serve(trees, c, mesh, plan_of(c, mesh))
                out[name][key] = r[:4] + (dict(SC.COUNTS), r[4])
        queue.put((rank, "ok", out))
        dist.destroy_process_group()
    except Exception:
        queue.put((rank, "error", traceback.format_exc()))
        raise
