"""Sharded serving of the port on the CPU: gloo worlds of 2 and 4 processes against
the single-device engine, token-exact on every mode of the reference's sharded
matrix (tests/test_sharded_serving.py), logits bitwise on the fused-int8 path.

One spawn per world size (2 and 4 processes), every mesh of that size and every
case of each mesh served in it (tests/_torch_shard_worker.py):

* tp=2 (``tp_full`` on the smoke config's 4/2 heads): fake / dequant-fp /
  fused-int8 × fp / int8 KV on the dense layout, 2:4 fused-int8, the paged
  layout with shared-prefix radix hits on all six, ``speculate=4`` through the
  paged fused-int8 int8-KV path, chunked (dequant-fp, fp KV, budget 10), and a
  forced ``tp_ffn`` plan;
* tp=4 (``tp_kv_rep``: 4 query heads divide, 2 kv heads do not): the dense matrix;
* ep=2 (``expert_axis``) and tp2×ep2 on granite-moe and llama4-scout: fused-int8
  int8 KV (and fake, and the raw tree prepared on the fly, on granite at ep=2);
  at tp=2 both also place their experts over "model" (``ep``);
* tp=2 also serves a W4A8 g32 tree (K8's group-acc partials gathered), granite
  with its plan forced to ``expert_tp`` (fused-int8, fake, the raw tree prepared
  on the fly) and mamba2 / zamba2 (state heads over "model"), dense and paged, fp
  and int8 KV;
* data parallelism: dp2 (data 2, model 1) and dp2xtp2 (2, 2), the dense and paged
  fake / dequant-fp / fused-int8 × fp / int8 KV matrix (B = 2: one slot per data
  rank; the fake path's rows share a statistic and replicate), granite at dp2
  (replicated, an MoE), W4A8 at dp2xtp2.

Each rank records the logits its sampler sees; the fused-int8 ones must equal the
single-device engine's bit for bit at tp=2, ep=2, tp2×ep2, dp2 and dp2xtp2 on
the dense layout, and for W4A8, ``expert_tp`` and mamba2 / zamba2 at tp=2 (at
tp=4 a rank's GQA group is one query head, not two, and the CPU's batched
attention product rounds that shape differently: token-exact there; under a
data axis the paged layout keeps the single device's allocator and radix index
and a whole pool on every rank, each call's K/V rows exchanged, so its prefix
hits, pages and fused-int8 logits are the single device's). The
fused-int8 int8-KV tokens also equal the JAX reference engine's: dense at tp=2,
tp=4 and dp2xtp2, paged with prefix hits, speculative, ``tp_ffn``, W4A8, the MoE
at ep=2, tp2×ep2, experts over "model" and ``expert_tp``, mamba2 and zamba2.
The typed refusals left (W4A8 whose groups do not split with its rows, a W4
expert stack under ``expert_tp``, a forced ``expert_tp`` whose d_ff_expert does
not split) are raised before any collective, in this process.
"""
import atexit
import dataclasses
import functools
import multiprocessing
import os
import pickle
import socket
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.config import EngineConfig as JEngineConfig  # noqa: E402

import _torch_shard_worker as W  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import quantize as TMQ  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402
from repro_torch.sharding import planner as SP  # noqa: E402


@functools.lru_cache(maxsize=None)
def _jax_trees():
    """The smoke trees as numpy, served by both engines: initialised and quantized
    by the port (its ``init_params`` takes a fraction of a second where the
    reference's, jitted leaf by leaf, takes seconds; its ``quantize_tree`` is the
    reference's, held leaf for leaf in tests/test_torch_lowbit.py,
    test_torch_moe.py and test_torch_hybrid.py), W8A8 for every arch and W4A8 g32
    for starcoder2."""
    out = {}
    for arch in W.ARCH:
        raw = TM.init_params(torch.Generator().manual_seed(0 if arch == "sc" else 1),
                             W.cfg_of(arch), device="cpu")
        out[arch] = {"raw": convert.params_to_numpy(raw),
                     "int8": convert.params_to_numpy(TMQ.quantize_tree(raw, tql.W8A8_INT8))}
        if arch == "sc":
            out[arch]["w4"] = convert.params_to_numpy(TMQ.quantize_tree(raw, W.W4))
    return out


_JW4 = dataclasses.replace(jql.W4A8_G128, mode="int8", w_group=32)


@functools.lru_cache(maxsize=None)
def _trees_file():
    """The trees in a file the ranks load: a spawned child reads its arguments
    only after it has imported torch, so large ones would start the ranks one by
    one."""
    fd, path = tempfile.mkstemp(prefix="torch_shard_trees_", suffix=".pkl")
    atexit.register(os.remove, path)
    with os.fdopen(fd, "wb") as f:
        pickle.dump(_jax_trees(), f)
    return path


@functools.lru_cache(maxsize=None)
def _spawned():
    """Every world of ``W.WORLDS``, spawned at once so that they overlap on the
    CPU: {size: (processes, result queue)}. A world nobody collects is killed at
    exit (its ranks would block flushing their results). The JAX reference
    engines start on threads beside them (:func:`_jax_references`)."""
    ctx = multiprocessing.get_context("spawn")
    out = {}
    for size in W.WORLDS:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        queue = ctx.Queue()
        procs = [ctx.Process(target=W.worker, args=(r, size, port, _trees_file(), queue))
                 for r in range(size)]
        for p in procs:
            p.start()
        out[size] = (procs, queue)
    atexit.register(lambda: [p.kill() for procs, _ in out.values() for p in procs
                             if p.is_alive()])
    _jax_references()
    return out


@functools.lru_cache(maxsize=None)
def _world(size):
    """The world of ``size`` ranks' results; {rank: {mesh: {case: result}}}."""
    procs, queue = _spawned()[size]
    try:
        results = {}
        for _ in range(size):
            rank, status, payload = queue.get(timeout=600)
            assert status == "ok", f"rank {rank} failed:\n{payload}"
            results[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return results


def _mesh_results(name):
    size = next(n for n, names in W.WORLDS.items() if name in names)
    return {rank: res[name] for rank, res in _world(size).items()}


@functools.lru_cache(maxsize=None)
def _single(key):
    torch.set_num_threads(2)
    return W.serve(_jax_trees(), W.SINGLE[key])


CASES = [(m, c) for m, (_, cases) in W.MESHES.items() for c in cases]


@pytest.mark.parametrize("mesh,case", CASES, ids=[f"{m}-{c}" for m, c in CASES])
def test_sharded_tokens_equal_single_device(mesh, case):
    want = _single(W.BASELINE.get(case, case))[0]
    dims, cases = W.MESHES[mesh]
    for rank, res in _mesh_results(mesh).items():
        got, counters, _, plan, counts, share = res[case]
        assert got == want, (mesh, case, rank, got, want)
        assert plan["tp"] == dims[1] and plan["ep"] == (dims[2] if len(dims) == 3 else 1)
        assert plan["dp"] == dims[0] * (dims[1] if plan["tier"] == "dp_only" else 1)
        extra = cases[case]["extra"]
        if extra.get("cache_layout") != "paged":
            assert counters["mid_decode_admissions"] > 0
        if case.startswith("paged"):
            assert counters["prefix_hits"] > 0
        if cases[case]["moe_mode"]:
            assert plan["moe_mode"] == cases[case]["moe_mode"]
        if dims[0] > 1 and "fake" not in case and "granite" not in case:
            assert counts["gather_slots"] > 0                    # the slots split
        if dims[0] > 1 and ("fake" in case or "granite" in case):
            assert counts["gather_slots"] == 0                   # coupled rows replicate
        if dims[1] > 1 and (case.startswith(("w4a8", "granite-etp", "mamba", "zamba"))):
            assert 0.5 <= share < 0.52, (case, share)            # half the weights
        if extra.get("speculate"):
            assert counters["spec_accepted"] > 0
        if extra.get("chunked"):
            assert counters["chunk_prefill_rows"] > 0
        if cases[case]["tier"]:
            assert plan["tier"] == cases[case]["tier"]
        if plan["tier"] == "dp_only":    # no TP: the slots split over (data, model)
            assert counts["gather_slots"] > 0 and counts["gather_vocab"] == 0
            assert share == 1.0
        elif dims[1] > 1:                # a model axis: the head's logits are gathered
            assert counts["gather_vocab"] > 0
        if len(dims) == 3:
            assert counts["gather_experts"] > 0 and plan["moe_mode"] == "expert_axis"
        if case.endswith("ep-model"):
            assert counts["gather_experts"] > 0 and plan["moe_mode"] == "ep"
        if extra.get("temperature"):     # a random draw: rank 0's, broadcast
            assert counts["broadcast"] > 0


FUSED = [(m, c) for m, c in CASES
         if ("fused-int8" in c or c.endswith("ep-model") or c.startswith(("mamba", "zamba"))
             or c == "granite-etp-int8-raw")
         and ("paged" not in c or m == "dp2") and m != "tp4"]


@pytest.mark.parametrize("mesh,case", FUSED, ids=[f"{m}-{c}" for m, c in FUSED])
def test_fused_int8_logits_bitwise(mesh, case):
    """Every logits row the samplers see (admission and decode), bit for bit."""
    want = _single(W.BASELINE.get(case, case))[2]
    for rank, res in _mesh_results(mesh).items():
        seen = res[case][2]
        assert len(seen) == len(want)
        assert all(np.array_equal(a, b) for a, b in zip(seen, want)), (mesh, case, rank)


def test_collective_schedule_tp2():
    """Per model call at tp=2 on fused-int8: 2 int32 SUMs and 2 MAXes a layer (wo
    and down), the embedding's SUM and the logits' gather."""
    res = _mesh_results("tp2")[0]["dense-fused-int8-int8"]
    counters, counts = res[1], res[4]
    calls = counters["prefill_calls"] + counters["decode_steps"]
    L = W.cfg_of("sc").n_layers
    assert counts["sum_i32"] == 2 * L * calls and counts["max_f32"] == 2 * L * calls
    assert counts["sum_f32"] == calls and counts["gather_vocab"] == calls
    assert counts["gather_experts"] == counts["broadcast"] == 0


def _schedule(mesh, case):
    """Collectives per model call by kind (the layers' row-parallel pairs, the
    embedding's SUM and the head's gather on a model axis, the hidden rows'
    gather on a data axis)."""
    dims = W.MESHES[mesh][0]
    arch = W.MESHES[mesh][1][case]["arch"]
    cfg = W.cfg_of(arch)
    L = cfg.n_layers
    want = {k: 0 for k in ("sum_i32", "max_f32", "sum_f32", "gather_vocab", "gather_experts",
                           "gather_groups", "gather_cols", "gather_slots", "gather_pages",
                           "broadcast",
                           # training's collectives: serving makes none of them
                           "f_sum", "g_sum", "g_gather", "loss_sum", "fsdp_gather",
                           "grad_sum", "norm_sum")}
    if dims[0] > 1:
        want["gather_slots"] = 1
        if case.startswith("paged"):          # the K/V rows every data rank wrote
            want["gather_pages"] = 1
    if dims[1] == 1:
        return want
    want["sum_f32"] = want["gather_vocab"] = 1
    if arch in ("mamba", "zamba"):
        shared = cfg.n_layers // cfg.attn_every if arch == "zamba" else 0
        want.update(sum_i32=L + 2 * shared, max_f32=L + 2 * shared, gather_cols=2 * L)
    elif case.startswith("w4a8"):
        want.update(max_f32=2 * L, gather_groups=2 * L)     # wo and down: one chunk each
    else:
        want.update(sum_i32=2 * L, max_f32=2 * L)
    return want


SCHEDULED = [("dp2", "dense-fused-int8-int8"), ("dp2xtp2", "dense-fused-int8-int8"),
             ("dp2", "paged-fused-int8-int8"), ("dp2xtp2", "paged-fused-int8-fp"),
             ("dp2xtp2", "w4a8-fused-int8-int8"), ("tp2", "w4a8-fused-int8-int8"),
             ("tp2", "granite-etp-fused-int8-int8"), ("tp2", "mamba-paged-int8"),
             ("tp2", "zamba-dense-int8")]


@pytest.mark.parametrize("mesh,case", SCHEDULED, ids=[f"{m}-{c}" for m, c in SCHEDULED])
def test_collective_schedule(mesh, case):
    """Every rank makes the schedule's collectives, per model call and kind."""
    want = _schedule(mesh, case)
    for rank, res in _mesh_results(mesh).items():
        counters, counts = res[case][1], res[case][4]
        calls = counters["prefill_calls"] + counters["decode_steps"]
        assert counts == {k: v * calls for k, v in want.items()}, (mesh, case, rank)


@functools.lru_cache(maxsize=None)
def _jax_single(key):
    """The JAX reference engine's tokens for single-device case ``key``, on the same
    trees the port serves."""
    c = W.SINGLE[key]
    cfg = dataclasses.replace(jget(W.ARCH[c["arch"]], smoke=True), dtype="float32")
    params = jax.tree_util.tree_map(jax.numpy.asarray, _jax_trees()[c["arch"]][c["tree"]])
    prompts, max_new = W.prompts_of(c["arch"], c["prompts"])
    jeng = JE.ServeEngine(cfg, params, quant=_JW4 if c["quant"] == "w4" else jql.W8A8_INT8,
                          config=JEngineConfig(batch_size=2, max_len=32, path=c["path"],
                                               kv_cache=c["kv"], **c["extra"]))
    jeng.submit([p.copy() for p in prompts], max_new=list(max_new))
    return {r.rid: r.out for r in jeng.run()}


@functools.lru_cache(maxsize=None)
def _jax_references():
    """Every JAX reference engine ``test_tokens_equal_jax_engine`` needs, started on
    threads as the ranks spawn (XLA compiles outside the GIL, so the engines'
    compiles overlap the ranks' work): {key: future of ``_jax_single(key)``}."""
    import concurrent.futures as cf

    pool = cf.ThreadPoolExecutor(max_workers=4)
    futures = {key: pool.submit(_jax_single, key)
               for key in sorted({W.BASELINE.get(c, c) for _, c in JAX_CASES})}
    pool.shutdown(wait=False)
    return futures


#: (mesh, case) held against the JAX engine: fused-int8 with int8 KV, dense and
#: paged with prefix hits, speculative, a forced tier and every MoE mode
JAX_CASES = [("tp2", "dense-fused-int8-int8"), ("tp4", "dense-fused-int8-int8"),
             ("tp2", "paged-fused-int8-int8"), ("tp2", "spec4"),
             ("tp2", "tp_ffn-fused-int8-int8"), ("tp2", "granite-ep-model"),
             ("tp2", "llama-ep-model"), ("ep2", "granite-fused-int8-int8"),
             ("ep2", "llama-fused-int8-int8"), ("tp2xep2", "granite-fused-int8-int8"),
             ("tp2xep2", "llama-fused-int8-int8"), ("dp2xtp2", "dense-fused-int8-int8"),
             ("tp2", "w4a8-fused-int8-int8"), ("tp2", "granite-etp-fused-int8-int8"),
             ("tp2", "mamba-dense-int8"), ("tp2", "zamba-dense-int8")]


@pytest.mark.parametrize("mesh,case", JAX_CASES,
                         ids=[m if c == "dense-fused-int8-int8" and m != "dp2xtp2"
                              else f"{m}-{c}" for m, c in JAX_CASES])
def test_tokens_equal_jax_engine(mesh, case):
    """Sharded fused-int8 with int8 KV equals the JAX single-device engine."""
    want = _jax_references()[W.BASELINE.get(case, case)].result()
    for rank, res in _mesh_results(mesh).items():
        assert res[case][0] == want, (mesh, case, rank)


# ======================================================================================
# typed refusals
# ======================================================================================

def _mesh(**axes):
    names = tuple(axes)
    return Mesh(names, dict(axes), {n: 0 for n in names}, 0, {n: None for n in names})


def _engine(cfg, params, mesh, quant=tql.W8A8_INT8, plan=None):
    return TE.ServeEngine(cfg, params, quant=quant, device="cpu", mesh=mesh, plan=plan,
                          config=EngineConfig(batch_size=2, max_len=32, path="fused-int8"))


def test_refusals():
    trees = _jax_trees()
    # W4A8 g32 at tp=2 with d_ff 96: down's 3 groups do not split over 2 ranks
    w4 = dataclasses.replace(tql.W4A8_G128, w_group=32)
    sc96 = dataclasses.replace(W.cfg_of("sc"), d_ff=96)
    raw96 = TM.init_params(torch.Generator().manual_seed(0), sc96, device="cpu")
    with pytest.raises(SP.ShardedW4A8Error):
        _engine(sc96, TMQ.quantize_tree(raw96, w4), _mesh(data=1, model=2), quant=w4)
    # W4A8 experts under expert_tp: K8 has no expert-batched group-acc mode
    gcfg = W.cfg_of("granite")
    granite = convert.params_from_numpy(trees["granite"]["raw"], device="cpu")
    gplan = dataclasses.replace(SP.make_serve_plan(gcfg, _mesh(data=1, model=2)),
                                moe_mode="expert_tp")
    with pytest.raises(SP.ShardedW4A8Error):
        _engine(gcfg, TMQ.quantize_tree(granite, w4), _mesh(data=1, model=2), quant=w4,
                plan=gplan)
    # a forced expert_tp whose d_ff_expert (64) does not split over 3 ranks
    gplan3 = dataclasses.replace(SP.make_serve_plan(gcfg, _mesh(data=1, model=3)),
                                 moe_mode="expert_tp")
    with pytest.raises(SP.ExpertTPError):
        _engine(gcfg, convert.params_from_numpy(trees["granite"]["int8"], device="cpu"),
                _mesh(data=1, model=3), plan=gplan3)
    for err in (SP.ShardedW4A8Error, SP.ExpertTPError):
        assert issubclass(err, SP.ShardingUnsupportedError)
    assert not hasattr(SP, "DataParallelServingError") and not hasattr(SP, "ShardedStateError")
