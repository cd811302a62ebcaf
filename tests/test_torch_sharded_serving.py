"""Tensor- and expert-parallel serving of the port on the CPU: gloo worlds of 2 and
4 processes against the single-device engine, token-exact on every mode of the
reference's sharded matrix (tests/test_sharded_serving.py), logits bitwise on
the fused-int8 path.

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
  at tp=2 both also place their experts over "model" (``ep``).

Each rank records the logits its sampler sees; the fused-int8 ones must equal the
single-device engine's bit for bit at tp=2, ep=2 and tp2×ep2 (at tp=4 a rank's
GQA group is one query head, not two, and the CPU's batched attention product
rounds that shape differently: token-exact there). The fused-int8 int8-KV tokens
also equal the JAX reference engine's: dense at tp=2 and tp=4, paged with prefix
hits, speculative, ``tp_ffn``, and the MoE at ep=2, tp2×ep2 and experts over
"model".
The typed refusals (a data axis above 1, an SSM family, W4A8 split over the
mesh, ``expert_tp``) are raised before any collective, in this process.
"""
import dataclasses
import functools
import multiprocessing
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.quantize import quantize_tree as j_quantize_tree  # noqa: E402
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
    """The smoke trees, initialised by the reference (so its engine serves the same
    ones), as numpy."""
    out = {}
    for arch, name in W.ARCH.items():
        cfg = dataclasses.replace(jget(name, smoke=True), dtype="float32")
        raw = JM.init_params(jax.random.PRNGKey(0 if arch == "sc" else 1), cfg)
        q = j_quantize_tree(raw, jql.W8A8_INT8)
        out[arch] = {"raw": jax.tree_util.tree_map(np.asarray, raw),
                     "int8": jax.tree_util.tree_map(np.asarray, q)}
    return out


@functools.lru_cache(maxsize=None)
def _world(size):
    """Spawn the world of ``size`` ranks once; {rank: {mesh: {case: result}}}."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=W.worker, args=(r, size, port, _jax_trees(), queue))
             for r in range(size)]
    try:
        for p in procs:
            p.start()
        results = {}
        for _ in range(size):
            rank, status, payload = queue.get(timeout=300)
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
        got, counters, _, plan, counts = res[case]
        assert got == want, (mesh, case, rank, got, want)
        assert plan["tp"] == dims[1] and plan["ep"] == (dims[2] if len(dims) == 3 else 1)
        extra = cases[case]["extra"]
        if extra.get("cache_layout") != "paged":
            assert counters["mid_decode_admissions"] > 0
        if case.startswith("paged"):
            assert counters["prefix_hits"] > 0
        if extra.get("speculate"):
            assert counters["spec_accepted"] > 0
        if extra.get("chunked"):
            assert counters["chunk_prefill_rows"] > 0
        if cases[case]["tier"]:
            assert plan["tier"] == cases[case]["tier"]
        if dims[1] > 1:                  # a model axis: the head's logits are gathered
            assert counts["gather_vocab"] > 0
        if len(dims) == 3:
            assert counts["gather_experts"] > 0 and plan["moe_mode"] == "expert_axis"
        if case.endswith("ep-model"):
            assert counts["gather_experts"] > 0 and plan["moe_mode"] == "ep"
        if extra.get("temperature"):     # a random draw: rank 0's, broadcast
            assert counts["broadcast"] > 0


FUSED = [(m, c) for m, c in CASES
         if ("fused-int8" in c or c.endswith("ep-model")) and "paged" not in c and m != "tp4"]


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


@functools.lru_cache(maxsize=None)
def _jax_single(key):
    """The JAX reference engine's tokens for single-device case ``key``, on the same
    trees the port serves."""
    c = W.SINGLE[key]
    cfg = dataclasses.replace(jget(W.ARCH[c["arch"]], smoke=True), dtype="float32")
    params = jax.tree_util.tree_map(jax.numpy.asarray, _jax_trees()[c["arch"]][c["tree"]])
    prompts, max_new = W.prompts_of(c["arch"], c["prompts"])
    jeng = JE.ServeEngine(cfg, params, quant=jql.W8A8_INT8,
                          config=JEngineConfig(batch_size=2, max_len=32, path=c["path"],
                                               kv_cache=c["kv"], **c["extra"]))
    jeng.submit([p.copy() for p in prompts], max_new=list(max_new))
    return {r.rid: r.out for r in jeng.run()}


#: (mesh, case) held against the JAX engine: fused-int8 with int8 KV, dense and
#: paged with prefix hits, speculative, a forced tier and every MoE mode
JAX_CASES = [("tp2", "dense-fused-int8-int8"), ("tp4", "dense-fused-int8-int8"),
             ("tp2", "paged-fused-int8-int8"), ("tp2", "spec4"),
             ("tp2", "tp_ffn-fused-int8-int8"), ("tp2", "granite-ep-model"),
             ("tp2", "llama-ep-model"), ("ep2", "granite-fused-int8-int8"),
             ("ep2", "llama-fused-int8-int8"), ("tp2xep2", "granite-fused-int8-int8"),
             ("tp2xep2", "llama-fused-int8-int8")]


@pytest.mark.parametrize("mesh,case", JAX_CASES,
                         ids=[m if c == "dense-fused-int8-int8" else f"{m}-{c}"
                              for m, c in JAX_CASES])
def test_tokens_equal_jax_engine(mesh, case):
    """Sharded fused-int8 with int8 KV equals the JAX single-device engine."""
    want = _jax_single(W.BASELINE.get(case, case))
    for rank, res in _mesh_results(mesh).items():
        assert res[case][0] == want, (mesh, case, rank)


# ======================================================================================
# typed refusals
# ======================================================================================

def _mesh(**axes):
    names = tuple(axes)
    return Mesh(names, dict(axes), {n: 0 for n in names}, 0, {n: None for n in names})


def _engine(cfg, params, mesh, quant=tql.W8A8_INT8):
    return TE.ServeEngine(cfg, params, quant=quant, device="cpu", mesh=mesh,
                          config=EngineConfig(batch_size=2, max_len=32, path="fused-int8"))


def test_refusals():
    trees = _jax_trees()
    sc = convert.params_from_numpy(trees["sc"]["int8"], device="cpu")
    with pytest.raises(SP.DataParallelServingError):
        _engine(W.cfg_of("sc"), sc, _mesh(data=2, model=2))
    cfg = dataclasses.replace(tget("mamba2-130m", smoke=True), dtype="float32")
    mp = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(SP.ShardedStateError):
        _engine(cfg, mp, _mesh(data=1, model=2))
    raw = convert.params_from_numpy(trees["sc"]["raw"], device="cpu")
    w4 = dataclasses.replace(tql.W4A8_G128, w_group=32)
    with pytest.raises(SP.ShardedW4A8Error):
        _engine(W.cfg_of("sc"), TMQ.quantize_tree(raw, w4), _mesh(data=1, model=2), quant=w4)
    llama = convert.params_from_numpy(trees["llama"]["int8"], device="cpu")
    with pytest.raises(SP.ExpertTPError):            # 4 experts on 3 ranks, d_ff 96 / 3
        _engine(W.cfg_of("llama"), llama, _mesh(data=1, model=3))
    for err in (SP.DataParallelServingError, SP.ShardedStateError, SP.ShardedW4A8Error,
                SP.ExpertTPError):
        assert issubclass(err, SP.ShardingUnsupportedError) and "ROADMAP" in err.__doc__
