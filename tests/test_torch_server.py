"""The PyTorch port's async replica server (``serving/server.py``) against the JAX
reference on the CPU, at the smoke starcoder2 config in float32 with T = 32.

* **Config surface**: ``EngineConfig.to_json()`` equals the reference's for the
  same fields and round-trips; ``from_kwargs`` raises the reference's TypeError;
  ``add_config_args`` gives the same flags and choices; ``config_from_args``
  layers flags over JSON over defaults as the reference does.
* **Supervisor classes and router**: ``FailureInjector``, ``RestartTracker``,
  ``ReplicaHealth`` and ``PrefixRouter`` behave like the reference's on the same
  seeded sequences (route decisions and ``affinity_hits`` under each policy).
* **Streams**: two replicas on fused-int8, paged, int8 KV (a step's rows are
  independent there) stream token-exact against the JAX ``ServeEngine.run()``
  of the same prompts, with the same finish reasons (EOS, CACHE_FULL, LENGTH).
  On the fake, dequant-fp, chunked and fused-int8 dense paths, where a step's
  rows may share statistics, each replica's streams are token-exact against the
  port's direct engine fed the same prompts in the same order; the order is
  fixed with ``pause()``, ``replica_hint`` and ``resume()``.
* **Admission, routing, failover**: the typed ``AdmissionError`` (queue_full,
  pool_pressure, transient pool pressure), affinity routing, a killed replica's
  requests finishing on the survivor token-exact against the direct engine's
  continuation of prompt plus emitted tokens, with the failed engine freed
  before the restart builds, the restart budget marking a replica dead, and an
  engine build that fails taking the failure path instead of falling back.

No test waits by sleeping: every wait polls a state with a deadline. The
reference's own server tests sleep after ``pause()`` and compare batches made
up differently; these do neither.
"""
import argparse
import asyncio
import dataclasses
import sys
import threading
import time
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.quantize import quantize_tree as j_quantize_tree  # noqa: E402
from repro.runtime import supervisor as jsup  # noqa: E402
from repro.serving import config as jconfig  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.server import PrefixRouter as JPrefixRouter  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import supervisor as tsup  # noqa: E402
from repro_torch.serving import config as tconfig  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import server as S  # noqa: E402
from repro_torch.serving.api import AdmissionError, FinishReason, Request  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402

torch.set_num_threads(2)

T = 32
LENS = [6, 9, 5, 12, 7, 10]
MAX_NEW = [5, 3, 6, 4, 2, 5]
WAIT_S = 60.0


@pytest.fixture(scope="module")
def small():
    """The smoke starcoder2 config in f32: (cfg, fp params, W8A8 tree) in the port,
    made by the reference's ``init_params`` / ``quantize_tree`` and carried over as
    numpy, plus the reference's (cfg, W8A8 tree) for the JAX engine."""
    cfg_j = dataclasses.replace(jget("starcoder2-7b", smoke=True), dtype="float32")
    cfg_t = dataclasses.replace(tget("starcoder2-7b", smoke=True), dtype="float32")
    params_j = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    qparams_j = j_quantize_tree(params_j, jql.W8A8_INT8)

    def port(tree):
        return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                         device="cpu")

    return cfg_t, port(params_j), port(qparams_j), cfg_j, qparams_j


def _prompts(vocab, lens=LENS, seed=0, shared=None):
    rng = np.random.default_rng(seed)
    pre = shared if shared is not None else np.zeros(0, np.int32)
    return [np.concatenate([pre, rng.integers(1, vocab, size=n).astype(np.int32)])
            for n in lens]


async def _until(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.001)


async def _collect(srv, req):
    toks, fin = [], None
    async for ev in srv.submit(req):
        if ev.kind == "token":
            toks.append(ev.token)
        elif ev.kind == "finished":
            fin = ev
        else:
            raise AssertionError(f"stream error: {ev.error}")
    return toks, fin


def _load(srv):
    return sum(r.load for r in srv.replicas)


async def _placed(srv, reqs):
    """Submit ``reqs`` one at a time while every replica is paused, each once the
    previous one sits in a replica's inbox, so every replica drains its requests
    in submission order on ``resume()``. Returns the streams' tasks."""
    srv.pause()
    tasks = []
    for req in reqs:
        n = _load(srv)
        tasks.append(asyncio.create_task(_collect(srv, req)))
        await _until(lambda: _load(srv) == n + 1, "the request in an inbox")
    return tasks


def _direct(cfg, params, config, prompts, max_new, quant):
    """The port's direct engine on the same prompts in the same order: (outs,
    finish reasons)."""
    eng = TE.ServeEngine(cfg, params, config=config, quant=quant, device="cpu")
    reqs = eng.submit([np.asarray(p, np.int32) for p in prompts], max_new=list(max_new))
    eng.run()
    return [r.out for r in reqs], [r.finish_reason for r in reqs]


# ---------------------------------------------------------------- config surface

CONFIGS = [
    dict(batch_size=2, max_len=32),
    dict(batch_size=4, max_len=1024, path="fused-int8", kv_cache="int8",
         cache_layout="paged", page_size=16, n_pages=300, prefill_buckets=[64, 1024],
         eos_id=7, seed=3),
    dict(batch_size=2, max_len=64, cache_layout="paged", chunked=True, token_budget=16,
         prefix_reuse=False, cache_dtype="bfloat16"),
    dict(batch_size=2, max_len=64, path="dequant-fp", speculate=4, drafter_ngram=2,
         sparsity="2:4", scheduler="continuous"),
    dict(batch_size=3, max_len=48, path="fake", scheduler="grouped", temperature=0.7,
         top_k=5),
]


@pytest.mark.parametrize("fields", CONFIGS, ids=range(len(CONFIGS)))
def test_config_json_equals_reference(fields):
    ours, ref = EngineConfig(**fields), jconfig.EngineConfig(**fields)
    assert ours.to_json() == ref.to_json()
    assert ours.to_json(indent=2) == ref.to_json(indent=2)
    assert EngineConfig.from_json(ours.to_json()) == ours
    assert EngineConfig.from_json(ref.to_json()) == ours
    assert EngineConfig.from_dict(ref.to_dict()).to_dict() == ref.to_dict()
    assert [f.name for f in dataclasses.fields(EngineConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.EngineConfig)]


def test_from_kwargs_rejects_unknown_keys():
    with pytest.raises(TypeError) as ours:
        EngineConfig.from_kwargs(batch_size=2, max_len=8, bogus=1, also=2)
    with pytest.raises(TypeError) as ref:
        jconfig.EngineConfig.from_kwargs(batch_size=2, max_len=8, bogus=1, also=2)
    assert str(ours.value) == str(ref.value)
    with pytest.raises(TypeError):
        EngineConfig.from_json('{"batch_size": 2, "max_len": 8, "nope": true}')


def _flags(mod, prefix=""):
    ap = argparse.ArgumentParser()
    mod.add_config_args(ap, prefix=prefix)
    return {a.dest: (tuple(a.option_strings), a.choices, a.default, a.metavar, a.help,
                     type(a).__name__, getattr(a.type, "__name__", None))
            for a in ap._actions if a.dest != "help"}


@pytest.mark.parametrize("prefix", ["", "engine-"])
def test_add_config_args_same_flags_and_choices(prefix):
    ours, ref = _flags(tconfig, prefix), _flags(jconfig, prefix)
    assert ours == ref
    assert len(ours) == 20


ARGVS = [
    [],
    ["--batch-size", "3", "--cache-layout", "paged", "--no-prefix-reuse"],
    ["--prefill-buckets", "8,16,32", "--temperature", "0.5", "--top-k", "4",
     "--path", "fused-int8", "--kv-cache", "int8"],
    ["--chunked", "--token-budget", "12", "--max-len", "64", "--cache-dtype", "bfloat16",
     "--cache-layout", "paged"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_config_from_args_layers_like_reference(argv):
    base = dict(batch_size=2, max_len=32, cache_layout="paged", page_size=4, seed=9)
    outs = []
    for mod in (tconfig, jconfig):
        ap = argparse.ArgumentParser()
        mod.add_config_args(ap)
        args = ap.parse_args(argv)
        outs.append(mod.config_from_args(args, base=mod.EngineConfig(**base),
                                         max_len=48, eos_id=3).to_json())
        outs.append(mod.config_from_args(args, batch_size=4, max_len=48).to_json())
    assert outs[:2] == outs[2:]


# ------------------------------------------------------ supervisor classes, router

def test_supervisor_classes_like_reference():
    for mod in (tsup, jsup):
        inj = mod.FailureInjector(fail_at_steps=(1, 3))
        fired = []
        for step in (0, 1, 1, 2, 3, 3, 4):
            try:
                inj.check(step)
            except mod.WorkerFailure as e:
                fired.append((step, str(e)))
        assert fired == [(1, "injected failure at step 1"), (3, "injected failure at step 3")]
        tr = mod.RestartTracker(max_restarts=2)
        for _ in range(2):
            tr.record(mod.WorkerFailure("x"))
            assert not tr.exhausted
        with pytest.raises(RuntimeError, match="restart budget exhausted \\(2\\)"):
            tr.record(mod.WorkerFailure("x"))
        assert tr.exhausted and tr.restarts == 3
    assert tsup.ReplicaHealth(state="dead", restarts=1, steps=4,
                              last_error="E").to_dict() == \
        jsup.ReplicaHealth(state="dead", restarts=1, steps=4, last_error="E").to_dict()
    assert tsup.ReplicaHealth().to_dict() == jsup.ReplicaHealth().to_dict()
    assert issubclass(tsup.WorkerFailure, RuntimeError)


@pytest.mark.parametrize("policy", ["affinity", "least-loaded", "random"])
def test_router_decisions_equal_reference(policy):
    rng = np.random.default_rng(21)
    families = [rng.integers(1, 500, size=24).astype(np.int32) for _ in range(4)]
    ours = S.PrefixRouter(3, 8, policy=policy, seed=5, max_entries=12)
    ref = JPrefixRouter(3, 8, policy=policy, seed=5, max_entries=12)
    got, want = [], []
    for i in range(200):
        if i % 37 == 36:
            r = int(rng.integers(3))
            ours.forget(r)
            ref.forget(r)
            continue
        fam = families[int(rng.integers(4))]
        cut = int(rng.integers(0, 25))
        prompt = np.concatenate([fam[:cut], rng.integers(1, 500, size=int(rng.integers(1, 12)))
                                 .astype(np.int32)])
        alive = [r for r in range(3) if rng.random() > 0.2] or [int(rng.integers(3))]
        load = {r: int(rng.integers(0, 4)) for r in range(3)}
        a, b = ours.route(prompt, alive, load), ref.route(prompt, alive, load)
        got.append(a)
        want.append(b)
        ours.note(prompt, a)
        ref.note(prompt, b)
    assert got == want
    assert ours.affinity_hits == ref.affinity_hits
    if policy == "affinity":
        assert ours.affinity_hits > 20
    with pytest.raises(ValueError, match="unknown router policy"):
        S.PrefixRouter(2, 8, policy="nearest")


# ------------------------------------------------------------------------ streams

def test_streams_and_finish_reasons_vs_jax_engine(small, monkeypatch):
    """2 replicas, fused-int8, paged, int8 KV, radix reuse over a shared prefix:
    every stream and finish reason equals the JAX engine's run of the same
    prompts (one engine, one batch order: the rows are independent here)."""
    monkeypatch.setenv("REPRO_KERNEL_EXEC", "ref")     # JAX paged kernels: jnp oracles
    cfg, _, qparams, cfg_j, qparams_j = small
    shared = np.random.default_rng(30).integers(1, cfg.vocab, size=16).astype(np.int32)
    prompts = (_prompts(cfg.vocab, [4, 7, 3], seed=31, shared=shared)
               + _prompts(cfg.vocab, [6, 9, 5], seed=32)
               + _prompts(cfg.vocab, [T - 2], seed=33))          # fills its cache row
    max_new = [6, 4, 5, 6, 3, 5, 8]
    fields = dict(batch_size=2, max_len=T, path="fused-int8", kv_cache="int8",
                  cache_layout="paged")
    base, _ = _direct(cfg, qparams, EngineConfig(**fields), prompts, max_new, tql.W8A8_INT8)
    # EOS: a token some stream emits after a different first token, so it cuts
    # that stream mid-way
    eos = next(o[k] for o in base for k in range(1, len(o)) if o[k] not in o[:k])
    jeng = JE.ServeEngine(cfg_j, qparams_j, quant=jql.W8A8_INT8,
                          config=jconfig.EngineConfig(eos_id=eos, **fields))
    jeng.submit([p.copy() for p in prompts], max_new=max_new)
    jdone = jeng.run()
    config = EngineConfig(eos_id=eos, **fields)

    async def main():
        async with S.AsyncServer(cfg, qparams, config=config, replicas=2,
                                 quant=tql.W8A8_INT8, device="cpu") as srv:
            res = await asyncio.gather(*[
                _collect(srv, Request(prompt=p.tolist(), max_new=mn))
                for p, mn in zip(prompts, max_new)])
            m = srv.metrics()
        return res, m

    res, m = asyncio.run(main())
    for (toks, fin), r in zip(res, jdone):
        assert toks == r.out
        assert fin.finish_reason.value == r.finish_reason.value
        assert fin.metrics.n_tokens == len(toks) and fin.metrics.ttft_s >= 0.0
    reasons = {fin.finish_reason for _, fin in res}
    assert {FinishReason.EOS, FinishReason.CACHE_FULL, FinishReason.LENGTH} <= reasons
    assert any(0 < toks.index(eos) == len(toks) - 1 for toks, _ in res if eos in toks)
    assert res[-1][1].metrics.n_tokens == 3        # admit fills T-2; two appends hit T
    assert m["server"]["completed"] == len(prompts) and m["server"]["affinity_hits"] >= 2
    assert sum(rep["engine"]["prefix_hits"] for rep in m["replicas"]) >= 1


PATHS = {   # name: (params key, quant, EngineConfig fields)
    "fake-fp-dense": ("fp", tql.W8A8_CROSSQUANT, dict(path="fake")),
    "dequant-fp-int8-paged": ("int8", tql.W8A8_INT8,
                              dict(path="dequant-fp", kv_cache="int8", cache_layout="paged")),
    "chunked-fp": ("fp", None, dict(cache_layout="paged", chunked=True, token_budget=16)),
    "fused-int8-fp-dense": ("int8", tql.W8A8_INT8, dict(path="fused-int8")),
}


@pytest.mark.parametrize("name", list(PATHS))
def test_streams_token_exact_vs_direct_engine(small, name):
    """Each replica's streams equal the port's direct engine fed the same prompts
    in the same order (the fake path's dynamic column max couples a step's rows,
    so only batches of the same composition are compared)."""
    cfg, params, qparams, _, _ = small
    which, quant, fields = PATHS[name]
    tree = params if which == "fp" else qparams
    config = EngineConfig(batch_size=2, max_len=T, **fields)
    prompts = _prompts(cfg.vocab, seed=4)
    hints = [0, 1, 0, 0, 1, 1]
    reqs = [Request(prompt=p.tolist(), max_new=mn, replica_hint=h)
            for p, mn, h in zip(prompts, MAX_NEW, hints)]

    async def main():
        async with S.AsyncServer(cfg, tree, config=config, replicas=2, quant=quant,
                                 device="cpu") as srv:
            tasks = await _placed(srv, reqs)
            srv.resume()
            return await asyncio.gather(*tasks)

    res = asyncio.run(main())
    for rep in (0, 1):
        mine = [(req, toks, fin) for (toks, fin), req in zip(res, reqs)
                if req.replica_hint == rep]
        assert all(fin.metrics.replica == rep for _, _, fin in mine)
        want, reasons = _direct(cfg, tree, config, [q.prompt for q, _, _ in mine],
                                [q.max_new for q, _, _ in mine], quant)
        assert [t for _, t, _ in mine] == want, (name, rep)
        assert [fin.finish_reason for _, _, fin in mine] == reasons


# ---------------------------------------------------------------------- admission

def test_backpressure_rejects_past_deadline(small):
    """With every replica frozen, a submit past max_queue waits for the admission
    deadline and fails with the typed AdmissionError; resuming drains the held
    requests to completion."""
    cfg, params, _, _, _ = small
    config = EngineConfig(batch_size=1, max_len=T)
    prompts = _prompts(cfg.vocab, lens=[6, 6, 6], seed=7)

    async def main():
        async with S.AsyncServer(cfg, params, config=config, replicas=2, max_queue=2,
                                 admission_timeout=0.05, device="cpu") as srv:
            tasks = await _placed(srv, [Request(prompt=p.tolist(), max_new=3)
                                        for p in prompts[:2]])
            assert srv._inflight == 2
            t0 = time.monotonic()
            with pytest.raises(AdmissionError) as ei:
                await _collect(srv, Request(prompt=prompts[2].tolist(), max_new=3))
            assert ei.value.reason == "queue_full"
            assert time.monotonic() - t0 >= 0.05
            assert srv.counters["rejected"] == 1
            srv.resume()
            for toks, fin in await asyncio.gather(*tasks):
                assert len(toks) == 3 and fin.kind == "finished"
            assert srv.metrics()["server"]["inflight"] == 0

    asyncio.run(main())


def test_pool_pressure_rejects_oversized_reservation(small):
    """Paged: a request whose worst-case page reservation exceeds the whole pool
    rejects with reason="pool_pressure"; a right-sized one admits and finishes."""
    cfg, params, _, _, _ = small
    config = EngineConfig(batch_size=1, max_len=T, cache_layout="paged", page_size=8,
                          n_pages=3)
    big = _prompts(cfg.vocab, lens=[20], seed=13)[0]      # 20+8-1 tokens -> 4 pages
    ok = _prompts(cfg.vocab, lens=[6], seed=14)[0]        # 6+3-1 tokens -> 1 page

    async def main():
        async with S.AsyncServer(cfg, params, config=config, replicas=1,
                                 admission_timeout=0.05, device="cpu") as srv:
            with pytest.raises(AdmissionError) as ei:
                await _collect(srv, Request(prompt=big.tolist(), max_new=8))
            assert ei.value.reason == "pool_pressure"
            assert srv.counters["rejected"] == 1
            toks, fin = await _collect(srv, Request(prompt=ok.tolist(), max_new=3))
            assert len(toks) == 3 and fin.kind == "finished"

    asyncio.run(main())


def test_pool_pressure_transient_admits_after_release(small):
    """Pinning every free page makes a submit reject with "pool_pressure";
    releasing the pages lets the same request admit and finish."""
    cfg, params, _, _, _ = small
    config = EngineConfig(batch_size=1, max_len=T, cache_layout="paged", page_size=8)
    prompt = _prompts(cfg.vocab, lens=[6], seed=15)[0]

    async def main():
        async with S.AsyncServer(cfg, params, config=config, replicas=1, max_queue=4,
                                 admission_timeout=0.05, device="cpu") as srv:
            await _until(lambda: srv.replicas[0].engine is not None, "the engine")
            pool = srv.replicas[0].engine.pool
            held = pool.alloc(pool.free_count)
            assert held is not None
            with pytest.raises(AdmissionError) as ei:
                await _collect(srv, Request(prompt=prompt.tolist(), max_new=3))
            assert ei.value.reason == "pool_pressure"
            pool.decref(held)
            toks, fin = await _collect(srv, Request(prompt=prompt.tolist(), max_new=3))
            assert len(toks) == 3 and fin.kind == "finished"

    asyncio.run(main())


def test_affinity_keeps_shared_prefixes_together(small):
    """Two prefix families seed two replicas (least-loaded while both are held);
    every follow-up routes to the replica whose radix cache holds its prefix."""
    cfg, params, _, _, _ = small
    config = EngineConfig(batch_size=2, max_len=T, cache_layout="paged", page_size=8)
    rng = np.random.default_rng(8)
    pre_a = rng.integers(1, cfg.vocab, size=16).astype(np.int32)
    pre_b = rng.integers(1, cfg.vocab, size=16).astype(np.int32)
    fam_a = _prompts(cfg.vocab, lens=[5, 6, 7, 8], seed=9, shared=pre_a)
    fam_b = _prompts(cfg.vocab, lens=[5, 6, 7, 8], seed=10, shared=pre_b)

    async def main():
        async with S.AsyncServer(cfg, params, config=config, replicas=2,
                                 device="cpu") as srv:
            seeds = await _placed(srv, [Request(prompt=p.tolist(), max_new=3)
                                        for p in (fam_a[0], fam_b[0])])
            srv.resume()
            ra, rb = [fin.metrics.replica for _, fin in await asyncio.gather(*seeds)]
            assert ra != rb
            for fam, home in ((fam_a, ra), (fam_b, rb)):
                for p in fam[1:]:
                    _, fin = await _collect(srv, Request(prompt=p.tolist(), max_new=3))
                    assert fin.metrics.replica == home
                    assert fin.metrics.prefix_reused >= 16
            assert srv.router.affinity_hits == 6
            for rep in srv.metrics()["replicas"]:
                assert rep["engine"]["prefix_hit_rate"] > 0.0

    asyncio.run(main())


# ----------------------------------------------------------------------- failover

@pytest.mark.parametrize("max_restarts", [2, 0])
def test_failover_token_exact_and_restart_budget(small, monkeypatch, max_restarts):
    """Replica 0 dies at its step 3 with every request on it. Its requests finish
    on replica 1: what replica 0 streamed equals the direct engine's first tokens,
    and the rest equals the direct engine fed the continuations (prompt + emitted)
    in requeue order. The failed engine is unreachable before the restart builds
    the next one. With budget left replica 0 is live again and serves; at
    max_restarts=0 it is dead and a hint to it is ignored."""
    cfg, _, qparams, _, _ = small
    config = EngineConfig(batch_size=2, max_len=T, path="fused-int8", cache_layout="paged")
    prompts = _prompts(cfg.vocab, lens=[6, 9, 5, 12], seed=11)
    reqs = [Request(prompt=p.tolist(), max_new=8, replica_hint=0) for p in prompts]
    built, stale = [], []

    class Engine(TE.ServeEngine):
        def __init__(self, *a, **kw):
            name = threading.current_thread().name
            stale.extend(name for n, ref in built if n == name and ref() is not None)
            super().__init__(*a, **kw)
            built.append((name, weakref.ref(self)))

    monkeypatch.setattr(S, "ServeEngine", Engine)

    async def main():
        inj = {0: tsup.FailureInjector(fail_at_steps=(3,))}
        async with S.AsyncServer(cfg, qparams, config=config, replicas=2, injectors=inj,
                                 quant=tql.W8A8_INT8, max_restarts=max_restarts,
                                 device="cpu") as srv:
            requeued = []
            handle = srv._handle_replica_failure

            def snapshot(replica, interrupted, err):
                requeued.extend((list(r.req.prompt), list(r.emitted)) for r in interrupted)
                handle(replica, interrupted, err)

            srv._handle_replica_failure = snapshot
            tasks = await _placed(srv, reqs)
            srv.replicas[0].pause_flag.clear()       # replica 1 stays held
            srv.replicas[0].wake.set()
            await _until(lambda: srv.counters["restarts"] == 1, "the failure")
            await _until(lambda: srv.replicas[1].load == len(requeued), "the requeue")
            srv.resume()
            res = await asyncio.gather(*tasks)
            want_state = "live" if max_restarts else "dead"
            await _until(lambda: srv.replicas[0].health.state == want_state
                         and (srv.replicas[0].engine is not None or not max_restarts),
                         "replica 0's new state")
            _, fin = await _collect(srv, Request(prompt=prompts[0].tolist(), max_new=4,
                                                 replica_hint=0))
            return res, requeued, srv.metrics(), fin

    res, requeued, m, fin = asyncio.run(main())
    assert len(requeued) == len(prompts)                 # every request was on replica 0
    head, _ = _direct(cfg, qparams, config, prompts, [8] * 4, tql.W8A8_INT8)
    emitted = {tuple(p): e for p, e in requeued}
    for (toks, f), p, h in zip(res, prompts, head):
        assert len(toks) == 8 and f.finish_reason == FinishReason.LENGTH
        e = emitted[tuple(p.tolist())]
        assert toks[:len(e)] == e == h[:len(e)]
    assert any(e for _, e in requeued), "the failure interrupted no decoding"
    cont = [(p, e) for p, e in requeued if len(e) < 8]
    tails, _ = _direct(cfg, qparams, config, [p + e for p, e in cont],
                       [8 - len(e) for _, e in cont], tql.W8A8_INT8)
    got = {tuple(p.tolist()): toks for (toks, _), p in zip(res, prompts)}
    for (p, e), tail in zip(cont, tails):
        assert got[tuple(p)][len(e):] == tail
    assert sum(f.metrics.requeues for _, f in res) == len(prompts)
    assert all(f.metrics.replica == 1 for _, f in res)
    assert m["server"]["restarts"] == 1 and m["server"]["requeued"] == len(prompts)
    assert not stale, f"an engine was built while its failed predecessor was alive: {stale}"
    if max_restarts:
        assert m["replicas"][0]["state"] == "live" and m["replicas"][0]["restarts"] == 1
        assert fin.metrics.replica == 0
    else:
        assert m["replicas"][0]["state"] == "dead"
        assert fin.metrics.replica == 1                  # hint ignored: replica dead
    assert m["replicas"][0]["last_error"] == "WorkerFailure: injected failure at step 3"


def test_engine_build_failure_takes_the_failure_path(small, monkeypatch):
    """An engine (or kernel) build that raises is not swallowed and nothing falls
    back: each replica restarts until its budget is spent, is declared dead, and a
    request then ends in the terminal "no live replica" error frame."""
    cfg, params, _, _, _ = small

    def broken(*a, **kw):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(S, "ServeEngine", broken)

    async def main():
        async with S.AsyncServer(cfg, params, config=EngineConfig(batch_size=1, max_len=T),
                                 replicas=2, max_restarts=1, device="cpu") as srv:
            await _until(lambda: all(r.health.state == "dead" for r in srv.replicas),
                         "both replicas dead")
            evs = [ev async for ev in srv.submit(Request(prompt=[1, 2, 3], max_new=2))]
            return evs, srv.metrics()

    evs, m = asyncio.run(main())
    assert [ev.kind for ev in evs] == ["error"] and evs[0].error == "no live replica"
    assert m["server"]["restarts"] == 4 and m["server"]["errors"] == 1
    assert all(r["last_error"] == "RuntimeError: kernel build failed" and r["restarts"] == 1
               for r in m["replicas"])


def test_kernel_proportion_metric(small):
    """kernel_stats=True reports the paper's §4.1 quantization-kernel proportion
    measured on the request's own served tokens."""
    cfg, params, _, _, _ = small
    config = EngineConfig(batch_size=1, max_len=T, path="fake")

    async def main():
        async with S.AsyncServer(cfg, params, config=config, replicas=1,
                                 quant=tql.W8A8_CROSSQUANT, kernel_stats=True,
                                 device="cpu") as srv:
            toks, fin = await _collect(
                srv, Request(prompt=_prompts(cfg.vocab)[0].tolist(), max_new=4))
            return toks, fin, srv

    toks, fin, srv = asyncio.run(main())
    kp = fin.metrics.kernel_proportion
    assert kp is not None and 0.0 < kp <= 1.0
    tokens = np.concatenate([_prompts(cfg.vocab)[0], np.asarray(toks, np.int32)])
    with torch.no_grad():
        assert srv._kernel_proportion(tokens) == kp


# ---------------------------------------------------------------- launch counters

def test_launch_counts_exact_across_threads(monkeypatch):
    """Concurrent replicas count their kernel launches exactly: 8 threads bumping
    the counters with a tiny switch interval lose no update."""
    monkeypatch.setattr(ops, "LAUNCHES", dict(ops.LAUNCHES))
    monkeypatch.setattr(ops, "BODY_LAUNCHES", dict(ops.BODY_LAUNCHES))
    ops.reset_launches()
    n, per = 8, 20000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [ops._count("qgemm_w8a8",
                                                               "qgemm_w8a8/decode")
                                                    for _ in range(per)])
                   for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert ops.LAUNCHES["qgemm_w8a8"] == n * per
    assert ops.BODY_LAUNCHES["qgemm_w8a8/decode"] == n * per
    ops.reset_launches()
    assert not any(ops.LAUNCHES.values()) and not any(ops.BODY_LAUNCHES.values())


def test_device_turns_are_fifo():
    """Replicas sharing a device step in FIFO turns: a waiting thread is served
    before the holder's next turn, so one busy replica cannot starve another."""
    turns = S._Turns()
    order = []

    def step(name):
        with turns.turn():
            order.append(name)

    threads = [threading.Thread(target=step, args=(n,)) for n in ("b", "c")]
    with turns.turn():
        for i, t in enumerate(threads):
            t.start()
            deadline = time.monotonic() + WAIT_S
            while turns._issued != i + 2:             # the thread holds a ticket
                assert time.monotonic() < deadline
                time.sleep(0.001)
        order.append("a")
    step("a")                                         # queues behind b and c
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)
    assert order == ["a", "b", "c", "a"]
