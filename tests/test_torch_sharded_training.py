"""Sharded training of the port on the CPU: gloo worlds of 2 and 4 processes
(tests/_torch_train_worker.py) against the port's one-device step and the
reference's jitted one-device step, on the same numpy tree and batches.

Smoke configs in float32, params from ``repro.models.model.init_params``,
batches from ``make_train_batches`` with a seed, 2 steps at ``n_micro`` 2, 2
rows per microbatch and data rank:

* world 2, data 2 (FSDP): starcoder2-7b, granite-moe-3b-a800m (the grouped
  dispatch: one device runs G = 2, the reference with ``hints.token_group_count``
  patched to return 2 and a freshly jitted step), mamba2-130m, and starcoder2
  with gradient compression (crossquant);
* world 2, model 2: starcoder2 (``tp_full``) and granite (experts over "model",
  ``ep``);
* world 4, data 2 × model 2: starcoder2, and starcoder2 forced to ``dp_only``
  (the batch over both axes, the weights FSDP over the whole mesh).

Each step is held from the state the sharded run reached before it (gathered
with ``unshard``): the loss at rtol 1e-5, the grad norm at 1e-5 and the first
Adam moment per leaf within 2e-5 of the leaf's max (the bars of
tests/test_torch_training.py). A step is compared from one state, not a
trajectory: the first AdamW update is sign-like, so two runs part by an ulp of
a near-zero gradient and the second step's moments then differ past 2e-5 even
between the one-device port and the reference (8e-5 on granite at G = 2).

The elastic case: sc-data2's two steps end in a checkpoint of the logical
arrays (every rank joins the gathers, rank 0 writes), which restores on one
device and takes a third step, held against three uninterrupted one-device
steps within the same bars; a one-device checkpoint restores onto either rank of
a data-2 mesh. The world of 2 also runs ``launch.train.run`` at data 2 with a
failure at step 3 (bitwise against the uninterrupted run), the world of 4 the
elastic mesh over 3 survivors (data 2 over ranks 0 and 1). One process: the
grouped ``moe_apply`` at G = 2 against the reference's patched path (value, aux
and gradients), ``usable_dp`` / ``plan_mesh_shape``, and each typed refusal.
"""
import atexit
import dataclasses
import functools
import multiprocessing
import os
import pickle
import shutil
import socket
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models.layers import QuantContext as JQuantContext  # noqa: E402
from repro.runtime import elastic as JEL  # noqa: E402
from repro.sharding import hints  # noqa: E402
from repro.training import compression as JC, optimizer as JO, trainer as JT  # noqa: E402

import _torch_train_worker as W  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.layers import QuantContext  # noqa: E402
from repro_torch.models.model import leaves, map_tensors  # noqa: E402
from repro_torch.runtime import elastic as TEL  # noqa: E402
from repro_torch.sharding import planner as SP  # noqa: E402
from repro_torch.training import compression as TC, optimizer as TO, trainer as TT  # noqa: E402
from repro_torch.training.layout import train_layout  # noqa: E402

LOSS_RTOL, GNORM_RTOL, MOMENT_TOL = 1e-5, 1e-5, 2e-5


@functools.lru_cache(maxsize=None)
def _trees():
    """The reference's smoke trees (``init_params`` under ``jax.jit``) as numpy,
    per arch of the worker."""
    init = jax.jit(JM.init_params, static_argnums=1)
    return {a: jax.tree_util.tree_map(np.asarray, init(
        jax.random.PRNGKey(0), dataclasses.replace(jget(name, smoke=True), dtype="float32")))
        for a, name in W.ARCH.items()}


@functools.lru_cache(maxsize=None)
def _ckpt_dir():
    d = tempfile.mkdtemp(prefix="torch_train_ckpt_")
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    return d


@functools.lru_cache(maxsize=None)
def _trees_file():
    """The trees in a file the ranks load: a spawned child reads its arguments
    only after it has imported torch, so large ones would start the ranks one by
    one."""
    path = os.path.join(_ckpt_dir(), "trees.pkl")
    with open(path, "wb") as f:
        pickle.dump(_trees(), f)
    return path


@functools.lru_cache(maxsize=None)
def _spawned():
    """Both worlds, spawned at once so that they overlap on the CPU: {size:
    (processes, result queue)}. A world nobody collects is killed at exit."""
    ctx = multiprocessing.get_context("spawn")
    out = {}
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "2"
    try:
        for size in W.WORLDS:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            queue = ctx.Queue()
            procs = [ctx.Process(target=W.worker, args=(r, size, port, _trees_file(),
                                                        _ckpt_dir(), queue)) for r in range(size)]
            for p in procs:
                p.start()
            out[size] = (procs, queue)
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old
    atexit.register(lambda: [p.kill() for procs, _ in out.values() for p in procs
                             if p.is_alive()])
    return out


@functools.lru_cache(maxsize=None)
def _world(size):
    """{rank: {case: result}} of the world of ``size`` ranks."""
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


def _results(key):
    """{rank: result} of a case (or of ``launch``, world 2, ``elastic-mesh``, world 4)."""
    size = 2 if key in W.WORLDS[2] or key == "launch" else 4
    return {rank: res[key] for rank, res in _world(size).items()}


# ------------------------------------------------------------------------ references

def _jstep(arch, groups, compress):
    return _jstep_g(arch, groups if arch == "granite" else 1, compress)


@functools.lru_cache(maxsize=None)
def _jstep_g(arch, groups, compress):
    """The reference's jitted train step; ``groups`` > 1 traces it with
    ``hints.token_group_count`` returning that G (a fresh jit: traces are cached
    by function identity)."""
    cfg = dataclasses.replace(jget(W.ARCH[arch], smoke=True), dtype="float32")
    step = jax.jit(JT.make_train_step(cfg, JO.AdamWConfig(**W.OPT), n_micro=W.N_MICRO,
                                      compression=JC.CompressionConfig() if compress else None))
    if groups == 1:
        return step

    def grouped(*args):
        orig = hints.token_group_count
        hints.token_group_count = lambda n: groups if n % groups == 0 else 1
        try:
            return step(*args)
        finally:
            hints.token_group_count = orig
    return grouped


def _state_before(c, key, k):
    """(params, m, v, step, err) numpy trees the sharded run held before step k."""
    if k == 0:
        p = _trees()[c["arch"]]
        zeros = jax.tree_util.tree_map(np.zeros_like, p)
        err = jax.tree_util.tree_map(np.asarray, JC.init_error_state(p))
        return p, zeros, zeros, 0, err
    st = _results(key)[0][0][k - 1][1]
    return st["params"], st["m"], st["v"], st["step"], st.get("err")


@functools.lru_cache(maxsize=None)
def _first_steps():
    """Every case's step 0 from the initial state (:func:`_references`), computed
    on threads while the ranks run (XLA compiles outside the GIL); granite's
    cases share one thread, since its grouped trace patches ``hints``.
    {case: future}."""
    import concurrent.futures as cf

    _spawned()
    pool = cf.ThreadPoolExecutor(max_workers=4)
    by_arch = {}
    for key, c in W.CASES.items():
        by_arch.setdefault(c["arch"] if c["arch"] == "granite" else key, []).append(key)
    futures = {}
    for keys in by_arch.values():
        chain = pool.submit(lambda ks: {k: _references(k, 0) for k in ks}, keys)
        for k in keys:
            futures[k] = (chain, k)
    pool.shutdown(wait=False)
    return futures


def _references(key, k):
    """Step k from the sharded run's state before it, through the port's
    one-device step (G = the data axes' size) and the reference's jitted step:
    [(metrics, m leaves)] for each."""
    c = W.CASES[key]
    params, m, v, step, err = _state_before(c, key, k)
    batch = W.batches(c)[k]
    comp = c["compress"]
    tp = convert.params_from_numpy(params, device="cpu")
    tstate = TO.OptState(torch.tensor(step, dtype=torch.int32),
                         convert.params_from_numpy(m, device="cpu"),
                         convert.params_from_numpy(v, device="cpu"))
    tstep = TT.make_train_step(W.cfg_of(c["arch"]), W.opt_cfg(), n_micro=W.N_MICRO,
                               compression=TC.CompressionConfig() if comp else None,
                               token_groups=W.token_groups(c))
    tb = {kk: torch.as_tensor(vv) for kk, vv in batch.items()}
    if comp:
        _, ts, _, tm = tstep(tp, tstate, convert.params_from_numpy(err, device="cpu"), tb)
    else:
        _, ts, tm = tstep(tp, tstate, tb)
    jstate = JO.OptState(jnp.asarray(step, jnp.int32), m, v)
    jb = {kk: jnp.asarray(vv) for kk, vv in batch.items()}
    jstep = _jstep(c["arch"], W.token_groups(c), comp)
    out = jstep(params, jstate, err, jb) if comp else jstep(params, jstate, jb)
    js, jm = out[1], out[-1]
    return [({n: float(x) for n, x in tm.items()}, [x.numpy() for x in leaves(ts.m)]),
            ({n: float(x) for n, x in jm.items()},
             [np.asarray(x) for x in jax.tree_util.tree_leaves(js.m)])]


def _held(got_metrics, got_m, ref_metrics, ref_m, what, compressed=False):
    """The bars. ``compressed``: the first moment is 0.1·clip·g_hat from one state,
    and a data-summed gradient rounds apart from one device's (or the reference's
    ``pow`` from the port's) by an ulp, which can move an int8 code by one step;
    as in tests/test_torch_training.py's compression bar, at most 1e-3 of a
    leaf's elements may then differ by up to one code step (its max / 127)."""
    for name, tol in (("loss", LOSS_RTOL), ("grad_norm", GNORM_RTOL)):
        a, b = got_metrics[name], ref_metrics[name]
        assert abs(a - b) <= tol * abs(b), f"{what} {name}: {a} vs {b}"
    assert len(got_m) == len(ref_m)
    for i, (a, b) in enumerate(zip(got_m, ref_m)):
        scale = float(np.abs(b).max()) + 1e-30
        d = np.abs(a - b) / scale
        if compressed and a.ndim >= 2:
            moved = d > MOMENT_TOL
            assert moved.mean() <= 1e-3 and d.max() <= 1.01 / 127, \
                f"{what}: first moment leaf {i}: {moved.sum()} of {a.size} elements off, " \
                f"by up to {d.max()} of its max"
            continue
        assert d.max() <= MOMENT_TOL, f"{what}: first moment leaf {i} off by {d.max()} of its max"


# ------------------------------------------------------------------------ world cases

@pytest.mark.parametrize("key", list(W.CASES))
def test_sharded_step_matches_one_device_and_reference(key):
    chain, name = _first_steps()[key]     # from the initial state: while the ranks run
    res = _results(key)
    first = chain.result()[name]
    runs, counts, plan, share = res[0]
    c = W.CASES[key]
    size = c["dims"][0] * c["dims"][1]
    for rank in res:                       # every rank reports the whole batch's step
        assert [m for m, _ in res[rank][0]] == [m for m, _ in runs], rank
    assert plan["tier"] == (c["tier"] or "tp_full") and plan["fsdp"]
    assert plan["moe_mode"] == ("ep" if c["arch"] == "granite" and plan["tier"] != "dp_only"
                                else "none")
    assert share <= 1 / size + 0.06, share           # FSDP (and TP) shard the state
    dp = W.token_groups(c)
    assert counts["grad_sum"] == (W.STEPS if dp > 1 else 0)
    assert counts["loss_sum"] == (W.STEPS * W.N_MICRO if dp > 1 else 0)
    assert counts["norm_sum"] == W.STEPS
    tp_split = c["dims"][1] > 1 and c["tier"] != "dp_only"
    assert (counts["f_sum"] > 0) == (counts["g_sum"] > 0) == tp_split
    for k in range(W.STEPS):
        got_metrics, state = runs[k]
        got_m = [np.asarray(x) for x in jax.tree_util.tree_leaves(state["m"])]
        refs = first if k == 0 else _references(key, k)
        for (ref_metrics, ref_m), who in zip(refs, ("port", "reference")):
            _held(got_metrics, got_m, ref_metrics, ref_m, f"{key} step {k} vs {who}",
                  compressed=c["compress"])


def test_elastic_restore_on_one_device():
    """sc-data2's checkpoint after 2 steps restores on one device (bitwise the
    sharded run's gathered state), a third step there is held against 3
    uninterrupted one-device steps; a one-device checkpoint restores onto a
    data-2 mesh as each rank's shards."""
    c = W.CASES[W.ELASTIC]
    cfg = W.cfg_of(c["arch"])
    fresh = lambda: convert.params_from_numpy(_trees()[c["arch"]], device="cpu")  # noqa: E731
    _results(W.ELASTIC)                               # the world has saved it
    p0 = fresh()
    template = {"params": p0, "opt": TO.init(p0)}
    state, step = CheckpointManager(os.path.join(_ckpt_dir(), "elastic")).restore(
        template, device="cpu")
    assert step == W.STEPS and int(state["opt"].step) == W.STEPS
    gathered = _results(W.ELASTIC)[0][0][-1][1]
    for a, b in zip(leaves(state["params"]), jax.tree_util.tree_leaves(gathered["params"])):
        np.testing.assert_array_equal(a.numpy(), b)
    tstep = TT.make_train_step(cfg, W.opt_cfg(), n_micro=W.N_MICRO)
    bs = [{k: torch.as_tensor(v) for k, v in b.items()} for b in W.batches(c, 3)]
    _, o3, m3 = tstep(state["params"], state["opt"], bs[2])
    p, o = fresh(), TO.init(fresh())
    for b in bs:
        p, o, m = tstep(p, o, b)
    _held({k: float(v) for k, v in m3.items()}, [x.numpy() for x in leaves(o3.m)],
          {k: float(v) for k, v in m.items()}, [x.numpy() for x in leaves(o.m)],
          "restored third step vs uninterrupted")
    # the reverse: a one-device checkpoint onto either rank of a data-2 mesh
    d = tempfile.mkdtemp(prefix="torch_train_ckpt1_")
    try:
        ckpt = CheckpointManager(d, keep_n=1)
        ckpt.save(3, {"params": p, "opt": o}, blocking=True)
        shards = []
        for r in range(2):
            mesh = _fake_mesh(r, data=2, model=1)
            layout = train_layout(cfg, mesh)
            mine = layout.shard(fresh())
            tmpl = {"params": mine, "opt": TO.init(mine)}
            got, _ = ckpt.restore(tmpl, placements=layout.state_placements(tmpl), mesh=mesh)
            assert [tuple(x.shape) for x in leaves(got)] == [tuple(x.shape)
                                                              for x in leaves(tmpl)]
            shards.append(got)
        for name, full in (("params", p), ("opt", o)):
            joined = SP.unshard_tree([s[name] if name == "params" else s[name].m
                                      for s in shards], layout.placements, dict(mesh.shape))
            want = full if name == "params" else full.m
            for a, b in zip(leaves(joined), leaves(want)):
                assert torch.equal(a, b)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def test_launcher_restarts_bitwise_at_data2():
    res = _results("launch")
    for r in res.values():
        assert r["restarts"] == [1, 0]
        assert r["steps"] == [list(range(4))] * 2
        assert r["bitwise"]
    assert res[0]["loss"] == res[1]["loss"]


def test_elastic_mesh_over_survivors():
    res = _results("elastic-mesh")
    assert res[2] is None and res[3] is None
    for r in (0, 1):
        got = res[r]
        assert got["shape"] == {"data": 2, "model": 1} and got["rank"] == r
        assert got["roundtrip"] and got["group_size"] == 2
    assert res[0]["loss"] == res[1]["loss"]
    # the same step as sc-data2's first (the same tree, batch and mesh shape)
    first = _results(W.ELASTIC)[0][0][0][0]
    assert res[0]["loss"] == first["loss"] and res[0]["grad_norm"] == first["grad_norm"]


# ------------------------------------------------------------------------ one process

def test_grouped_moe_apply_matches_reference():
    """granite-moe's ``moe_apply`` at G = 2 (capacity factor 0.5, so the groups'
    capacities drop other pairs than one dispatch would) against the reference's
    grouped path under ``jax.jit``: the output, the aux loss and the gradients of
    both with respect to every expert leaf, the router and the input."""
    kw = dict(dtype="float32", capacity_factor=0.5)
    cfg_j = dataclasses.replace(jget("granite-moe-3b-a800m", smoke=True), **kw)
    cfg_t = dataclasses.replace(W.cfg_of("granite"), **kw)
    moe = jax.tree_util.tree_map(lambda t: np.asarray(t[0]),
                                 _trees()["granite"]["blocks"][0]["moe"])
    x = (np.random.default_rng(11).normal(size=(4, 16, cfg_t.d_model)) * 0.5).astype(np.float32)
    r = np.random.default_rng(12).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JMoE.moe_apply(p, xx, cfg_j, JQuantContext(cfg_j.quant))
        return jnp.sum(y * r) + aux, (y, aux)

    orig = hints.token_group_count
    hints.token_group_count = lambda n: 2 if n % 2 == 0 else 1
    try:
        (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(moe, x)
    finally:
        hints.token_group_count = orig
    outs = {}
    for G in (1, 2):
        tp = convert.params_from_numpy(moe, device="cpu")
        tp = map_tensors(tp, lambda t: t.requires_grad_())
        tx = torch.as_tensor(x).requires_grad_()
        y, aux = TMoE.moe_apply(tp, tx, cfg_t, QuantContext(cfg_t.quant, token_groups=G))
        (torch.sum(y * torch.as_tensor(r)) + aux).backward()
        outs[G] = (y.detach().numpy(), float(aux.detach()), [t.grad.numpy() for t in leaves(tp)],
                   tx.grad.numpy())
    y, aux, gp, gx = outs[2]
    scale = float(np.abs(jy).max())
    assert float(np.abs(y - np.asarray(jy)).max()) <= 1e-5 * scale
    assert abs(aux - float(jaux)) <= 1e-5 * abs(float(jaux))
    for a, b in zip(gp + [gx], jax.tree_util.tree_leaves(jgp) + [jgx]):
        b = np.asarray(b)
        assert float(np.abs(a - b).max()) <= 2e-5 * (float(np.abs(b).max()) + 1e-30)
    # one group of all rows is another function (other capacities, other drops)
    assert float(np.abs(outs[1][0] - y).max()) > 1e-3 * scale


def test_elastic_plan_matches_reference():
    for n, gb in [(16, 256), (15, 256), (7, 256), (3, 4), (5, 5), (1, 3), (9, 6)]:
        assert TEL.usable_dp(n, gb) == JEL.usable_dp(n, gb)
    for n, tp, gb in [(256, 16, None), (240, 16, 256), (4, 2, None), (3, 1, 4), (7, 2, 6),
                      (2, 2, 1)]:
        assert TEL.plan_mesh_shape(n, tp, gb) == JEL.plan_mesh_shape(n, tp, gb)
    for n, tp in [(8, 16), (1, 2)]:
        for fn in (TEL.plan_mesh_shape, JEL.plan_mesh_shape):
            with pytest.raises(ValueError):
                fn(n, tp)


def _fake_mesh(rank=0, **axes):
    """A mesh with the axis sizes and this rank's coordinates, and no process group
    (nothing here runs a collective)."""
    names = tuple(axes)
    dims = [axes[n] for n in names]
    coords, rem = {}, rank
    for n, d in zip(reversed(names), reversed(dims)):
        coords[n], rem = rem % d, rem // d
    return Mesh(names, dict(axes), coords, rank, {n: None for n in names})


@pytest.mark.parametrize("arch,axes,force,quant,compress,item", [
    ("mamba2-130m", dict(data=1, model=2), None, None, False, "A4"),
    ("zamba2-1.2b", dict(data=2, model=2), None, None, False, "A4"),
    ("pixtral-12b", dict(data=1, model=2), None, None, False, "A4"),
    ("granite-moe-3b-a800m", dict(data=1, model=2), "expert_tp", None, False, "A5"),
    ("granite-moe-3b-a800m", dict(data=1, model=1, expert=2), None, None, False, "A5"),
    ("starcoder2-7b", dict(data=2, model=1), None, tql.W8A8_CROSSQUANT, False, "A6"),
    ("starcoder2-7b", dict(data=1, model=2), None, None, True, "A7"),
])
def test_typed_refusals(arch, axes, force, quant, compress, item):
    cfg = dataclasses.replace(tget(arch, smoke=True), dtype="float32")
    mesh = _fake_mesh(**axes)
    plan = SP.make_plan(cfg, SP.ShapeConfig(name="train", seq_len=0, global_batch=0,
                                            kind="train"), mesh)
    if force:
        plan = dataclasses.replace(plan, moe_mode=force)
    comp = TC.CompressionConfig() if compress else None
    with pytest.raises(SP.ShardedTrainingError, match=f"ROADMAP {item}"):
        TT.make_train_step(cfg, W.opt_cfg(), quant=quant, compression=comp, mesh=mesh,
                           plan=plan)
    # the same case without the refused part builds its step
    ok_axes = dict(axes, model=1, expert=1) if item in ("A4", "A5", "A7") else axes
    ok = _fake_mesh(**{k: v for k, v in ok_axes.items() if k in ("data", "model")})
    assert TT.make_train_step(cfg, W.opt_cfg(), compression=comp, mesh=ok).layout is not None
