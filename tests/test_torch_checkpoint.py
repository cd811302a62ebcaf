"""The PyTorch port's checkpoint manager, supervisor, straggler barrier, data
loader, outlier data, ``attach_calibration`` and training launcher (CPU).

* ``CheckpointManager``: bitwise round trips of f32, bf16 and prepared int8 trees
  (and the optimizer state), latest and specific steps, ``keep_n`` GC, an async
  save that copies the tree before it returns, a corrupted leaf and a missing
  leaf raising, a ``.tmp`` staging directory never visible; a params checkpoint
  written by the JAX manager restores in the port bitwise, and the reverse.
* ``Supervisor``: a run with injected failures ends bitwise equal to a clean run,
  the restart budget, the rebuild hook and the history truncated at the restore
  point, as ``tests/test_runtime.py`` holds the reference's, on numpy and on
  torch states.
* ``DeadlineBarrier`` and ``HeartbeatTracker``, ``HostDataLoader``,
  ``outlier_activations`` / ``calibration_set`` and ``attach_calibration`` equal
  the reference's outputs on the same inputs.
* ``launch.train.run`` on the CPU with ``fail_at`` ends with the params of the
  same run without it, bitwise.

Nothing here sleeps to synchronise: async saves are joined with ``wait()``, the
loader's queue is read until the wanted steps arrive.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.core import calibration as jcal  # noqa: E402
from repro.data import HostDataLoader as JLoader, make_train_batches as j_batches  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import DeadlineBarrier as JBarrier  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import calibration as tcal, qlinear as tql  # noqa: E402
from repro_torch.data import HostDataLoader, make_train_batches  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.quantize import quantize_tree  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    DeadlineBarrier, FailureInjector, HeartbeatTracker, Supervisor, WorkerFailure)
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.models.model import leaves  # noqa: E402

torch.set_num_threads(2)


def _params(dtype=torch.float32):
    cfg = tget("starcoder2-7b", smoke=True)
    p = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    return TM.map_tensors(p, lambda t: t.to(dtype)), cfg


def _equal_trees(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        else:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------------------ manager

@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "opt"])
def test_round_trip_bitwise(tmp_path, kind):
    params, cfg = _params(torch.bfloat16 if kind == "bf16" else torch.float32)
    if kind == "int8":
        tree = quantize_tree(params, tql.W8A8_INT8)
    elif kind == "opt":
        opt = TO.init(params)
        opt = TO.OptState(opt.step + 3, TM.map_tensors(opt.m, lambda t: t + 0.5), opt.v)
        tree = {"params": params, "opt": opt}
    else:
        tree = params
    cm = CheckpointManager(str(tmp_path))
    cm.save(7, tree, blocking=True)
    back, step = cm.restore(tree)
    assert step == 7
    _equal_trees(tree, back)
    if kind == "opt":
        assert isinstance(back["opt"], TO.OptState) and int(back["opt"].step) == 3
        manifest = json.load(open(tmp_path / "step_000000007" / "manifest.json"))
        assert {"opt/step", "opt/m/embed/w", "opt/v/embed/w"} <= set(manifest["leaves"])
    if kind == "bf16":
        manifest = json.load(open(tmp_path / "step_000000007" / "manifest.json"))
        assert manifest["leaves"]["embed/w"]["dtype"] == "bfloat16"
        with np.load(tmp_path / "step_000000007" / "arrays.npz") as z:
            assert z["embed/w"].dtype == np.dtype("V2")


def test_steps_gc_async_and_placement(tmp_path):
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "l": [torch.ones(2, dtype=torch.int32), np.full(3, 2.5, np.float32)]}
    cm = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (1, 2, 3):
        cm.save(s, tree)
        tree["w"].add_(1.0)                  # in place, at once: the save holds a copy
    cm.wait()
    assert cm.all_steps() == [2, 3] and cm.latest_step() == 3
    back, step = cm.restore(tree, step=2)
    assert step == 2 and torch.equal(back["w"], torch.arange(12.).reshape(3, 4) + 1)
    assert isinstance(back["l"][1], np.ndarray) and back["l"][1].dtype == np.float32
    back, step = cm.restore(tree)
    assert step == 3 and torch.equal(back["w"], torch.arange(12.).reshape(3, 4) + 2)
    on = cm.restore(tree, device="cpu")[0]
    assert isinstance(on["l"][1], torch.Tensor)
    # a crash mid-write leaves a staging directory: never visible as a step
    (tmp_path / "step_000000009.tmp").mkdir()
    (tmp_path / "step_000000009.tmp" / "manifest.json").write_text("{}")
    assert cm.all_steps() == [2, 3] and cm.latest_step() == 3
    with pytest.raises(KeyError, match="missing leaf"):
        cm.restore({**tree, "extra": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)


def test_corruption_raises(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    tree = {"w": torch.randn(8, 8, generator=torch.Generator().manual_seed(1))}
    cm.save(1, tree, blocking=True)
    path = tmp_path / "step_000000001" / "manifest.json"
    manifest = json.load(open(path))
    manifest["leaves"]["w"]["crc32"] ^= 1
    path.write_text(json.dumps(manifest))
    with pytest.raises(IOError, match="corruption"):
        cm.restore(tree)
    assert torch.equal(cm.restore(tree, verify=False)[0]["w"], tree["w"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_checkpoints_cross_between_managers(tmp_path, dtype):
    cfg = dataclasses.replace(jget("starcoder2-7b", smoke=True), dtype=dtype)
    raw = JM.init_params(jax.random.PRNGKey(0), cfg)
    if dtype == "bfloat16":
        raw = jax.tree_util.tree_map(lambda a: a.astype(jax.numpy.bfloat16), raw)
    JManager(str(tmp_path / "j")).save(3, raw, blocking=True)
    template = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, raw),
                                         device="cpu")
    zeros = TM.map_tensors(template, torch.zeros_like)
    got, step = CheckpointManager(str(tmp_path / "j")).restore(zeros)
    assert step == 3
    _equal_trees(template, got)
    CheckpointManager(str(tmp_path / "t")).save(4, template, blocking=True)
    back, step = JManager(str(tmp_path / "t")).restore(raw)
    assert step == 4
    for a, b in zip(jax.tree_util.tree_leaves(raw), jax.tree_util.tree_leaves(back)):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


# ------------------------------------------------------------------------ supervisor

def _deterministic_step(state, step):
    v = np.float32((step * 2654435761) % 97)
    return {"x": state["x"] + v}, {"v": float(v)}


def _torch_step(state, step):
    """An in-place update, as the training step makes."""
    state["x"].mul_(0.5).add_(float((step * 2654435761) % 97))
    return state, {"v": float(state["x"][0])}


@pytest.mark.parametrize("flavour", ["numpy", "torch"])
def test_restart_bitwise_determinism(tmp_path, flavour):
    def run(fail, sub):
        cm = CheckpointManager(str(tmp_path / sub), keep_n=10)
        sup = Supervisor(cm, ckpt_every=4)
        inj = FailureInjector(fail_at_steps=fail) if fail else None
        if flavour == "numpy":
            return sup.run({"x": np.zeros(4, np.float32)}, _deterministic_step, 21,
                           injector=inj)
        return sup.run({"x": torch.zeros(4)}, _torch_step, 21, injector=inj)
    clean, faulty = run((), "clean"), run((3, 10, 17), "faulty")
    if flavour == "numpy":
        np.testing.assert_array_equal(clean.state["x"], faulty.state["x"])
    else:
        assert torch.equal(clean.state["x"], faulty.state["x"])
    assert faulty.restarts == 3 and clean.restarts == 0
    assert [h["step"] for h in faulty.metrics_history] == list(range(21))
    assert faulty.metrics_history == clean.metrics_history


def test_restart_budget_rebuild_and_history(tmp_path):
    class AlwaysFail:
        def check(self, step):
            if step == 1:
                raise WorkerFailure("flaky node")
    sup = Supervisor(CheckpointManager(str(tmp_path / "a"), keep_n=10), ckpt_every=100,
                     max_restarts=2)
    with pytest.raises(RuntimeError, match="restart budget"):
        sup.run({"x": np.zeros(1, np.float32)}, _deterministic_step, 5, injector=AlwaysFail())
    calls = []

    def rebuild(state):
        calls.append(1)
        return state
    sup = Supervisor(CheckpointManager(str(tmp_path / "b"), keep_n=10), ckpt_every=2)
    sup.run({"x": np.zeros(1, np.float32)}, _deterministic_step, 6,
            injector=FailureInjector(fail_at_steps=(3,)), rebuild=rebuild)
    assert calls == [1]
    sup = Supervisor(CheckpointManager(str(tmp_path / "c"), keep_n=10), ckpt_every=4)
    res = sup.run({"x": np.zeros(1, np.float32)}, _deterministic_step, 9,
                  injector=FailureInjector(fail_at_steps=(6,)))
    steps = [h["step"] for h in res.metrics_history]
    assert steps == sorted(set(steps)) == list(range(9)) and res.restarts == 1


# ------------------------------------------------------------------------ runtime, data

def test_deadline_barrier_matches_reference():
    rng = np.random.default_rng(0)
    rows = [list(1.0 + 0.05 * rng.random(4)) for _ in range(10)]
    rows += [[1.0, 1.0, 1.0, 10.0]] * 4 + [[1.0, 1.0, 9.0, 1.0]] + [[1.0] * 4] * 3
    for kw in ({}, {"quantile": 0.9, "slack": 1.5, "evict_after": 3}, {"min_history": 16}):
        a, b = DeadlineBarrier(4, **kw), JBarrier(4, **kw)
        for row in rows:
            assert a.step(row) == b.step(row)
        np.testing.assert_array_equal(a.misses, b.misses)
        np.testing.assert_array_equal(a.tracker.all_durations(), b.tracker.all_durations())
    h = HeartbeatTracker(2, window=3)
    for d in (1.0, 2.0, 3.0, 4.0):
        h.report(0, d)
    np.testing.assert_array_equal(h.all_durations(), [2.0, 3.0, 4.0])
    np.testing.assert_array_equal(HeartbeatTracker(3).all_durations(), [0.0])


def test_host_data_loader_matches_reference():
    f, jf = make_train_batches(64, 8, 4, seed=3), j_batches(64, 8, 4, seed=3)
    with HostDataLoader(f, start_step=2, depth=3) as dl, JLoader(jf, start_step=2, depth=3) as jl:
        for _ in range(5):
            (s, b), (js, jb) = next(dl), next(jl)
            assert s == js
            np.testing.assert_array_equal(b["tokens"], jb["tokens"])
    assert not dl._thread.is_alive()
    with pytest.raises(StopIteration):
        next(dl)


def test_outlier_data_matches_reference():
    for spec in (tsyn.OPT_LIKE, tsyn.LLAMA_LIKE, tsyn.OutlierSpec(frac_channels=0.01)):
        jspec = jsyn.OutlierSpec(**dataclasses.asdict(spec))
        for laplace in (True, False):
            np.testing.assert_array_equal(
                tsyn.outlier_activations(64, 300, spec, seed=5, laplace=laplace),
                jsyn.outlier_activations(64, 300, jspec, seed=5, laplace=laplace))
    for a, b in zip(tsyn.calibration_set(3, 16, 128, seed=2),
                    jsyn.calibration_set(3, 16, 128, seed=2)):
        np.testing.assert_array_equal(a, b)
    assert tsyn.OPT_LIKE == tsyn.OutlierSpec(frac_channels=0.004, magnitude=80.0, row_frac=0.9)


def test_attach_calibration_matches_reference():
    cfg = jget("granite-moe-3b-a800m", smoke=True)
    raw = jax.tree_util.tree_map(np.asarray, JM.init_params(jax.random.PRNGKey(0), cfg))
    raw["lm_head"] = {"w": np.ones((4, 3), np.float32)}
    rng = np.random.default_rng(0)
    tables = {"lm_head": rng.random(4).astype(np.float32),
              "blocks/0/attn/wq": rng.random((2, 64)).astype(np.float32),   # a list: skipped
              "embed": rng.random(8).astype(np.float32),
              "nowhere/wq": rng.random(3).astype(np.float32)}
    want = jax.tree_util.tree_map(np.asarray, jcal.attach_calibration(raw, tables))
    tparams = convert.params_from_numpy(raw, device="cpu")
    got = tcal.attach_calibration(tparams, tables)
    assert set(got) == set(want) and set(got["lm_head"]) == {"w", "cmax"}
    assert set(got["embed"]) == set(want["embed"]) == {"w", "cmax"}
    for a, b in zip(jax.tree_util.tree_leaves(want), leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), a)
    assert "cmax" not in tparams["lm_head"]                 # the input tree is untouched
    assert got["lm_head"]["cmax"].dtype == torch.float32


# ------------------------------------------------------------------------ launcher

def test_launch_train_restart_equals_uninterrupted(tmp_path, capsys):
    cfg = tget("mamba2-130m", smoke=True)
    kw = dict(steps=8, global_batch=4, seq_len=32, ckpt_every=3, log_every=100,
              device="cpu")
    faulty = launch_train.run(cfg, ckpt_dir=str(tmp_path / "f"), fail_at=(5,), **kw)
    clean = launch_train.run(cfg, ckpt_dir=str(tmp_path / "c"), **kw)
    assert faulty.restarts == 1 and clean.restarts == 0 and faulty.step == clean.step == 8
    assert faulty.metrics_history == clean.metrics_history
    _equal_trees(clean.state, faulty.state)
    assert "restarts=1" in capsys.readouterr().out
    args = launch_train.parse_args(["--arch", "mamba2-130m", "--smoke", "--fail-at", "2", "5"])
    assert args.device == "cuda" and args.fail_at == [2, 5] and args.n_micro == 1
