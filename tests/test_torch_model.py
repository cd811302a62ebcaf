"""Parity of the PyTorch port's dense model with the JAX reference (CPU).

starcoder2-7b SMOKE in float32. The reference's params (``init_params``) and
prepared tree (``quantize_tree``) cross over through ``repro_torch.convert``.
A right-padded two-row prefill with a 130-token prompt (so the reference takes
its Pallas flash-attention path and the port its flash wrapper) and 4 decode
steps are compared logit by logit:

* fp path: atol 1e-4 (same math, other summation order);
* fused-int8 path: within 1e-2 · max|logit| with equal argmax — a last-ulp
  difference in an activation can move an int8 code by one at a rounding
  boundary, which the integer GEMM then carries exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import calibration as jcal, qlinear as jql  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import QuantContext as JQC  # noqa: E402
from repro.models.quantize import quantize_tree as j_quantize_tree  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import QuantContext as TQC  # noqa: E402
from repro_torch.models.quantize import quantize_tree as t_quantize_tree  # noqa: E402

torch.set_num_threads(2)

T = 160
LENS = np.array([130, 97], np.int32)
N_DECODE = 4


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(jget("starcoder2-7b", smoke=True), dtype="float32")
    cfg_t = dataclasses.replace(tget("starcoder2-7b", smoke=True), dtype="float32")
    params = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    # calibrated tables: the prepared tree carries alpha = 0.15 (pow on both sides)
    obs = jcal.Observer()
    toks = np.random.default_rng(5).integers(0, cfg_j.vocab, size=(2, 16)).astype(np.int32)
    JM.apply(params, {"tokens": jnp.asarray(toks)}, cfg_j,
             ctx=JQC(jql.W8A8_INT8, observer=obs), mode="train", unroll=True)
    tables = jcal.stack_tables(obs.tables())
    qparams = j_quantize_tree(params, jql.W8A8_INT8, tables=tables)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return cfg_j, cfg_t, params, qparams, to_np(params), to_np(qparams), tables


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


class TestBridge:
    def test_convert_keeps_names_and_layer_axis(self, setup):
        cfg_j, _, _, _, np_params, np_q, _ = setup
        for src in (np_params, np_q):
            tp = convert.params_from_numpy(src, device="cpu")
            want = dict(_leaves(src))
            got = dict(_leaves(convert.params_to_numpy(tp)))
            assert sorted(got) == sorted(want)
            for name in want:
                np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        tq = convert.params_from_numpy(np_q, device="cpu")
        wq = tq["blocks"][0]["attn"]["wq"]
        assert sorted(wq) == ["bcol", "qalpha", "qw", "sw"]
        assert wq["qw"].shape == (cfg_j.n_layers, cfg_j.d_model, cfg_j.n_heads * cfg_j.head_dim)
        assert wq["qw"].dtype == torch.int8 and wq["qalpha"].shape == (cfg_j.n_layers,)

    def test_quantize_tree_matches(self, setup):
        """The port's quantize_tree on the converted raw tree reproduces the
        reference's prepared tree: bitwise where no pow enters (c = 1), and to
        off-by-one codes at ≤ 1e-4 of the elements with calibrated tables."""
        _, _, params, _, np_params, np_q, tables = setup
        for tbl, want_np in ((None, jax.tree_util.tree_map(
                np.asarray, j_quantize_tree(params, jql.W8A8_INT8))), (tables, np_q)):
            got = t_quantize_tree(convert.params_from_numpy(np_params, device="cpu"),
                                  tql.W8A8_INT8, tables=tbl)
            want = dict(_leaves(want_np))
            got = dict(_leaves(convert.params_to_numpy(got)))
            assert sorted(got) == sorted(want)
            for name in want:
                if tbl is None or not name.endswith(("/qw", "/sw", "/bcol")):
                    np.testing.assert_array_equal(got[name], want[name], err_msg=name)
                elif name.endswith("/qw"):
                    d = np.abs(got[name].astype(np.int32) - want[name].astype(np.int32))
                    assert d.max() <= 1 and (d > 0).mean() <= 1e-4, name
                else:
                    np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                               err_msg=name)


def _run_jax(cfg, params, ctx, prompts, forced):
    caches = JM.init_cache(cfg, len(LENS), T, dtype=jnp.float32)
    logits, ex = JM.apply(params, {"tokens": jnp.asarray(prompts)}, cfg, ctx=ctx,
                          mode="prefill", caches=caches, cur_len=jnp.asarray(LENS))
    out = [np.asarray(logits[:, -1])]
    caches = ex["caches"]
    for i in range(N_DECODE):
        logits, ex = JM.apply(params, {"tokens": jnp.asarray(forced[:, i:i + 1])}, cfg,
                              ctx=ctx, mode="decode", caches=ex["caches"],
                              cur_len=jnp.asarray(LENS + i + 1))
        out.append(np.asarray(logits[:, -1]))
    return out


def _run_torch(cfg, params, ctx, prompts, forced):
    caches = TM.init_cache(cfg, len(LENS), T, dtype=torch.float32, device="cpu")
    logits, _ = TM.apply(params, {"tokens": torch.as_tensor(prompts, dtype=torch.int64)},
                         cfg, ctx=ctx, mode="prefill", caches=caches,
                         cur_len=torch.as_tensor(LENS))
    out = [logits[:, -1].numpy()]
    for i in range(N_DECODE):
        logits, _ = TM.apply(params, {"tokens": torch.as_tensor(forced[:, i:i + 1],
                                                                 dtype=torch.int64)},
                             cfg, ctx=ctx, mode="decode", caches=caches,
                             cur_len=torch.as_tensor(LENS + i + 1))
        out.append(logits[:, -1].numpy())
    return out


class TestLogits:
    @pytest.mark.parametrize("path", ["fp", "fused-int8"])
    def test_prefill_and_decode(self, setup, path):
        cfg_j, cfg_t, params, qparams, np_params, np_q, _ = setup
        rng = np.random.default_rng(9)
        prompts = np.zeros((len(LENS), LENS.max()), np.int32)
        for b, n in enumerate(LENS):
            prompts[b, :n] = rng.integers(1, cfg_j.vocab, size=n)
        forced = rng.integers(1, cfg_j.vocab, size=(len(LENS), N_DECODE)).astype(np.int32)
        if path == "fp":
            jp, tp = params, convert.params_from_numpy(np_params, device="cpu")
            jctx, tctx = JQC(jql.FP), TQC(tql.FP)
        else:
            jp, tp = qparams, convert.params_from_numpy(np_q, device="cpu")
            jctx = JQC(jql.W8A8_INT8, use_pallas=True, int_exec="pallas")
            tctx = TQC(tql.W8A8_INT8, use_kernels=True, int_exec="kernel")
        want = _run_jax(cfg_j, jp, jctx, prompts, forced)
        got = _run_torch(cfg_t, tp, tctx, prompts, forced)
        for step, (g, w) in enumerate(zip(got, want)):
            w = w[:, :cfg_j.vocab]
            g = g[:, :cfg_t.vocab]
            if path == "fp":
                np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=f"step {step}")
            else:
                tol = 1e-2 * np.abs(w).max()
                np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"step {step}")
            np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1), err_msg=f"step {step}")
