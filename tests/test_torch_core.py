"""Parity of the PyTorch port's core numerics with the JAX reference (CPU).

Same numpy inputs through ``repro`` (the reference; its Pallas kernels run in
interpret mode through ``repro.kernels.ops``) and ``repro_torch`` (whose kernel
wrappers take their plain versions for CPU tensors). Integer paths are bitwise;
where ``t**alpha`` or ``c**(1-alpha)`` enters, the two libraries' ``pow`` may
differ in the last ulp, so a code may move by one at a rounding boundary (at most
1e-4 of the elements) and the scales agree to rel 1e-6 (one ulp).

``quantize_act_int8`` is held against the reference as it serves it, under
``jax.jit``: XLA compiles its ``t**alpha / qmax`` into a multiply by the f32
reciprocal of qmax, which the eager call does not.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import calibration as jcal, qlinear as jql  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import QuantContext as JQuantContext  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import calibration as tcal, qlinear as tql  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import QuantContext as TQuantContext  # noqa: E402

torch.set_num_threads(2)


def _outlier_acts(rng, rows, cols, n_outliers=4, scale=40.0):
    """Activations with planted outlier channels (the paper's App. A regime)."""
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    ch = rng.choice(cols, size=n_outliers, replace=False)
    x[:, ch] *= scale
    return x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _jit_quantize_act(x, bcol, alpha):
    """The reference's ``quantize_act_int8`` as it serves: under ``jax.jit``."""
    fn = jax.jit(lambda x, b, a: jql.quantize_act_int8(x, b, jql.W8A8_INT8, alpha=a))
    return fn(jnp.asarray(x), jnp.asarray(bcol), jnp.asarray(alpha, jnp.float32))


def _off_by_one(got, want, frac=1e-4):
    """Codes equal except off-by-one at ≤ ``frac`` of the elements."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max(initial=0) <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


class TestPrepareAndQuantizeAct:
    @pytest.mark.parametrize("calibrated", [False, True])
    def test_prepare_int8(self, calibrated):
        rng = np.random.default_rng(1)
        w = (rng.standard_normal((512, 384)) * 0.05).astype(np.float32)
        x = _outlier_acts(rng, 256, 512)
        cmax = np.abs(x).max(axis=0) if calibrated else None
        want = jql.prepare_int8({"w": jnp.asarray(w)}, jql.W8A8_INT8,
                                None if cmax is None else jnp.asarray(cmax))
        got = tql.prepare_int8({"w": _t(w)}, tql.W8A8_INT8,
                               None if cmax is None else _t(cmax))
        want = {k: np.asarray(v) for k, v in want.items()}
        got = {k: v.numpy() for k, v in got.items()}
        assert got["qw"].dtype == np.int8 and got["qw"].shape == want["qw"].shape
        np.testing.assert_array_equal(got["qalpha"], want["qalpha"])
        if calibrated:
            _off_by_one(got["qw"], want["qw"])
            np.testing.assert_allclose(got["sw"], want["sw"], rtol=1e-6)
            np.testing.assert_allclose(got["bcol"], want["bcol"], rtol=1e-6)
        else:
            for k in ("qw", "sw", "bcol"):
                np.testing.assert_array_equal(got[k], want[k])

    @pytest.mark.parametrize("alpha", [1.0, 0.15])
    def test_quantize_act_int8(self, alpha):
        rng = np.random.default_rng(2)
        x = _outlier_acts(rng, 2 * 96, 256).reshape(2, 96, 256)
        bcol = np.maximum(np.abs(x).reshape(-1, 256).max(axis=0), 1e-8) ** (1 - alpha)
        bcol = bcol.astype(np.float32)
        qa = np.float32(alpha)
        jq, ja = _jit_quantize_act(x, bcol, qa)
        tq, ta = tql.quantize_act_int8(_t(x), _t(bcol), tql.W8A8_INT8,
                                       alpha=torch.tensor(qa))
        if alpha == 1.0:
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        else:
            _off_by_one(tq.numpy(), np.asarray(jq))
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)

    def test_quantize_act_int8_reciprocal_bitwise(self):
        """At α = 1 (no ``pow``) the port's row scale is bitwise the jitted
        reference's on 4096 outlier rows: ``t · (1/qmax)``, not ``t / qmax``,
        which differs in the last ulp on a few percent of rows."""
        rng = np.random.default_rng(11)
        x = _outlier_acts(rng, 4096, 256)
        bcol = rng.uniform(0.5, 4.0, size=256).astype(np.float32)
        jq, ja = _jit_quantize_act(x, bcol, np.float32(1.0))
        tq, ta = tql.quantize_act_int8(_t(x), _t(bcol), tql.W8A8_INT8,
                                       alpha=torch.tensor(1.0))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))

    def test_quantize_act_int8_pow_within_one_ulp(self):
        """At α = 0.15 torch's and XLA's f32 ``pow`` differ by one ulp on a few
        percent of rows; the row scale never differs by more."""
        rng = np.random.default_rng(12)
        x = _outlier_acts(rng, 4096, 256)
        bcol = rng.uniform(0.5, 4.0, size=256).astype(np.float32)
        _, ja = _jit_quantize_act(x, bcol, np.float32(0.15))
        _, ta = tql.quantize_act_int8(_t(x), _t(bcol), tql.W8A8_INT8,
                                      alpha=torch.tensor(0.15))
        ulps = np.abs(ta.numpy().view(np.int32).astype(np.int64)
                      - np.asarray(ja).view(np.int32).astype(np.int64))
        assert ulps.max() <= 1, ulps.max()


class TestKernelPlainVersions:
    @pytest.mark.parametrize("M,K", [(100, 300), (4, 512), (33, 64)])
    @pytest.mark.parametrize("dyn", [False, True])
    def test_act_quantize(self, M, K, dyn):
        rng = np.random.default_rng(M + K)
        x = _outlier_acts(rng, M, K)
        bcol = rng.uniform(0.5, 4.0, size=K).astype(np.float32)
        if dyn:
            # the prepared tree's per-layer qalpha: 1.0 (uncalibrated) is pow-free
            jq, ja = jops.act_quantize_dyn(jnp.asarray(x), jnp.asarray(bcol),
                                           jnp.asarray(1.0, jnp.float32))
            tq, ta = tops.act_quantize(_t(x), _t(bcol), torch.tensor(1.0))
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        else:
            jq, ja = jops.act_quantize(jnp.asarray(x), jnp.asarray(bcol), alpha=0.15)
            tq, ta = tops.act_quantize(_t(x), _t(bcol), 0.15)
            _off_by_one(tq.numpy(), np.asarray(jq))
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
        assert tq.dtype == torch.int8 and tq.shape == (M, K) and ta.shape == (M, 1)
        assert tops.LAUNCHES["act_quantize"] == 0     # CPU tensors never launch

    @pytest.mark.parametrize("M,K,N", [(100, 300, 70), (4, 256, 512), (1, 128, 128)])
    def test_qgemm_w8a8_bitwise(self, M, K, N):
        rng = np.random.default_rng(M * K + N)
        qx = rng.integers(-127, 128, size=(M, K)).astype(np.int8)
        qw = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
        a = rng.uniform(0.01, 1.0, size=(M, 1)).astype(np.float32)
        sw = rng.uniform(0.01, 1.0, size=N).astype(np.float32)
        want = np.asarray(jops.qgemm_w8a8(jnp.asarray(qx), jnp.asarray(qw), jnp.asarray(a),
                                          jnp.asarray(sw)))
        got = tops.qgemm_w8a8(_t(qx), _t(qw), _t(a), _t(sw)).numpy()
        np.testing.assert_array_equal(got, want)

    def test_qgemm_int32_worst_case(self):
        """127·127·K is exact in the float64 product (|acc| < 2^53)."""
        K = 18432
        qx = torch.full((2, K), 127, dtype=torch.int8)
        qw = torch.full((K, 3), 127, dtype=torch.int8)
        out = tops.qgemm_w8a8(qx, qw, torch.ones(2, 1), torch.ones(3))
        assert float(out[0, 0]) == np.float32(127 * 127 * K)

    def test_wrapper_rejects_bad_shapes(self):
        with pytest.raises(ValueError):
            tops.qgemm_w8a8(torch.zeros(4, 8, dtype=torch.int8),
                            torch.zeros(9, 2, dtype=torch.int8), torch.ones(4, 1),
                            torch.ones(2))
        with pytest.raises(ValueError):
            tops.act_quantize(torch.zeros(4, 8), torch.ones(7))


class TestCalibration:
    def test_observer_tables_match(self):
        cfg_j = dataclasses.replace(jget("starcoder2-7b", smoke=True), dtype="float32")
        cfg_t = dataclasses.replace(tget("starcoder2-7b", smoke=True), dtype="float32")
        import jax
        params = JM.init_params(jax.random.PRNGKey(0), cfg_j)
        tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                            device="cpu")
        rng = np.random.default_rng(3)
        batches = [rng.integers(0, cfg_j.vocab, size=(2, 16)).astype(np.int32)
                   for _ in range(2)]
        jobs, tobs = jcal.Observer(), tcal.Observer()
        for toks in batches:
            JM.apply(params, {"tokens": jnp.asarray(toks)}, cfg_j,
                     ctx=JQuantContext(jql.W8A8_INT8, observer=jobs), mode="train",
                     unroll=True)
            TM.apply(tparams, {"tokens": torch.as_tensor(toks, dtype=torch.int64)}, cfg_t,
                     ctx=TQuantContext(tql.W8A8_INT8, observer=tobs), mode="train",
                     unroll=True)
        jt = jcal.stack_tables(jobs.tables())
        tt = tcal.stack_tables(tobs.tables())
        assert sorted(jt) == sorted(tt)
        assert tt["blocks/0/attn/wq"].shape == (cfg_t.n_layers, cfg_t.d_model)
        for name in jt:
            np.testing.assert_allclose(tt[name], jt[name], rtol=1e-6, err_msg=name)
