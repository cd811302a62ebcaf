"""The port's quantizers, §4.1 kernel analysis and ``make_sparsity_plan`` against
the JAX reference, run under ``jax.jit`` as the reference's serving steps run it
(XLA turns a division by the constant qmax into a multiply by 1/qmax there, and
the eager reference differs from its own jitted form).

* Quantizers: bitwise wherever no ``pow`` is involved (per-token, per-channel,
  per-tensor, group, CrossQuant at α = 1). At α < 1 each ``pow`` factor lies
  within one f32 ulp of XLA's, the scale is the reference's product of those
  factors bit for bit, and the codes move by one step on at most 1e-3 of the
  elements.
* Kernel analysis: masks bitwise under one scale tensor, counts equal (int64,
  exact past 2^24), ``remove_kernel_fraction`` bitwise against ``jnp.quantile``
  up to 2^24 elements and equal to an independent selection above it,
  ``table1_stats`` and ``KernelStats`` within 1e-6.
* ``make_sparsity_plan``: on the same activations (the jitted reference's
  observer pass replayed into both), the same layers and fractions within 1e-6
  at thresholds 1.0, -1.0 and one between the smoke model's fractions; through
  each package's own model pass, within the few elements that one-ulp ``pow``
  differences flip.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import kernel_analysis as JKA, qlinear as JQL, quantizers as JQ  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import QuantContext as JQuantContext  # noqa: E402
from repro.models import quantize as JMQ  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import kernel_analysis as TKA, quantizers as TQ  # noqa: E402
from repro_torch.models import model as TM, quantize as TMQ  # noqa: E402

torch.set_num_threads(2)

ALPHAS = (1.0, 0.15, 0.55)


def _act(seed: int, shape=(512, 1024)) -> np.ndarray:
    """Activation-like rows: normal draws scaled per column by a log-normal, so a
    few columns carry outliers (what CrossQuant's column factor is for)."""
    rng = np.random.default_rng(seed)
    col = np.exp(rng.standard_normal((1, shape[-1])) * 1.5)
    return (rng.standard_normal(shape) * col).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in f32 ulps (same-sign finite values)."""
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


# ======================================================================================
# Quantizers
# ======================================================================================

@pytest.mark.parametrize("shape", [(512, 1024), (3, 40, 96)])
def test_crossquant_scale_bitwise_at_alpha_one(shape):
    """The repair: ``(t^α · c^(1-α)) · (1/qmax)``, as the jitted reference forms
    it. Dividing by qmax instead differs on ~4 % of the elements at (512, 1024)."""
    x = _act(1, shape)
    for bits in (8, 4):
        want = np.asarray(_jit(JQ.crossquant_scale, 1, 2)(x, bits, 1.0))
        got = _np(TQ.crossquant_scale(_t(x), bits, 1.0))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alpha", [0.15, 0.55])
def test_crossquant_scale_within_pow_ulp(alpha):
    x = _act(2)
    t = np.maximum(np.abs(x).max(-1, keepdims=True), JQ.EPS)
    c = np.maximum(np.abs(x).max(0, keepdims=True), JQ.EPS)
    for v, e in ((t, alpha), (c, 1.0 - alpha)):
        want = np.asarray(jax.jit(lambda a, e=e: a ** e)(v))
        assert _ulps(_np(_t(v) ** e), want) <= 1
    # given the reference's two factors, the port forms the scale bit for bit
    jt = np.asarray(jax.jit(lambda a: a ** alpha)(t))
    jc = np.asarray(jax.jit(lambda a: a ** (1.0 - alpha))(c))
    want = np.asarray(_jit(JQ.crossquant_scale, 1, 2)(x, 8, alpha))
    np.testing.assert_array_equal(_np(_t(jt) * _t(jc) * (1.0 / 127)), want)
    got = _np(TQ.crossquant_scale(_t(x), 8, alpha))
    np.testing.assert_allclose(got, want, rtol=4 * 2.0 ** -23, atol=0)


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("bits", [8, 4])
def test_crossquant_codes_and_fake(alpha, bits):
    x = _act(3)
    jr = JQ.crossquant(x, bits, alpha)
    tr = TQ.crossquant(_t(x), bits, alpha)
    jf = np.asarray(JQ.fake_crossquant(x, bits, alpha))
    tf = _np(TQ.fake_crossquant(_t(x), bits, alpha))
    assert tr.codes.dtype == torch.int8 and tr.scale.dtype == torch.float32
    if alpha == 1.0:
        np.testing.assert_array_equal(_np(tr.codes), np.asarray(jr.codes))
        np.testing.assert_array_equal(_np(tr.scale), np.asarray(jr.scale))
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(_np(tr.dequant()), np.asarray(jr.dequant()))
        return
    dc = np.abs(_np(tr.codes).astype(np.int32) - np.asarray(jr.codes).astype(np.int32))
    assert dc.max() <= 1 and (dc > 0).mean() <= 1e-3
    # a fake value moves by at most one grid step, plus the scale's ulps
    step = np.asarray(jr.scale)
    assert (np.abs(tf - jf) <= step * (1 + 1e-5)).all()


def test_crossquant_static_columns():
    x = _act(4)
    cmax = np.abs(_act(5)).max(0) * 1.3
    want = np.asarray(JQ.fake_crossquant(x, 8, 1.0, col_max=cmax))
    np.testing.assert_array_equal(_np(TQ.fake_crossquant(_t(x), 8, 1.0, col_max=_t(cmax))), want)


@pytest.mark.parametrize("bits", [8, 4])
def test_per_token_and_per_tensor_bitwise(bits):
    x = _act(6, (4, 33, 200))
    np.testing.assert_array_equal(_np(TQ.fake_per_token(_t(x), bits)),
                                  np.asarray(JQ.fake_per_token(x, bits)))
    jr, tr = JQ.per_token_quant(x, bits), TQ.per_token_quant(_t(x), bits)
    np.testing.assert_array_equal(_np(tr.codes), np.asarray(jr.codes))
    np.testing.assert_array_equal(_np(TQ.per_tensor_scale(_t(x), bits)),
                                  np.asarray(_jit(JQ.per_tensor_scale, 1)(x, bits)))


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("bits", [8, 4])
def test_per_channel_bitwise(axis, bits):
    w = _act(7, (256, 384))
    jr, tr = JQ.per_channel_quant(w, bits, axis), TQ.per_channel_quant(_t(w), bits, axis)
    np.testing.assert_array_equal(_np(tr.codes), np.asarray(jr.codes))
    np.testing.assert_array_equal(_np(tr.scale), np.asarray(jr.scale))
    np.testing.assert_array_equal(_np(TQ.fake_per_channel(_t(w), bits, axis)),
                                  np.asarray(JQ.fake_per_channel(w, bits, axis)))
    np.testing.assert_array_equal(_np(TQ.per_channel_scale(_t(w), bits, axis)),
                                  np.asarray(_jit(JQ.per_channel_scale, 1, 2)(w, bits, axis)))


@pytest.mark.parametrize("bits,group", [(4, 128), (4, 32), (8, 64)])
def test_group_bitwise(bits, group):
    w = _act(8, (2, 256, 96))
    jr, tr = JQ.group_quant(w, bits, group), TQ.group_quant(_t(w), bits, group)
    assert tuple(tr.codes.shape) == w.shape
    np.testing.assert_array_equal(_np(tr.codes), np.asarray(jr.codes))
    np.testing.assert_array_equal(_np(tr.scale), np.asarray(jr.scale))
    np.testing.assert_array_equal(_np(TQ.group_dequant(tr, group)),
                                  np.asarray(JQ.group_dequant(jr, group)))
    np.testing.assert_array_equal(_np(TQ.fake_group(_t(w), bits, group)),
                                  np.asarray(JQ.fake_group(w, bits, group)))


# ======================================================================================
# Kernel analysis
# ======================================================================================

@pytest.mark.parametrize("zeros", [False, True])
def test_kernel_mask_bitwise_under_one_scale(zeros):
    x = _act(9)
    x[::7, ::5] = 0.0                                  # exact zeros: the two conventions
    scale = np.asarray(_jit(JQ.crossquant_scale, 1, 2)(x, 8, 0.15))
    want = np.asarray(jax.jit(lambda a, s: JKA.kernel_mask(a, s, count_exact_zeros=zeros))(
        x, scale))
    got = TKA.kernel_mask(_t(x), _t(scale), count_exact_zeros=zeros)
    np.testing.assert_array_equal(_np(got), want)
    assert int(TKA.kernel_count(_t(x), _t(scale), count_exact_zeros=zeros)) == int(want.sum())
    jf = float(jax.jit(lambda a, s: JKA.kernel_fraction(a, s, count_exact_zeros=zeros))(
        x, scale))
    assert float(TKA.kernel_fraction(_t(x), _t(scale), count_exact_zeros=zeros)) == jf


@pytest.mark.parametrize("alpha", ALPHAS)
def test_kernel_fractions(alpha):
    x = _act(10)
    pt = float(JKA.per_token_kernel_fraction(x, 8))
    cq = float(JKA.crossquant_kernel_fraction(x, 8, alpha))
    assert float(TKA.per_token_kernel_fraction(_t(x), 8)) == pt
    got = float(TKA.crossquant_kernel_fraction(_t(x), 8, alpha))
    if alpha == 1.0:
        assert got == cq == pt                        # α = 1 is per-token exactly
    else:
        assert abs(got - cq) <= 1e-5                  # a few pow-ulp boundary elements
        assert got < pt                               # the paper's claim: a smaller kernel


def test_kernel_count_is_exact_past_2_24():
    """An f32 sum of a 0/1 mask stops counting at 2^24; the int64 count does not.
    The fraction is f32(count) · f32(1/n), the jitted reference's mean."""
    n = (1 << 24) + 4099
    x = torch.ones(n)
    x[::3] = 1e-6                                      # in the kernel of Δ = 1
    scale = torch.ones(1)
    count = int(TKA.kernel_count(x, scale))
    assert count == len(range(0, n, 3))
    frac = TKA.kernel_fraction(x, scale)
    assert frac.dtype == torch.float32
    assert float(frac) == float(np.float32(count) * (np.float32(1) / np.float32(n)))


@pytest.mark.parametrize("fraction", [0.0, 0.05, 0.1, 0.37, 0.5, 0.9, 1.0])
def test_remove_kernel_fraction_bitwise(fraction):
    x = _act(11, (2, 300, 700))
    want = np.asarray(_jit(JKA.remove_kernel_fraction, 1)(x, fraction))
    np.testing.assert_array_equal(_np(TKA.remove_kernel_fraction(_t(x), fraction)), want)
    q = np.asarray(jax.jit(lambda a: jnp.quantile(jnp.abs(a).reshape(-1), fraction))(x))
    assert TKA.quantile_linear(_t(x).abs(), fraction).item() == float(q)


def test_remove_kernel_fraction_past_2_24():
    """``torch.quantile`` refuses > 2^24 elements; the port's sort-based quantile
    equals an independent selection (``kthvalue`` for the two order statistics,
    numpy for the f32 interpolation) there."""
    x = torch.from_numpy(_act(12, (4, 450, 9400)))
    assert x.numel() > 1 << 24
    flat = x.abs().reshape(-1)
    for fraction in (0.1, 0.437):
        n = np.float32(flat.numel())
        pos = np.float32(fraction) * (n - np.float32(1))
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        hw = pos - np.floor(pos)
        lw = np.float32(1) - hw
        vlo = np.float32(torch.kthvalue(flat, lo + 1).values)
        vhi = np.float32(torch.kthvalue(flat, hi + 1).values)
        want = np.float32(np.float64(vlo) * np.float64(lw) + np.float64(np.float32(vhi * hw)))
        got = TKA.quantile_linear(flat, fraction)
        assert got.item() == float(want)
        out = TKA.remove_kernel_fraction(x, fraction)
        assert torch.equal(out == 0, x.abs() <= got)
        assert torch.equal(out[out != 0], x[out != 0])


def test_remove_kernel_bitwise():
    x = _act(13, (64, 256))
    scale = np.asarray(_jit(JQ.per_token_scale, 1)(x, 8))
    want = np.asarray(jax.jit(JKA.remove_kernel)(x, scale))
    np.testing.assert_array_equal(_np(TKA.remove_kernel(_t(x), _t(scale))), want)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_table1_stats(alpha):
    x = _act(14, (3, 100, 512))
    want = JKA.table1_stats(x, 8, alpha)
    got = TKA.table1_stats(_t(x), 8, alpha)
    assert set(got) == set(want)
    for k in ("c_ge_t", "kernel_per_token"):
        assert float(got[k]) == float(want[k]), k
    # Where c_j == t_i the two bounds tie exactly, and B̃ < B turns on the pow's
    # last ulp (a row max that is also its column's max): those positions alone
    # may count differently
    t = np.abs(x).max(-1, keepdims=True)
    ties = float((np.abs(x).max((0, 1), keepdims=True) == t).mean())
    for k in ("kernel_crossquant", "bcq_lt_bpt"):
        assert got[k].dtype == torch.float32
        assert abs(float(got[k]) - float(want[k])) <= max(1e-6, ties), (k, ties)


def test_kernel_stats():
    js, ts = JKA.KernelStats(8, 0.15), TKA.KernelStats(8, 0.15)
    for seed in (15, 16, 17):
        x = _act(seed, (2, 64, 256))
        js.observe(x)
        ts.observe(_t(x))
    jsum, tsum = js.summary(), ts.summary()
    assert tsum["n"] == jsum["n"] == 3
    for k in ("per_token_mean", "crossquant_mean"):
        assert abs(tsum[k] - jsum[k]) <= 1e-6, k
    assert TKA.KernelStats().summary() == JKA.KernelStats().summary()


# ======================================================================================
# make_sparsity_plan
# ======================================================================================

@pytest.fixture(scope="module")
def smoke():
    cfg_j = dataclasses.replace(jget("starcoder2-7b", smoke=True), dtype="float32")
    cfg_t = dataclasses.replace(tget("starcoder2-7b", smoke=True), dtype="float32")
    params = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                        device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg_j.vocab, size=(2, 16)).astype(np.int32)

    def fwd(p, tk):                        # the observer pass, jitted: inputs per linear
        rec = {}

        class Obs:
            def observe(self, name, x):
                rec[name] = x

        JM.apply(p, {"tokens": tk}, cfg_j, ctx=JQuantContext(JQL.W8A8_CROSSQUANT, observer=Obs()),
                 mode="train", unroll=True)
        return rec

    acts = {k: np.asarray(v) for k, v in jax.jit(fwd)(params, jnp.asarray(toks)).items()}
    return cfg_j, cfg_t, params, tparams, toks, acts


def _plans(smoke, threshold, monkeypatch=None):
    """Both packages' plans. With ``monkeypatch``, each plan's model pass replays
    the jitted reference's activations into its observer instead of running the
    model, so the two plans see the same inputs."""
    cfg_j, cfg_t, params, tparams, toks, acts = smoke
    if monkeypatch is not None:
        def replay(wrap):
            def apply(p, batch, cfg, *, ctx, **kw):
                for name, x in acts.items():
                    ctx.observer.observe(name, wrap(x))
                return None, {}
            return apply

        monkeypatch.setattr(JM, "apply", replay(jnp.asarray))
        monkeypatch.setattr(TM, "apply", replay(_t))
    jp = JMQ.make_sparsity_plan(cfg_j, params, [{"tokens": jnp.asarray(toks)}],
                                threshold=threshold)
    tp = TMQ.make_sparsity_plan(cfg_t, tparams,
                                [{"tokens": torch.as_tensor(toks, dtype=torch.int64)}],
                                threshold=threshold)
    return jp, tp


def _between(fractions, gap=0.0):
    """A threshold midway in the widest gap between sorted fractions (the gap
    wider than ``gap``) and the number of fractions under it."""
    fr = sorted(fractions)
    i = max(range(len(fr) - 1), key=lambda j: fr[j + 1] - fr[j])
    assert fr[i + 1] - fr[i] > gap
    return (fr[i] + fr[i + 1]) / 2, i + 1


@pytest.mark.parametrize("which", ["all", "none", "between"])
def test_make_sparsity_plan(smoke, monkeypatch, which):
    """On the same activations (the jitted reference's observer pass replayed into
    both), the plans agree: fractions within 1e-6, the same layers."""
    threshold = {"all": 1.0, "none": -1.0}.get(which)
    n_under = {"all": 6, "none": 0}.get(which)
    if threshold is None:
        acts = smoke[-1]
        per_leaf = {}
        for name, x in acts.items():
            frac = float(JKA.crossquant_kernel_fraction(x.reshape(-1, x.shape[-1])))
            leaf = name.split("/", 3)[-1]
            per_leaf[leaf] = max(per_leaf.get(leaf, 0.0), frac)
        threshold, n_under = _between(per_leaf.values())
    jp, tp = _plans(smoke, threshold, monkeypatch)
    assert len(jp.fractions) == 6                      # wq wk wv wo up down, stacked
    assert set(tp.fractions) == set(jp.fractions)
    for k, f in jp.fractions.items():
        assert abs(tp.fractions[k] - f) <= 1e-6, k
    assert tp.layers == jp.layers and tp.nm == jp.nm == (2, 4)
    assert tp.threshold == threshold
    assert len(tp.layers) == n_under


def test_make_sparsity_plan_end_to_end(smoke):
    """Each package through its own model pass. Fake CrossQuant activations carry
    XLA's and torch's one-ulp ``pow`` differences into one-step code moves, which
    flip a couple of kernel elements per linear input downstream: the fractions
    agree within 2 elements of a 32-row input, and the layers agree at 1.0, -1.0
    and at a threshold in a gap wider than that."""
    cfg_t = smoke[1]
    tol = {"wq": 2 / (32 * cfg_t.d_model), "wo": 2 / (32 * cfg_t.n_heads * cfg_t.head_dim),
           "down": 2 / (32 * cfg_t.d_ff)}
    jp, tp = _plans(smoke, 1.0)
    assert tp.layers == jp.layers and len(tp.layers) == 6
    for k, f in jp.fractions.items():
        leaf = k.split("/")[-1]
        assert abs(tp.fractions[k] - f) <= tol.get(leaf, tol["wq"]), k
    assert _plans(smoke, -1.0)[1].layers == ()
    threshold, n_under = _between(jp.fractions.values(), gap=2 * max(tol.values()))
    jp, tp = _plans(smoke, threshold)
    assert tp.layers == jp.layers and len(tp.layers) == n_under
