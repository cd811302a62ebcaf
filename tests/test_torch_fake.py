"""The port's fake-quant and dequant-fp paths against the JAX reference (CPU), run
under ``jax.jit`` as the reference's serving steps run them.

* **Linears**: ``qlinear.apply`` in fake mode for every preset (per-token,
  CrossQuant with dynamic and static columns, SmoothQuant, g128, AWQ, W4A4, the
  remove-kernel ablations) and the ``dequant`` backend of prepared int8 and int4
  trees. Operands are bitwise where no ``pow`` is involved; a one-ulp ``pow``
  moves a code by one step on a few elements, and the products then agree to a
  relative 2e-3 (f32 association alone: 2e-6).
* **AWQ / SmoothQuant**: the same α from ``ALPHA_GRID`` and weights within one
  grid step; SmoothQuant's ``s`` within 4 ulps.
* **Trees**: ``dequantize_tree`` and ``fake_quantize_weights`` bitwise (a
  calibrated ``cmax = b^(1/(1-α))`` within one ``pow`` ulp); ``convert`` carries
  ``cmax`` leaves.
* **Serving** token-exact against the JAX engine: ``fake`` and ``dequant-fp`` ×
  {dense, paged} × {fp, int8 KV}; fake W4A8-g128 and W8A8 per-token; the grouped
  scheduler on fake and fused-int8; fake chunked (fp KV) against the JAX chunked
  engine, which launches every packed row of the budget: their padding rows
  enter CrossQuant's dynamic column max. The JAX paged runs use their jnp
  oracles (``REPRO_KERNEL_EXEC=ref``).
* **The fake twin** of the calibrated int8 tree matches fused-int8 logits within
  atol 1e-2, as tests/test_fused_serving.py holds the reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import awq as jawq, qlinear as jql  # noqa: E402
from repro.core import quantizers as JQ, smoothquant as jsq  # noqa: E402
from repro.data import make_train_batches  # noqa: E402
from repro.models import model as JM, quantize as JMQ  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.config import EngineConfig as JEngineConfig  # noqa: E402

import _jax_jitted as J  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import awq as tawq, qlinear as tql, smoothquant as tsq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import model as TM, quantize as TMQ  # noqa: E402
from repro_torch.models.layers import QuantContext  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402

torch.set_num_threads(2)

LENS = [4, 7, 12, 9, 5]                 # tests/test_continuous_batching.py:25-26
MAX_NEW = [5, 3, 6, 2, 4]
T = 32

PRESETS = ["W8A8_CROSSQUANT", "W8A8_PER_TOKEN", "W8A8_SMOOTHQUANT", "W4A8_G128",
           "W4A8_G128_PER_TOKEN", "W4A8_G128_AWQ", "W4A8_G128_CQ_AWQ", "W4A4_CQW", "W4A4",
           "W4A4_PER_TOKEN", "REMOVE_TRUE_KERNEL", "remove_kernel_cfg"]
#: presets whose scales hold no pow: operands bitwise, products to f32 association
POW_FREE = {"W8A8_PER_TOKEN", "W4A8_G128_PER_TOKEN", "W4A4_PER_TOKEN", "REMOVE_TRUE_KERNEL",
            "remove_kernel_cfg"}


def _preset(mod, name):
    return mod.remove_kernel_cfg(0.1) if name == "remove_kernel_cfg" else getattr(mod, name)


def _int_cfg(mod, tree):
    """The int-mode config a prepared tree was built with."""
    return (dataclasses.replace(mod.W8A8_INT8, w_bits=4, w_group=32) if tree == "int4c"
            else mod.W8A8_INT8)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _to_t(tree):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def small():
    """The f32 smoke model: raw params, an uncalibrated W8A8 tree, and W8A8 and
    W4A8 trees calibrated on one batch (launch/serve.py's recipe; g32, as the
    smoke model's d_model is 64)."""
    cfg_j = dataclasses.replace(jget("starcoder2-7b", smoke=True), dtype="float32")
    cfg_t = dataclasses.replace(tget("starcoder2-7b", smoke=True), dtype="float32")
    params = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    batch = make_train_batches(cfg_j.vocab, 16, 2, seed=1)(0)
    tables = J.stacked_tables(params, {k: jnp.asarray(v) for k, v in batch.items()}, cfg_j,
                              jql.W8A8_INT8, mode="train", unroll=True)
    w4 = dataclasses.replace(jql.W4A8_G128, mode="int8", w_group=32)
    trees = {"fp": params, "int8": J.quantize_tree(params, jql.W8A8_INT8),
             "int8c": J.quantize_tree(params, jql.W8A8_INT8, tables=tables),
             "int4c": J.quantize_tree(params, w4, tables=tables)}
    return cfg_j, cfg_t, trees, {k: _to_t(v) for k, v in trees.items()}, tables


def _linear(seed, d_in=256, d_out=384, rows=(2, 16), cmax=False):
    rng = np.random.default_rng(seed)
    col = np.exp(rng.standard_normal(d_in) * 1.2).astype(np.float32)
    x = (rng.standard_normal((*rows, d_in)) * col).astype(np.float32)
    p = {"w": (rng.standard_normal((d_in, d_out)) * d_in ** -0.5).astype(np.float32)}
    if cmax:
        p["cmax"] = (np.abs(x).reshape(-1, d_in).max(0) * 1.1).astype(np.float32)
    return x, p


# ======================================================================================
# Linears
# ======================================================================================

@pytest.mark.parametrize("cmax", [False, True])
@pytest.mark.parametrize("name", PRESETS)
def test_fake_linear(name, cmax):
    x, p = _linear(1, cmax=cmax)
    jcfg, tcfg = _preset(jql, name), _preset(tql, name)
    if cmax:
        jcfg = dataclasses.replace(jcfg, static_c=True)
        tcfg = dataclasses.replace(tcfg, static_c=True)
    want = np.asarray(jax.jit(lambda pp, xx: jql.apply(pp, xx, jcfg))(p, x))
    got = _np(tql.apply({k: _t(v) for k, v in p.items()}, _t(x), tcfg))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _rel(got, want) <= (2e-6 if name in POW_FREE else 2e-3), name


@pytest.mark.parametrize("name", ["W8A8_PER_TOKEN", "W4A8_G128", "W4A4_PER_TOKEN"])
def test_fake_operands_bitwise(name):
    """Where no pow is involved the fake-quantized operands are the reference's."""
    x, p = _linear(2, cmax=True)
    jcfg, tcfg = _preset(jql, name), _preset(tql, name)
    jx = np.asarray(jax.jit(lambda xx: jql._fake_act(xx, jcfg, None))(x))
    jw = np.asarray(jax.jit(lambda ww: jql._fake_weight(ww, jcfg))(p["w"]))
    tx, tw = tql._apply_fake({k: _t(v) for k, v in p.items()}, _t(x), tcfg)
    np.testing.assert_array_equal(_np(tw), jw)
    if jcfg.act_quant == "per_token":
        np.testing.assert_array_equal(_np(tx), jx)
    static = dataclasses.replace(jcfg, act_quant="crossquant", alpha=1.0, static_c=True)
    jx = np.asarray(jax.jit(lambda xx, c: jql._fake_act(xx, static, c))(x, p["cmax"]))
    tstatic = dataclasses.replace(tcfg, act_quant="crossquant", alpha=1.0, static_c=True)
    np.testing.assert_array_equal(_np(tql._fake_act(_t(x), tstatic, _t(p["cmax"]))), jx)


def test_w_prequantized_skips_the_weight():
    x, p = _linear(3)
    cfg = dataclasses.replace(tql.W8A8_PER_TOKEN, w_prequantized=True)
    tp = {k: _t(v) for k, v in p.items()}
    want = _t(np.asarray(JQ.fake_per_token(x, 8))) @ tp["w"]
    assert torch.equal(tql.apply(tp, _t(x), cfg), want)


@pytest.mark.parametrize("tree", ["int8", "int8c", "int4c"])
def test_dequant_backend(small, tree):
    """``int_exec="dequant"`` on prepared leaves: codes back to f32, fp product."""
    _, _, jtrees, ttrees, _ = small
    jleaf = {k: v[0] for k, v in jtrees[tree]["blocks"][0]["mlp"]["up"].items()}
    tleaf = {k: v[0] for k, v in ttrees[tree]["blocks"][0]["mlp"]["up"].items()}
    jcfg, tcfg = _int_cfg(jql, tree), _int_cfg(tql, tree)
    x, _ = _linear(4, d_in=jleaf["bcol"].shape[-1], rows=(3, 9))
    want = np.asarray(jax.jit(lambda pp, xx: jql.apply(pp, xx, jcfg, int_exec="dequant"))(
        jleaf, x))
    got = _np(tql.apply(tleaf, _t(x), tcfg, int_exec="dequant"))
    # calibrated leaves carry t^0.15 in the row scale: a pow ulp moves a code
    assert _rel(got, want) <= (2e-6 if tree == "int8" else 2e-3)
    ref = _np(tql.apply(tleaf, _t(x), tcfg, int_exec="ref"))
    assert _rel(got, ref) <= 2e-6                    # the integer path, f32-associated
    # an expert stack multiplies per expert (the MoE slice; tests/test_torch_moe.py),
    # the same product f32-associated otherwise: sw scales the weight first
    g = torch.Generator().manual_seed(0)
    qx = torch.randint(-127, 128, (2, 3, 8), dtype=torch.int8, generator=g)
    qw = torch.randint(-127, 128, (2, 8, 4), dtype=torch.int8, generator=g)
    a, sw = torch.rand(2, 3, 1, generator=g) + 0.5, torch.rand(2, 4, generator=g) + 0.5
    got = tql._int8_dequant_fp(qx, qw, a, sw)
    for e in range(2):
        torch.testing.assert_close(got[e], tql._int8_dequant_fp(qx[e], qw[e], a[e], sw[e]),
                                   rtol=2e-6, atol=0)


def test_awq_weight():
    """The same α from ALPHA_GRID, and weights within one of its grid steps."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((256, 96)) * 0.06).astype(np.float32)
    cmax = np.exp(rng.standard_normal(256) * 1.5).astype(np.float32)

    def pick(fn, ww, cc, conv):
        full = conv(fn(ww, cc))
        hits = [a for a in jawq.ALPHA_GRID
                if np.array_equal(conv(fn(ww, cc, alphas=(a,))), full)]
        return hits, full

    jhit, jw = pick(lambda ww, cc, **k: jax.jit(
        lambda a, b: jawq.awq_weight(a, b, **k))(ww, cc), w, cmax, np.asarray)
    thit, tw = pick(lambda ww, cc, **k: tawq.awq_weight(_t(ww), _t(cc), **k), w, cmax, _np)
    assert len(jhit) == 1 and thit == jhit
    a = jhit[0]
    cm = np.maximum(cmax, 1e-8)
    cm = cm / np.exp(np.mean(np.log(cm)))
    s = (cm ** a).astype(np.float32)
    step = np.abs((w * s[:, None]).reshape(2, 128, 96)).max(1, keepdims=True) / 7
    step = (np.broadcast_to(step, (2, 128, 96)).reshape(256, 96) / s[:, None])
    assert (np.abs(tw - jw) <= step * (1 + 1e-4)).all()
    want = np.asarray(jax.jit(lambda v: jawq._fake_group_cols(v, 4, 128))(w))
    np.testing.assert_array_equal(_np(tawq._fake_group_cols(_t(w), 4, 128)), want)


def test_smoothquant():
    rng = np.random.default_rng(6)
    a = np.exp(rng.standard_normal(256) * 1.5).astype(np.float32)
    wr = np.abs(rng.standard_normal(256)).astype(np.float32) + 0.01
    for alpha in (0.5, 0.8):
        want = np.asarray(jax.jit(lambda u, v: jsq.smoothing_scale(u, v, alpha))(a, wr))
        got = _np(tsq.smoothing_scale(_t(a), _t(wr), alpha))
        assert np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64)).max() <= 4
    x, p = _linear(7)
    s = want
    jx, jw = jsq.smooth_pair(x, p["w"], s)
    tx, tw = tsq.smooth_pair(_t(x), _t(p["w"]), _t(s))
    np.testing.assert_array_equal(_np(tx), np.asarray(jx))
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    want = np.asarray(jsq.smoothquant_matmul_fake(x, p["w"], s))
    got = _np(tsq.smoothquant_matmul_fake(_t(x), _t(p["w"]), _t(s)))
    assert _rel(got, want) <= 2e-6


# ======================================================================================
# Trees
# ======================================================================================

@pytest.mark.parametrize("tree", ["int8", "int8c", "int4c"])
def test_dequantize_tree(small, tree):
    _, _, jtrees, ttrees, _ = small
    cfg_j, cfg_t = _int_cfg(jql, tree), _int_cfg(tql, tree)
    want = JMQ.dequantize_tree(jtrees[tree], cfg_j)
    got = TMQ.dequantize_tree(ttrees[tree], cfg_t)
    for kind, name in (("attn", "wq"), ("attn", "wo"), ("mlp", "up"), ("mlp", "down")):
        jl, tl = want["blocks"][0][kind][name], got["blocks"][0][kind][name]
        assert set(tl) == set(jl) == {"w", "cmax"}
        np.testing.assert_array_equal(_np(tl["w"]), np.asarray(jl["w"]))
        jc, tc = np.asarray(jl["cmax"]), _np(tl["cmax"])
        if tree == "int8":                               # uncalibrated: cmax = 1
            np.testing.assert_array_equal(tc, jc)
            assert (tc == 1).all()
        else:
            assert np.abs(tc.view(np.int32).astype(np.int64)
                          - jc.view(np.int32).astype(np.int64)).max() <= 1
    np.testing.assert_array_equal(_np(got["embed"]["w"]), np.asarray(want["embed"]["w"]))


@pytest.mark.parametrize("name", ["W8A8_CROSSQUANT", "W4A8_G128", "W4A4_CQW"])
def test_fake_quantize_weights(small, name):
    _, _, jtrees, ttrees, _ = small
    want = JMQ.fake_quantize_weights(jtrees["fp"], getattr(jql, name))
    got = TMQ.fake_quantize_weights(ttrees["fp"], getattr(tql, name))
    for kind, leaf in (("attn", "wk"), ("mlp", "down")):
        jw = np.asarray(want["blocks"][0][kind][leaf]["w"])
        tw = _np(got["blocks"][0][kind][leaf]["w"])
        if name == "W4A4_CQW":
            # α_w = 0.55: the scale's pow ulps move values by ulps, and a code by
            # one step on at most 1e-3 of them
            scale = np.asarray(jax.jit(lambda v: JQ.crossquant_scale(v, 4, 0.55))(
                np.asarray(jtrees["fp"]["blocks"][0][kind][leaf]["w"])))
            moved = np.abs(tw - jw) > 1e-3 * scale
            assert (np.abs(tw - jw) <= scale * (1 + 1e-5)).all() and moved.mean() <= 1e-3
        else:
            np.testing.assert_array_equal(tw, jw)


def test_convert_carries_cmax(small):
    _, _, jtrees, _, _ = small
    twin = JMQ.dequantize_tree(jtrees["int8c"], jql.W8A8_INT8)
    t = _to_t(twin)
    leaf = t["blocks"][0]["mlp"]["down"]
    assert set(leaf) == {"w", "cmax"} and leaf["cmax"].dtype == torch.float32
    np.testing.assert_array_equal(_np(leaf["cmax"]),
                                  np.asarray(twin["blocks"][0]["mlp"]["down"]["cmax"]))


def test_fake_twin_matches_fused_int8(small):
    """The calibrated int8 tree's fake twin (static c, prequantized weights)
    against the fused path, atol 1e-2 (tests/test_fused_serving.py's gate)."""
    _, cfg_t, _, ttrees, _ = small
    toks = torch.as_tensor(np.random.default_rng(8).integers(0, cfg_t.vocab, (2, 32)))
    twin = TMQ.dequantize_tree(ttrees["int8c"], tql.W8A8_INT8)
    fake = dataclasses.replace(tql.W8A8_CROSSQUANT, static_c=True, w_prequantized=True)
    fused, _ = TM.apply(ttrees["int8c"], {"tokens": toks}, cfg_t,
                        ctx=QuantContext(tql.W8A8_INT8, use_kernels=True, int_exec="kernel"))
    got, _ = TM.apply(twin, {"tokens": toks}, cfg_t, ctx=QuantContext(fake))
    np.testing.assert_allclose(_np(got), _np(fused), atol=1e-2, rtol=0)
    deq, _ = TM.apply(ttrees["int8c"], {"tokens": toks}, cfg_t,
                      ctx=QuantContext(tql.W8A8_INT8, int_exec="dequant"))
    np.testing.assert_allclose(_np(deq), _np(fused), atol=1e-2, rtol=0)


# ======================================================================================
# Serving: token-exact against the JAX engine
# ======================================================================================

def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


def _serve_pair(small, tree, quant, prompts, max_new, **kw):
    cfg_j, cfg_t, jtrees, ttrees, _ = small
    jeng = JE.ServeEngine(cfg_j, jtrees[tree], quant=_preset(jql, quant),
                          config=JEngineConfig(batch_size=2, max_len=T, **kw))
    jeng.submit([p.copy() for p in prompts], max_new=max_new)
    jdone = jeng.run()
    teng = TE.ServeEngine(cfg_t, ttrees[tree], quant=_preset(tql, quant), device="cpu",
                          config=EngineConfig(batch_size=2, max_len=T, **kw))
    teng.submit([p.copy() for p in prompts], max_new=max_new)
    tdone = teng.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for tr, jr in zip(tdone, jdone):
        assert tr.out == jr.out, (kw, tr.rid, tr.out, jr.out)
        assert tr.finish_reason.value == jr.finish_reason.value
    for key in ("prefill_calls", "decode_steps", "active_slot_steps", "prompt_tokens",
                "prefix_tokens_reused", "chunk_steps"):
        assert teng.counters[key] == jeng.counters[key], key
    return jeng, teng


@pytest.fixture
def jax_ref_exec(monkeypatch):
    """The JAX engine's paged kernels run their jnp oracles, not interpret mode."""
    monkeypatch.setenv("REPRO_KERNEL_EXEC", "ref")


@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("path,tree,quant", [("fake", "fp", "W8A8_CROSSQUANT"),
                                             ("dequant-fp", "int8c", "W8A8_INT8")])
def test_serving_token_exact(small, jax_ref_exec, path, tree, quant, layout, kv):
    tops.reset_launches()
    _serve_pair(small, tree, quant, _prompts(small[0].vocab), MAX_NEW, path=path,
                kv_cache=kv, cache_layout=layout)
    assert all(n == 0 for n in tops.LAUNCHES.values())     # CPU: plain versions only


@pytest.mark.parametrize("quant", ["W4A8_G128", "W8A8_PER_TOKEN"])
def test_fake_presets_token_exact(small, quant):
    _serve_pair(small, "fp", quant, _prompts(small[0].vocab), MAX_NEW, path="fake")


@pytest.mark.parametrize("path,tree,quant", [("fake", "fp", "W8A8_CROSSQUANT"),
                                             ("fused-int8", "int8", "W8A8_INT8")])
def test_grouped_token_exact(small, path, tree, quant):
    """Equal-length groups drain before the next group: two pairs of 6-token
    prompts and a 9-token one, at batch 2."""
    prompts = _prompts(small[0].vocab, [6, 9, 6, 6, 6], seed=3)
    jeng, teng = _serve_pair(small, tree, quant, prompts, [4, 3, 5, 2, 3], path=path,
                             scheduler="grouped")
    assert teng.counters["prefill_calls"] == 3 and teng.counters["mid_decode_admissions"] == 0


def _record_samplers(monkeypatch):
    """Record the logits each engine's sampler sees, in call order."""
    calls = {JE: [], TE: []}
    hosts = {JE: lambda l, c: jax.debug.callback(lambda v: c.append(np.asarray(v)), l,
                                                 ordered=True),
             TE: lambda l, c: c.append(_np(l).copy())}
    for mod in (JE, TE):
        make = mod._make_sampler

        def recording(temperature, top_k, mod=mod, make=make):
            sample = make(temperature, top_k)

            def wrapped(logits, key):
                hosts[mod](logits, calls[mod])
                return sample(logits, key)

            return wrapped

        monkeypatch.setattr(mod, "_make_sampler", recording)
    return calls


def test_fake_chunked_token_exact(small, jax_ref_exec, monkeypatch):
    """Chunked prefill in fake mode against the JAX chunked engine (with int8 KV the
    bucketed engine is not ground truth; ROADMAP queue C). The packed step
    launches all token_budget rows, as the reference's does: its padding rows
    enter CrossQuant's dynamic column max, and with them the logits agree within
    1e-4 (2e-7 measured; launching only the live rows moves them by 2e-3 to 7e-3)."""
    calls = _record_samplers(monkeypatch)
    jeng, teng = _serve_pair(small, "fp", "W8A8_CROSSQUANT", _prompts(small[0].vocab),
                             MAX_NEW, path="fake", kv_cache="fp", cache_layout="paged",
                             chunked=True, token_budget=16)
    jax.effects_barrier()
    assert teng.counters["chunk_steps"] > 0 and teng._rows_coupled
    assert len(calls[TE]) == len(calls[JE]) > 0
    for j, t in zip(calls[JE], calls[TE]):
        assert float(np.abs(t - j).max()) <= 1e-4
