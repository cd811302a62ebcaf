"""Speculative decoding in the PyTorch port against the JAX reference (CPU).

* **Kernel plain version** — ``ops.paged_verify_attention`` on CPU tensors (the
  plain version of K5) against ``repro.kernels.ref.paged_verify_attention_ref``
  over the reference's window sweep, and once against the Pallas kernel in
  interpret mode; W == 1 is bitwise the decode path. Tolerance 2e-5 on the
  valid window rows, the reference's own.
* **Serving parity** — ``speculate=4`` on fused-int8 × {fp, int8} KV × {dense,
  paged} emits exactly the tokens of ``speculate=1``, and of the JAX engine
  with ``speculate=4``, with the same drafted / accepted / emitted counts. The
  JAX engine serves its paged kernels through their jnp oracles
  (``REPRO_KERNEL_EXEC=ref``).
* **Mid-window retirement** — an EOS inside a draft window retires at the
  token sequential decode would.
"""
import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.quantize import quantize_tree as j_quantize_tree  # noqa: E402
from repro.serving import drafter as jdrafter, engine as JE  # noqa: E402
from repro.serving.config import EngineConfig as JEngineConfig  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serving import drafter as tdrafter, engine as TE  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402

torch.set_num_threads(2)

T = 32
PS = 8
MAX_NEW = [6, 4, 7, 3]                  # tests/test_speculative.py:67
SWEEP = [(2, 2, 2, 16, 8, 8, 4), (1, 1, 4, 32, 4, 16, 2), (3, 2, 1, 64, 16, 4, 8)]
SPEC_COUNTERS = ("spec_steps", "spec_slot_steps", "spec_drafted", "spec_accepted",
                 "spec_emitted", "decode_steps", "prefill_calls")


@pytest.fixture(scope="module")
def small():
    cfg_j = dataclasses.replace(jget("starcoder2-7b", smoke=True), dtype="float32")
    cfg_t = dataclasses.replace(tget("starcoder2-7b", smoke=True), dtype="float32")
    qparams = j_quantize_tree(JM.init_params(jax.random.PRNGKey(0), cfg_j), jql.W8A8_INT8)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams),
                                        device="cpu")
    return cfg_j, cfg_t, qparams, tparams


@pytest.fixture
def jax_ref_exec(monkeypatch):
    """The JAX engine's paged kernels run their jnp oracles, not interpret mode."""
    monkeypatch.setenv("REPRO_KERNEL_EXEC", "ref")


def _spec_prompts(vocab, seed=0):
    """tests/test_speculative.py's drafter-friendly mix: periodic motifs (lookups
    hit) and random prompts (lookups miss)."""
    rng = np.random.default_rng(seed)
    motif = rng.integers(1, vocab, size=4).astype(np.int32)
    return [np.tile(motif, 3), rng.integers(1, vocab, size=7).astype(np.int32),
            np.tile(motif[:3], 2), rng.integers(1, vocab, size=9).astype(np.int32)]


def _layout_kw(layout):
    return dict(cache_layout="paged", page_size=PS) if layout == "paged" else {}


def _serve_t(cfg, params, prompts, *, speculate, **kw):
    eng = TE.ServeEngine(cfg, params, quant=tql.W8A8_INT8, device="cpu",
                         config=EngineConfig(batch_size=2, max_len=T, path="fused-int8",
                                             speculate=speculate, **kw))
    eng.submit([p.copy() for p in prompts], max_new=MAX_NEW)
    return {r.rid: r.out for r in eng.run()}, eng


def _serve_j(cfg, params, prompts, *, speculate, **kw):
    eng = JE.ServeEngine(cfg, params, quant=jql.W8A8_INT8,
                         config=JEngineConfig(batch_size=2, max_len=T, path="fused-int8",
                                              speculate=speculate, **kw))
    eng.submit([p.copy() for p in prompts], max_new=MAX_NEW)
    return {r.rid: r.out for r in eng.run()}, eng


def _t(a):
    return torch.from_numpy(np.array(a))


def _opt(fn, a):
    return None if a is None else fn(a)


def _rand_case(rng, B, Hkv, G, D, P, ps, maxP, W, kv_int8):
    """Pools, an injective table with sentinel tails, kv_len, q_len and q (numpy)."""
    if kv_int8:
        pools = (rng.integers(-127, 128, (P, ps, Hkv, D)).astype(np.int8),
                 rng.integers(-127, 128, (P, ps, Hkv, D)).astype(np.int8),
                 (0.002 + 0.05 * rng.random((P, ps, Hkv, 1))).astype(np.float32),
                 (0.002 + 0.05 * rng.random((P, ps, Hkv, 1))).astype(np.float32))
    else:
        pools = (rng.standard_normal((P, ps, Hkv, D)).astype(np.float32),
                 rng.standard_normal((P, ps, Hkv, D)).astype(np.float32), None, None)
    tab = np.full((B, maxP), P, np.int32)
    kvl = np.zeros(B, np.int32)
    perm, off = rng.permutation(P), 0
    for b in range(B):
        n = int(rng.integers(1, min(maxP, P - off) + 1))
        tab[b, :n] = perm[off: off + n]
        off += n
        kvl[b] = int(rng.integers((n - 1) * ps + 1, n * ps + 1))
    qln = np.asarray([int(rng.integers(1, h + 1)) for h in np.minimum(kvl, W)], np.int32)
    q = rng.standard_normal((B, W, Hkv * G, D)).astype(np.float32)
    return pools, tab, kvl, qln, q


def _port_verify(q, pools, tab, kvl, qln, **kw):
    kp, vp, ks, vs = pools
    return tops.paged_verify_attention(_t(q), _t(kp), _t(vp), _t(tab), _t(kvl), _t(qln),
                                       k_scale_pages=_opt(_t, ks), v_scale_pages=_opt(_t, vs),
                                       **kw).numpy()


def _jax_oracle(q, pools, tab, kvl, qln, **kw):
    B, W, H, D = q.shape
    kp, vp, ks, vs = pools
    Hkv = kp.shape[2]
    qg = jnp.transpose(jnp.asarray(q).reshape(B, W, Hkv, H // Hkv, D), (0, 2, 1, 3, 4))
    out = jref.paged_verify_attention_ref(
        qg, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tab), jnp.asarray(kvl),
        jnp.asarray(qln), k_scale_pages=_opt(jnp.asarray, ks),
        v_scale_pages=_opt(jnp.asarray, vs), **kw)
    return np.asarray(jnp.transpose(out, (0, 2, 1, 3, 4)).reshape(B, W, H, D))


def _close_on_valid_rows(got, want, qln):
    for b, n in enumerate(qln):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=2e-5, atol=2e-5)


class TestVerifyPlainVersion:
    @pytest.mark.parametrize("kv_int8", [False, True])
    @pytest.mark.parametrize("W", [1, 2, 4])
    @pytest.mark.parametrize("B,Hkv,G,D,P,ps,maxP", SWEEP)
    def test_window_sweep_vs_reference_oracle(self, B, Hkv, G, D, P, ps, maxP, W, kv_int8):
        rng = np.random.default_rng(100 * W + B + 7 * kv_int8)
        pools, tab, kvl, qln, q = _rand_case(rng, B, Hkv, G, D, P, ps, maxP, W, kv_int8)
        got = _port_verify(q, pools, tab, kvl, qln)
        _close_on_valid_rows(got, _jax_oracle(q, pools, tab, kvl, qln), qln)
        assert np.isfinite(got).all()
        assert tops.LAUNCHES["paged_verify_attention"] == 0   # CPU tensors never launch

    @pytest.mark.parametrize("window,softcap", [(5, None), (None, 30.0)])
    def test_window_and_softcap(self, window, softcap):
        rng = np.random.default_rng(31)
        pools, tab, kvl, qln, q = _rand_case(rng, 2, 2, 2, 16, 8, 8, 4, 3, True)
        got = _port_verify(q, pools, tab, kvl, qln, window=window, softcap=softcap)
        want = _jax_oracle(q, pools, tab, kvl, qln, window=window, softcap=softcap)
        _close_on_valid_rows(got, want, qln)

    def test_vs_pallas_interpret(self):
        """The Pallas kernel itself (interpret mode), int8 pools, W = 4, with a
        free slot's all-sentinel row: finite, and the live rows agree."""
        rng = np.random.default_rng(5)
        pools, tab, kvl, qln, q = _rand_case(rng, 2, 2, 2, 16, 8, 8, 4, 4, True)
        tab[1] = 8
        kvl[1], qln[:] = 1, [4, 1]
        kp, vp, ks, vs = pools
        got = _port_verify(q, pools, tab, kvl, qln)
        want = np.asarray(jops.paged_verify_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tab),
            jnp.asarray(kvl), jnp.asarray(qln), k_scale_pages=jnp.asarray(ks),
            v_scale_pages=jnp.asarray(vs)))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("kv_int8", [False, True])
    def test_w1_bitwise_equals_decode(self, kv_int8):
        rng = np.random.default_rng(3)
        pools, tab, kvl, _, q = _rand_case(rng, 2, 2, 2, 16, 8, 8, 4, 1, kv_int8)
        kp, vp, ks, vs = pools
        dec = tops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tab), _t(kvl),
                                          k_scale_pages=_opt(_t, ks),
                                          v_scale_pages=_opt(_t, vs)).numpy()
        ver = _port_verify(q, pools, tab, kvl, np.ones(2, np.int32))
        np.testing.assert_array_equal(dec, ver)


class TestServingParity:
    @pytest.mark.parametrize("layout", ["dense", "paged"])
    @pytest.mark.parametrize("kv", ["fp", "int8"])
    def test_speculate4_matches_speculate1_and_reference(self, small, jax_ref_exec, kv,
                                                         layout):
        cfg_j, cfg_t, qparams, tparams = small
        prompts = _spec_prompts(cfg_t.vocab)
        kw = dict(kv_cache=kv, **_layout_kw(layout))
        base, _ = _serve_t(cfg_t, tparams, prompts, speculate=1, **kw)
        spec, teng = _serve_t(cfg_t, tparams, prompts, speculate=4, **kw)
        want, jeng = _serve_j(cfg_j, qparams, prompts, speculate=4, **kw)
        assert spec == base == want, (kv, layout)
        assert teng.counters["spec_drafted"] > 0 and teng.counters["spec_accepted"] > 0
        assert teng.tokens_per_step() > 1.0 and teng.accept_rate() > 0.0
        for key in SPEC_COUNTERS:
            assert teng.counters[key] == jeng.counters[key], key
        if layout == "paged":
            teng.pool.check()

    @pytest.mark.parametrize("layout", ["dense", "paged"])
    def test_eos_inside_window(self, small, jax_ref_exec, layout):
        """The 3rd token of request 0 as EOS: the stop lands mid-stream, and with
        4-token windows flowing, mid-window; the retire is token-exact."""
        cfg_j, cfg_t, qparams, tparams = small
        prompts = _spec_prompts(cfg_t.vocab, seed=7)
        kw = _layout_kw(layout)
        base, _ = _serve_t(cfg_t, tparams, prompts, speculate=1, **kw)
        eos = base[0][2]
        want, _ = _serve_t(cfg_t, tparams, prompts, speculate=1, eos_id=eos, **kw)
        got, eng = _serve_t(cfg_t, tparams, prompts, speculate=4, eos_id=eos, **kw)
        jgot, _ = _serve_j(cfg_j, qparams, prompts, speculate=4, eos_id=eos, **kw)
        assert got == want == jgot
        assert any(v and v[-1] == eos for v in got.values())
        if layout == "paged":
            eng.pool.check()


class TestDrafterAndConfig:
    def test_drafter_is_verbatim(self):
        t, j = inspect.getsource(tdrafter), inspect.getsource(jdrafter)
        line = "\nA verbatim copy of ``repro/serving/drafter.py``, which is framework-free.\n"
        assert t.replace(line, "", 1) == j
        d = tdrafter.NGramDrafter(max_ngram=3)
        np.testing.assert_array_equal(d.draft(np.array([1, 2, 3, 9, 8, 1, 2, 3]), 3),
                                      [9, 8, 1])
        assert d.draft(np.array([1, 2, 3, 4]), 4).size == 0

    def test_speculate_needs_greedy_and_continuous(self):
        with pytest.raises(ValueError, match="greedy"):
            EngineConfig(batch_size=2, max_len=T, speculate=4, temperature=0.7)
        with pytest.raises(ValueError, match="continuous"):
            EngineConfig(batch_size=2, max_len=T, speculate=4, scheduler="grouped")
        with pytest.raises(ValueError, match="continuous"):
            EngineConfig(batch_size=2, max_len=T, cache_layout="paged", scheduler="grouped")
