"""The PyTorch port's paged KV layout with radix prefix reuse against the JAX
reference (CPU).

* **Kernel plain version** — ``ops.paged_decode_attention`` on CPU tensors (the
  plain version of K4) against ``repro.kernels.ref.paged_decode_attention_ref``
  over the reference's shape/table sweep, and once against the Pallas kernel in
  interpret mode. Tolerance 2e-5, the reference's own for its kernel.
* **Serving parity** — the port's paged ``ServeEngine`` and the JAX one emit the
  same greedy tokens on fused-int8 × {fp, int8} KV, with the same prefix hits,
  copy-on-write copies and prefill savings. The JAX engine serves its paged
  kernels through their jnp oracles (``REPRO_KERNEL_EXEC=ref``).
* **Layout** — warm admissions ≡ cold ≡ dense; int8 shared pages bit-identical
  (and equal to the reference's pages); partial-tail COW; refcount and
  eviction invariants; the page-pool-too-small error.
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
from repro.serving import engine as JE, paging as jpaging  # noqa: E402
from repro.serving.config import EngineConfig as JEngineConfig  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import engine as TE, paging as tpaging  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402
from repro_torch.serving.paging import PagePool, RadixIndex  # noqa: E402

torch.set_num_threads(2)

T = 32
PS = 8
LENS = [4, 7, 12, 9, 5]                 # tests/test_paged_serving.py:39-40
MAX_NEW = [5, 3, 6, 2, 4]
SWEEP = [(2, 2, 2, 16, 8, 8, 4), (1, 1, 4, 32, 4, 16, 2), (3, 2, 1, 64, 16, 4, 8)]


@pytest.fixture(scope="module")
def small():
    cfg_j = dataclasses.replace(jget("starcoder2-7b", smoke=True), dtype="float32")
    cfg_t = dataclasses.replace(tget("starcoder2-7b", smoke=True), dtype="float32")
    params = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    qparams = j_quantize_tree(params, jql.W8A8_INT8)
    to_t = lambda tree: convert.params_from_numpy(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")
    return cfg_j, cfg_t, qparams, to_t(qparams), to_t(params)


@pytest.fixture
def jax_ref_exec(monkeypatch):
    """The JAX engine's paged kernels run their jnp oracles, not interpret mode."""
    monkeypatch.setenv("REPRO_KERNEL_EXEC", "ref")


def _mixed_prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in LENS]


def _shared_prefix_prompts(vocab, n_req=4, shared_len=16, seed=2):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, size=shared_len).astype(np.int32)
    return [np.concatenate([shared, rng.integers(1, vocab, size=4 + i).astype(np.int32)])
            for i in range(n_req)]


def _serve_t(cfg, params, prompts, max_new, *, batch_size=2, **kw):
    quant = tql.W8A8_INT8 if "path" in kw else None
    eng = TE.ServeEngine(cfg, params, quant=quant, device="cpu",
                         config=EngineConfig(batch_size=batch_size, max_len=T, **kw))
    eng.submit([p.copy() for p in prompts], max_new=max_new)
    done = eng.run()
    eng.reused = {r.rid: r.prefix_reused for r in done}
    return {r.rid: r.out for r in done}, eng


def _serve_j(cfg, params, prompts, max_new, *, batch_size=2, **kw):
    eng = JE.ServeEngine(cfg, params, quant=jql.W8A8_INT8,
                         config=JEngineConfig(batch_size=batch_size, max_len=T, **kw))
    eng.submit([p.copy() for p in prompts], max_new=max_new)
    done = eng.run()
    eng.reused = {r.rid: r.prefix_reused for r in done}
    return {r.rid: r.out for r in done}, eng


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand_table(rng, B, P, ps, maxP):
    """Random injective tables with sentinel tails past each row's pages."""
    tab = np.full((B, maxP), P, np.int32)
    kvl = np.zeros(B, np.int32)
    perm = rng.permutation(P)
    off = 0
    for b in range(B):
        n = int(rng.integers(1, min(maxP, P - off) + 1))
        tab[b, :n] = perm[off: off + n]
        off += n
        kvl[b] = int(rng.integers((n - 1) * ps + 1, n * ps + 1))
    return tab, kvl


def _rand_pools(rng, P, ps, Hkv, D, kv_int8):
    """(k_pages, v_pages, k_scale_pages|None, v_scale_pages|None) as numpy."""
    if not kv_int8:
        return (rng.standard_normal((P, ps, Hkv, D)).astype(np.float32),
                rng.standard_normal((P, ps, Hkv, D)).astype(np.float32), None, None)
    return (rng.integers(-127, 128, (P, ps, Hkv, D)).astype(np.int8),
            rng.integers(-127, 128, (P, ps, Hkv, D)).astype(np.int8),
            (0.002 + 0.05 * rng.random((P, ps, Hkv, 1))).astype(np.float32),
            (0.002 + 0.05 * rng.random((P, ps, Hkv, 1))).astype(np.float32))


def _opt(fn, a):
    return None if a is None else fn(a)


class TestDecodePlainVersion:
    @pytest.mark.parametrize("kv_int8", [False, True])
    @pytest.mark.parametrize("B,Hkv,G,D,P,ps,maxP", SWEEP)
    def test_sweep_vs_reference_oracle(self, B, Hkv, G, D, P, ps, maxP, kv_int8):
        """tests/test_paged_serving.py's sweep, window and softcap included."""
        rng = np.random.default_rng(B * 100 + D + kv_int8)
        q = rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
        kp, vp, ks, vs = _rand_pools(rng, P, ps, Hkv, D, kv_int8)
        tab, kvl = _rand_table(rng, B, P, ps, maxP)
        for window, softcap in ((None, None), (5, None), (None, 30.0)):
            got = tops.paged_decode_attention(
                _t(q), _t(kp), _t(vp), _t(tab), _t(kvl), k_scale_pages=_opt(_t, ks),
                v_scale_pages=_opt(_t, vs), window=window, softcap=softcap)
            want = jref.paged_decode_attention_ref(
                jnp.asarray(q.reshape(B, Hkv, G, D)), jnp.asarray(kp), jnp.asarray(vp),
                jnp.asarray(tab), jnp.asarray(kvl), k_scale_pages=_opt(jnp.asarray, ks),
                v_scale_pages=_opt(jnp.asarray, vs), window=window, softcap=softcap)
            np.testing.assert_allclose(got.numpy().reshape(B, Hkv, G, D), np.asarray(want),
                                       rtol=2e-5, atol=2e-5)
        assert tops.LAUNCHES["paged_decode_attention"] == 0   # CPU tensors never launch

    @pytest.mark.parametrize("kv_int8", [False, True])
    def test_vs_pallas_interpret(self, kv_int8):
        """The Pallas kernel itself (interpret mode) on the first sweep shape, with
        a free slot's all-sentinel row in the table: finite, and the live rows
        agree."""
        B, Hkv, G, D, P, ps, maxP = 3, 2, 2, 16, 8, 8, 4
        rng = np.random.default_rng(57 + kv_int8)
        q = rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
        kp, vp, ks, vs = _rand_pools(rng, P, ps, Hkv, D, kv_int8)
        tab = np.asarray([[5] + [P] * 3, [0, 1, 2, P], [P] * 4], np.int32)
        kvl = np.asarray([3, 17, 1], np.int32)    # free slots decode with cur_len 1
        got = tops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tab), _t(kvl),
                                          k_scale_pages=_opt(_t, ks),
                                          v_scale_pages=_opt(_t, vs)).numpy()
        want = np.asarray(jops.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tab),
            jnp.asarray(kvl), k_scale_pages=_opt(jnp.asarray, ks),
            v_scale_pages=_opt(jnp.asarray, vs)))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[:2], want[:2], rtol=2e-5, atol=2e-5)

    def test_scalar_kv_len_and_bad_inputs(self):
        rng = np.random.default_rng(31)
        B, Hkv, G, D, P, ps = 2, 2, 2, 16, 8, 8
        q = _t(rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32))
        kp, vp, _, _ = (_opt(_t, a) for a in _rand_pools(rng, P, ps, Hkv, D, False))
        tab = torch.tensor([[0, 1, 2, P], [3, 4, 5, P]], dtype=torch.int32)
        got_s = tops.paged_decode_attention(q, kp, vp, tab, torch.tensor(17))
        got_v = tops.paged_decode_attention(q, kp, vp, tab, torch.full((B,), 17))
        assert torch.equal(got_s, got_v)
        with pytest.raises(ValueError):
            tops.paged_decode_attention(q, kp, vp, tab, 17,
                                        k_scale_pages=torch.ones(P, ps, Hkv, 1))
        with pytest.raises(ValueError):
            tops.paged_decode_attention(q[:, :, :3], kp, vp, tab, 17)


class TestModelLevel:
    def test_paged_prefill_bitwise_and_decode_close(self, small):
        """Cold paged prefill logits are bitwise the dense ones; one decode step
        through the paged plain version agrees with the dense decode to 2e-5 and
        in its argmax."""
        _, cfg_t, _, _, fparams = small
        rng = np.random.default_rng(7)
        lens = [5, 11]
        toks = np.zeros((2, max(lens)), np.int64)
        for i, n in enumerate(lens):
            toks[i, :n] = rng.integers(1, cfg_t.vocab, size=n)
        cl = torch.tensor(lens)
        for kv_int8 in (False, True):
            dense = TM.init_cache(cfg_t, 2, T, dtype=torch.float32, kv_int8=kv_int8,
                                  device="cpu")
            paged = TM.init_cache(cfg_t, 2, T, dtype=torch.float32, kv_int8=kv_int8,
                                  layout="paged", page_size=PS, device="cpu")
            paged["page_table"] = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]],
                                               dtype=torch.int32)
            ld, _ = TM.apply(fparams, {"tokens": torch.as_tensor(toks)}, cfg_t,
                             mode="prefill", caches=dense, cur_len=cl)
            lp, _ = TM.apply(fparams, {"tokens": torch.as_tensor(toks)}, cfg_t,
                             mode="prefill", caches=paged, cur_len=cl)
            assert torch.equal(ld, lp)
            nxt = torch.argmax(ld[:, -1], -1)[:, None]
            ld2, _ = TM.apply(fparams, {"tokens": nxt}, cfg_t, mode="decode", caches=dense,
                              cur_len=cl + 1)
            lp2, _ = TM.apply(fparams, {"tokens": nxt}, cfg_t, mode="decode", caches=paged,
                              cur_len=cl + 1)
            np.testing.assert_allclose(ld2.numpy(), lp2.numpy(), rtol=2e-5, atol=2e-5)
            assert torch.equal(torch.argmax(ld2, -1), torch.argmax(lp2, -1))

    def test_scatter_writes_nowhere_for_sentinels(self, small):
        """A decode step against an all-sentinel table row (a retired slot in
        lock-step) leaves every pool untouched: the scatter filters indices
        ≥ P·ps instead of leaving them to the indexing (which faults on a card)."""
        _, cfg_t, _, _, fparams = small
        caches = TM.init_cache(cfg_t, 2, T, dtype=torch.float32, kv_int8=True,
                               layout="paged", page_size=PS, device="cpu")
        before = [t.clone() for t in caches["blocks"][0].values()]
        TM.apply(fparams, {"tokens": torch.tensor([[3], [4]])}, cfg_t, mode="decode",
                 caches=caches, cur_len=torch.tensor([1, 9]))
        for a, b in zip(before, caches["blocks"][0].values()):
            assert torch.equal(a, b)


class TestServingParity:
    @pytest.mark.parametrize("kv", ["fp", "int8"])
    def test_mixed_workload_token_exact(self, small, jax_ref_exec, kv):
        """Mixed lengths and budgets at batch 2: slots retire and refill
        mid-decode; the port's paged engine emits the JAX paged engine's tokens."""
        cfg_j, cfg_t, qparams, tparams, _ = small
        prompts = _mixed_prompts(cfg_j.vocab)
        kw = dict(path="fused-int8", kv_cache=kv, cache_layout="paged", page_size=PS)
        want, jeng = _serve_j(cfg_j, qparams, prompts, MAX_NEW, **kw)
        got, teng = _serve_t(cfg_t, tparams, prompts, MAX_NEW, **kw)
        assert got == want, kv
        assert teng.counters["mid_decode_admissions"] > 0
        for key in ("prefill_calls", "decode_steps", "prefill_tokens", "peak_pages_in_use"):
            assert teng.counters[key] == jeng.counters[key], key
        teng.pool.check()

    @pytest.mark.parametrize("kv", ["fp", "int8"])
    def test_prefix_hits_token_exact(self, small, jax_ref_exec, kv):
        """Shared-prefix traffic: warm admissions map cached pages; tokens, hits,
        reused tokens and copy-on-write copies equal the reference's."""
        cfg_j, cfg_t, qparams, tparams, _ = small
        prompts = _shared_prefix_prompts(cfg_j.vocab)
        kw = dict(path="fused-int8", kv_cache=kv, cache_layout="paged", page_size=PS)
        want, jeng = _serve_j(cfg_j, qparams, prompts, 4, **kw)
        got, teng = _serve_t(cfg_t, tparams, prompts, 4, **kw)
        assert got == want, kv
        assert teng.counters["prefix_hits"] > 0
        for key in ("prefix_hits", "prefix_tokens_reused", "prefill_tokens", "cow_copies",
                    "pages_evicted", "peak_pages_in_use"):
            assert teng.counters[key] == jeng.counters[key], key
        assert teng.reused == jeng.reused
        teng.pool.check()


class TestPrefixReuse:
    def test_warm_matches_cold_and_dense(self, small):
        """Prefix-hit admissions emit exactly the tokens of a reuse-off paged
        engine and of the dense engine, while prefilling fewer tokens."""
        _, cfg_t, _, tparams, _ = small
        prompts = _shared_prefix_prompts(cfg_t.vocab)
        kw = dict(path="fused-int8", kv_cache="int8")
        warm, ew = _serve_t(cfg_t, tparams, prompts, 4, cache_layout="paged",
                            page_size=PS, **kw)
        cold, ec = _serve_t(cfg_t, tparams, prompts, 4, cache_layout="paged",
                            page_size=PS, prefix_reuse=False, **kw)
        dense, _ = _serve_t(cfg_t, tparams, prompts, 4, **kw)
        assert warm == cold == dense
        assert ew.counters["prefix_hits"] > 0 and ew.prefix_hit_rate() > 0.0
        assert ec.counters["prefix_hits"] == 0
        assert ew.counters["prefill_tokens"] < ec.counters["prefill_tokens"]
        assert (ew.counters["prefill_tokens"] + ew.counters["prefix_tokens_reused"]
                == ew.counters["prompt_tokens"])

    def test_shared_pages_are_copy_free(self, small):
        _, cfg_t, _, _, fparams = small
        prompts = _shared_prefix_prompts(cfg_t.vocab, n_req=2)
        eng = TE.ServeEngine(cfg_t, fparams, device="cpu",
                             config=EngineConfig(batch_size=2, max_len=T,
                                                 cache_layout="paged", page_size=PS))
        eng.submit([prompts[0].copy()], max_new=4)
        eng.run()
        held = set(eng.radix.held_pages())
        assert len(held) == len(prompts[0]) // PS
        eng.submit([prompts[1].copy()], max_new=4)
        eng._admit([])
        slot = next(i for i, s in enumerate(eng._slots) if s is not None)
        shared_now = eng._seq_pages[slot][: len(prompts[1]) // PS]
        assert set(shared_now) <= held
        assert all(eng.pool.refs[p] == 2 for p in shared_now)
        assert eng._slots[slot].prefix_reused >= PS

    def test_int8_shared_pages_bit_identical(self, small, jax_ref_exec):
        """Per-token int8 KV is deterministic: the prefix pages two cold prefills
        of the same tokens write are byte-identical, codes and scales. Against the
        JAX engine's pages they agree to the ulp-level differences of RoPE's
        sin/cos between the two libraries: scales to rel 1e-6, codes within one."""
        cfg_j, cfg_t, qparams, tparams, _ = small
        prompts = _shared_prefix_prompts(cfg_t.vocab, n_req=2)
        cfg_kw = dict(batch_size=2, max_len=T, path="fused-int8", cache_layout="paged",
                      page_size=PS, kv_cache="int8")
        keys = ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")

        def pages_of(eng, prompt, to_np):
            eng.submit([prompt.copy()], max_new=2)
            eng._admit([])
            slot = next(i for i, s in enumerate(eng._slots) if s is not None)
            ids = eng._seq_pages[slot][: len(prompt) // PS]
            return {k: to_np(eng.caches["blocks"][0][k])[:, ids] for k in keys}

        mk_t = lambda: TE.ServeEngine(cfg_t, tparams, quant=tql.W8A8_INT8,  # noqa: E731
                                      device="cpu", config=EngineConfig(**cfg_kw))
        a = pages_of(mk_t(), prompts[0], lambda t: t.numpy())
        b = pages_of(mk_t(), prompts[1], lambda t: t.numpy())
        j = pages_of(JE.ServeEngine(cfg_j, qparams, quant=jql.W8A8_INT8,
                                    config=JEngineConfig(**cfg_kw)),
                     prompts[0], np.asarray)
        n = min(a["k_pages"].shape[1], b["k_pages"].shape[1])
        for key in keys:
            np.testing.assert_array_equal(a[key][:, :n], b[key][:, :n])
        for key in ("k_scale_pages", "v_scale_pages"):
            np.testing.assert_allclose(a[key], j[key], rtol=1e-6)
        for key in ("k_pages", "v_pages"):
            assert np.abs(a[key].astype(np.int32) - j[key].astype(np.int32)).max() <= 1

    def test_partial_tail_copy_on_write(self, small, jax_ref_exec):
        """A prompt matching one full page plus part of a cached page copies the
        matched rows into a fresh page instead of prefilling them, and emits the
        reference's tokens."""
        cfg_j, cfg_t, qparams, tparams, _ = small
        rng = np.random.default_rng(5)
        base = rng.integers(1, cfg_t.vocab, size=16).astype(np.int32)
        fork = np.concatenate([base[:12], rng.integers(1, cfg_t.vocab, size=6).astype(np.int32)])
        kw = dict(path="fused-int8", kv_cache="int8", cache_layout="paged", page_size=PS)
        got, eng = _serve_t(cfg_t, tparams, [base, fork], [3, 4], batch_size=1, **kw)
        want, jeng = _serve_j(cfg_j, qparams, [base, fork], [3, 4], batch_size=1, **kw)
        assert eng.counters["cow_copies"] == jeng.counters["cow_copies"] == 1
        assert eng.counters["prefix_tokens_reused"] >= PS + 4
        assert got == want
        eng.pool.check()


class TestAllocatorInvariants:
    def test_copies_are_verbatim(self):
        """The port's ``paging`` module is the reference's, plus one docstring line."""
        t, j = inspect.getsource(tpaging), inspect.getsource(jpaging)
        line = "\nA verbatim copy of ``repro/serving/paging.py``, which is framework-free.\n"
        assert t.replace(line, "", 1) == j

    def test_pool_and_radix_basics(self):
        pool = PagePool(8)
        idx = RadixIndex(4)
        toks = np.arange(12, dtype=np.int32)
        pages = pool.alloc(3)
        idx.insert(toks, pages, pool)
        got, matched, partial = idx.match(np.arange(10, dtype=np.int32))
        assert got == pages[:2] and matched == 8
        assert partial is not None and partial.page == pages[2] and partial.length == 2
        pool.decref(pages)
        assert idx.evict(pool, pool.free_count + 2) == 2
        pool.check()

    def test_refcount_invariants_under_churn(self, small):
        _, cfg_t, _, _, fparams = small
        rng = np.random.default_rng(9)
        shared = rng.integers(1, cfg_t.vocab, size=8).astype(np.int32)
        prompts = []
        for i in range(8):
            sfx = rng.integers(1, cfg_t.vocab, size=3 + (i % 5)).astype(np.int32)
            prompts.append(np.concatenate([shared, sfx]) if i % 2 else sfx)
        done, eng = _serve_t(cfg_t, fparams, prompts, [2 + (i % 4) for i in range(8)],
                             cache_layout="paged", page_size=PS, n_pages=7)
        assert len(done) == 8
        eng.pool.check()
        held = eng.radix.held_pages()
        assert len(held) == len(set(held))
        assert all(eng.pool.refs[p] == 1 for p in held)
        assert eng.pool.used_count == len(held)
        assert eng.counters["peak_pages_in_use"] <= 7

    def test_matched_prefix_survives_eviction_pressure(self, small):
        _, cfg_t, _, _, fparams = small
        rng = np.random.default_rng(21)
        base = rng.integers(1, cfg_t.vocab, size=16).astype(np.int32)
        other = rng.integers(1, cfg_t.vocab, size=9).astype(np.int32)
        kw = dict(cache_layout="paged", page_size=PS, n_pages=4)
        eng = TE.ServeEngine(cfg_t, fparams, device="cpu",
                             config=EngineConfig(batch_size=1, max_len=T, **kw))
        eng.submit([base.copy()], max_new=2)
        eng.run()
        eng.submit([other.copy()], max_new=2)
        eng.run()
        assert len(eng.radix.held_pages()) == 3
        fork = np.concatenate([base, rng.integers(1, cfg_t.vocab, size=1).astype(np.int32)])
        eng.submit([fork.copy()], max_new=15)
        got = eng.run()[0].out
        assert eng.counters["pages_evicted"] >= 1
        assert eng.counters["prefix_tokens_reused"] >= 16
        eng.pool.check()
        cold, _ = _serve_t(cfg_t, fparams, [fork], 15, batch_size=1, prefix_reuse=False, **kw)
        assert got == cold[0]

    def test_pool_too_small_raises_and_releases(self, small):
        _, cfg_t, _, _, fparams = small
        rng = np.random.default_rng(22)
        base = rng.integers(1, cfg_t.vocab, size=16).astype(np.int32)
        eng = TE.ServeEngine(cfg_t, fparams, device="cpu",
                             config=EngineConfig(batch_size=1, max_len=T, cache_layout="paged",
                                                 page_size=PS, n_pages=3))
        eng.submit([base.copy()], max_new=2)
        eng.run()
        held = set(eng.radix.held_pages())
        eng.submit([np.concatenate([base, base[:1]])], max_new=15)   # needs 4 of 3 pages
        with pytest.raises(RuntimeError, match="page pool too small"):
            eng.run()
        eng.pool.check()
        assert set(eng.radix.held_pages()) == held
        assert all(eng.pool.refs[p] == 1 for p in held)

    @pytest.mark.parametrize("layout", ["dense", "paged"])
    def test_max_len_prompt_admits_and_retires(self, small, layout):
        """A max_len prompt emits its one prefill token and retires before any
        decode could write past the cache; a page-exact reservation serves one
        page of prompt plus page_size + 1 tokens in two pages."""
        _, cfg_t, _, _, fparams = small
        rng = np.random.default_rng(3)
        full = rng.integers(1, cfg_t.vocab, size=T).astype(np.int32)
        other = rng.integers(1, cfg_t.vocab, size=5).astype(np.int32)
        kw = {"cache_layout": layout, "page_size": PS} if layout == "paged" else {}
        got, eng = _serve_t(cfg_t, fparams, [full, other], [6, 4], **kw)
        assert len(got[0]) == 1
        solo, _ = _serve_t(cfg_t, fparams, [other], 4, batch_size=1, **kw)
        assert got[1] == solo[0]
        if layout == "paged":
            eng.pool.check()
            out, e2 = _serve_t(cfg_t, fparams, [full[:PS]], PS + 1, batch_size=1,
                               n_pages=2, **kw)
            assert len(out[0]) == PS + 1 and e2.counters["peak_pages_in_use"] == 2


class TestCacheDtype:
    def test_default_follows_params_and_override(self, small):
        """The fp pool follows the tree's first float leaf (f32 here) unless
        ``cache_dtype`` names another; int8 KV keeps int8 codes and f32 scales."""
        _, cfg_t, _, tparams, _ = small
        mk = lambda **kw: TE.ServeEngine(  # noqa: E731
            cfg_t, tparams, quant=tql.W8A8_INT8, device="cpu",
            config=EngineConfig(batch_size=2, max_len=T, path="fused-int8",
                                cache_layout="paged", page_size=PS, **kw))
        assert mk().caches["blocks"][0]["k_pages"].dtype == torch.float32
        eng = mk(cache_dtype=torch.bfloat16)
        assert eng.config.cache_dtype == "bfloat16"
        assert eng.caches["blocks"][0]["k_pages"].dtype == torch.bfloat16
        eng.submit(_mixed_prompts(cfg_t.vocab)[:2], max_new=3)
        assert all(len(r.out) == 3 for r in eng.run())
        eng8 = mk(cache_dtype="bfloat16", kv_cache="int8")
        assert eng8.caches["blocks"][0]["k_pages"].dtype == torch.int8
        assert eng8.caches["blocks"][0]["k_scale_pages"].dtype == torch.float32
        with pytest.raises(ValueError):
            EngineConfig(batch_size=2, max_len=T, cache_dtype="float16")
