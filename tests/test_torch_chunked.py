"""The PyTorch port's chunked prefill against the JAX reference (CPU).

* **Kernel plain version** — ``ops.ragged_prefill_attention`` on CPU tensors (the
  plain version of K6) against ``repro.kernels.ref.ragged_prefill_attention_ref``
  over the reference's kernel sweep (``tests/test_chunked_prefill.py``: chunk
  sizes, mid-page starts, page-aligned chunks, dead slots, all-sentinel rows,
  window and softcap, int8 pools), at rel 1e-5, and once against the Pallas
  kernel in interpret mode. Rows no slot owns are exactly zero.
* **Serving parity** — the port's chunked ``ServeEngine`` and the JAX chunked
  engine (same ``token_budget``; its paged kernels through their jnp oracles,
  ``REPRO_KERNEL_EXEC=ref``) emit the same greedy tokens on fused-int8 with fp
  and int8 KV, with the same counters; fp-KV chunked equals the port's own
  bucketed paged engine at budgets 8 to 64; ``speculate=4`` and a mid-run
  admission burst stay exact. With int8 KV the reference's chunked engine, not
  its bucketed one, is the ground truth (ROADMAP queue C).
* **Validation** — the budget floor and chunked-without-paged raise as the
  reference's config does.
"""
import dataclasses

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
from repro.serving import engine as JE  # noqa: E402
from repro.serving.config import EngineConfig as JEngineConfig  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402

torch.set_num_threads(2)

T = 32                   # cache length of every engine here (tests/test_chunked_prefill.py)
PS = 8
MAX_NEW = [6, 4, 7, 3]
COUNTERS = ("prefill_calls", "decode_steps", "active_slot_steps", "mid_decode_admissions",
            "prompt_tokens", "prefill_tokens", "prefix_hits", "prefix_tokens_reused",
            "cow_copies", "spec_steps", "spec_drafted", "spec_accepted", "chunk_steps",
            "chunk_prefill_rows", "chunk_decode_rows")


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


def _prompts(seed=5, n=4, shared=16):
    """Shared-prefix workload: radix hits make later chunks start mid-page."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(1, 256, size=shared).astype(np.int32)
    return [np.concatenate([pre, rng.integers(1, 256, size=4 + i).astype(np.int32)])
            for i in range(n)]


def _serve_t(small, prompts=None, max_new=None, **kw):
    _, cfg, _, params = small
    eng = TE.ServeEngine(cfg, params, quant=tql.W8A8_INT8, device="cpu",
                         config=EngineConfig(batch_size=3, max_len=T, page_size=PS,
                                             cache_layout="paged", path="fused-int8", **kw))
    eng.submit([p.copy() for p in (prompts or _prompts())], max_new or MAX_NEW)
    return {r.rid: r.out for r in eng.run()}, eng


def _serve_j(small, prompts=None, max_new=None, **kw):
    cfg, _, params, _ = small
    eng = JE.ServeEngine(cfg, params, quant=jql.W8A8_INT8,
                         config=JEngineConfig(batch_size=3, max_len=T, page_size=PS,
                                              cache_layout="paged", path="fused-int8", **kw))
    eng.submit([p.copy() for p in (prompts or _prompts())], max_new or MAX_NEW)
    return {r.rid: r.out for r in eng.run()}, eng


def _same_counters(ej, et):
    assert {k: ej.counters[k] for k in COUNTERS} == {k: et.counters[k] for k in COUNTERS}


# ---------------------------------------------------------------- K6 plain version

def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _rand_pools(rng, P, ps, Hkv, D, kv_int8):
    if not kv_int8:
        return (rng.standard_normal((P, ps, Hkv, D)).astype(np.float32),
                rng.standard_normal((P, ps, Hkv, D)).astype(np.float32), None, None)
    return (rng.integers(-127, 128, (P, ps, Hkv, D)).astype(np.int8),
            rng.integers(-127, 128, (P, ps, Hkv, D)).astype(np.int8),
            (0.002 + 0.05 * rng.random((P, ps, Hkv, 1))).astype(np.float32),
            (0.002 + 0.05 * rng.random((P, ps, Hkv, 1))).astype(np.float32))


def _table(rng, B, P, ps, maxP, kvl):
    """Injective page table covering each row's kv_len, sentinel tails."""
    tab = np.full((B, maxP), P, np.int32)
    perm, off = rng.permutation(P), 0
    for b in range(B):
        n = -(-int(kvl[b]) // ps)
        tab[b, :n] = perm[off: off + n]
        off += n
    return tab


def _ragged_case(rng, B, Hkv, G, D, P, ps, maxP, C, kv_int8, *, force_qln=None,
                 force_kvl=None, sentinel_row=None):
    """Random packed chunks (numpy): q_len in [0, min(C, kv_len)] per slot unless
    forced, contiguous packing, kv_len inside the row's pages."""
    kp, vp, ks, vs = _rand_pools(rng, P, ps, Hkv, D, kv_int8)
    if force_kvl is None:
        per = max(1, min(maxP, P // B))
        kvl = np.array([int(rng.integers(1, per * ps + 1)) for _ in range(B)], np.int32)
    else:
        kvl = np.asarray(force_kvl, np.int32)
    if force_qln is None:
        qln = np.array([int(rng.integers(0, min(C, int(k)) + 1)) for k in kvl], np.int32)
    else:
        qln = np.asarray(force_qln, np.int32)
        kvl = np.maximum(kvl, qln)
    tab = _table(rng, B, P, ps, maxP, kvl)
    if sentinel_row is not None:
        tab[sentinel_row] = P
    qs = np.concatenate([[0], np.cumsum(qln)[:-1]]).astype(np.int32)
    Nt = max(int(qln.sum()), 1)
    q = rng.standard_normal((Nt, Hkv * G, D)).astype(np.float32)
    kn = rng.standard_normal((Nt, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((Nt, Hkv, D)).astype(np.float32)
    return dict(q=q, kn=kn, vn=vn, kp=kp, vp=vp, ks=ks, vs=vs, tab=tab, qs=qs, qln=qln,
                kvl=kvl)


def _port(c, C, **kw):
    return tops.ragged_prefill_attention(
        _t(c["q"]), _t(c["kn"]), _t(c["vn"]), _t(c["kp"]), _t(c["vp"]), _t(c["tab"]),
        _t(c["qs"]), _t(c["qln"]), _t(c["kvl"]), chunk_cap=C, k_scale_pages=_t(c["ks"]),
        v_scale_pages=_t(c["vs"]), **kw).numpy()


def _oracle(c, C, G, **kw):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    Nt, H, D = c["q"].shape
    out = jref.ragged_prefill_attention_ref(
        j(c["q"].reshape(Nt, H // G, G, D)), j(c["kn"]), j(c["vn"]), j(c["kp"]), j(c["vp"]),
        j(c["tab"]), j(c["qs"]), j(c["qln"]), j(c["kvl"]), chunk_cap=C,
        k_scale_pages=j(c["ks"]), v_scale_pages=j(c["vs"]), **kw)
    return np.asarray(out).reshape(Nt, H, D)


def _unowned_rows(c):
    owned = np.zeros(c["q"].shape[0], bool)
    for s, n in zip(c["qs"], c["qln"]):
        owned[s:s + n] = True
    return ~owned


SHAPES = [(2, 2, 2, 16, 8, 8, 4), (1, 1, 4, 32, 4, 16, 2), (3, 2, 1, 64, 16, 4, 8)]


class TestRaggedPlainVersion:
    @pytest.mark.parametrize("kv_int8", [False, True])
    @pytest.mark.parametrize("C", [4, 8, 16])
    @pytest.mark.parametrize("B,Hkv,G,D,P,ps,maxP", SHAPES)
    def test_chunk_sweep(self, B, Hkv, G, D, P, ps, maxP, C, kv_int8):
        rng = np.random.default_rng(1000 * C + 10 * B + kv_int8)
        c = _ragged_case(rng, B, Hkv, G, D, P, ps, maxP, C, kv_int8)
        got = _port(c, C)
        np.testing.assert_allclose(got, _oracle(c, C, G), rtol=1e-5, atol=1e-5)
        assert (got[_unowned_rows(c)] == 0).all() and np.isfinite(got).all()

    @pytest.mark.parametrize("window,softcap", [(5, None), (None, 30.0)])
    def test_window_and_softcap(self, window, softcap):
        rng = np.random.default_rng(77)
        c = _ragged_case(rng, 2, 2, 2, 16, 8, 8, 4, 8, True)
        np.testing.assert_allclose(_port(c, 8, window=window, softcap=softcap),
                                   _oracle(c, 8, 2, window=window, softcap=softcap),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("kv_int8", [False, True])
    def test_mid_page_chunk_start(self, kv_int8):
        rng = np.random.default_rng(21 + kv_int8)
        c = _ragged_case(rng, 2, 2, 2, 16, 8, 8, 4, 8, kv_int8, force_kvl=[8 + 3, 16 + 5],
                         force_qln=[5, 6])
        np.testing.assert_allclose(_port(c, 8), _oracle(c, 8, 2), rtol=1e-5, atol=1e-5)

    def test_page_aligned_chunk_boundaries(self):
        rng = np.random.default_rng(31)
        c = _ragged_case(rng, 2, 1, 2, 16, 8, 8, 4, 8, True, force_kvl=[16, 24],
                         force_qln=[8, 8])
        np.testing.assert_allclose(_port(c, 8), _oracle(c, 8, 2), rtol=1e-5, atol=1e-5)

    def test_dead_slot_rows_stay_zero(self):
        rng = np.random.default_rng(41)
        c = _ragged_case(rng, 3, 2, 2, 16, 8, 8, 4, 8, True, force_qln=[4, 0, 5])
        got = _port(c, 8)
        np.testing.assert_allclose(got, _oracle(c, 8, 2), rtol=1e-5, atol=1e-5)
        assert np.isfinite(got).all()

    def test_all_sentinel_row_is_finite(self):
        rng = np.random.default_rng(51)
        c = _ragged_case(rng, 2, 2, 2, 16, 8, 8, 4, 8, True, force_kvl=[16, 1],
                         force_qln=[6, 1], sentinel_row=1)
        got = _port(c, 8)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[:6], _oracle(c, 8, 2)[:6], rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("kv_int8", [False, True])
    @pytest.mark.parametrize("qln,kvl", [([1, 1, 1, 125], [70, 51, 13, 389 + 125]),
                                         ([128, 0, 0, 0], [389 + 128, 0, 0, 0])])
    def test_budget_128_packed_block(self, qln, kvl, kv_int8):
        """The full-width chunked step's packed block (token_budget 128, chunk_cap
        128): decode rows beside a chunk that starts mid-page after a 389-token
        prefix and whose own tokens fill whole 32-position key chunks."""
        rng = np.random.default_rng(sum(qln) + kv_int8)
        c = _ragged_case(rng, 4, 2, 2, 16, 256, 8, 128, 128, kv_int8, force_kvl=kvl,
                         force_qln=qln)
        got = _port(c, 128)
        np.testing.assert_allclose(got, _oracle(c, 128, 2), rtol=1e-5, atol=1e-5)
        assert got.shape[0] == 128 and np.isfinite(got).all()

    def test_full_budget_single_slot(self):
        rng = np.random.default_rng(71)
        c = _ragged_case(rng, 1, 2, 2, 16, 8, 8, 4, 16, False, force_kvl=[16],
                         force_qln=[16])
        np.testing.assert_allclose(_port(c, 16), _oracle(c, 16, 2), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("kv_int8", [False, True])
    def test_decode_rows_match_decode_plain_version(self, kv_int8):
        """q_len == 1 rows whose packed k/v equal the pool's newest row are the
        decode plain version's rows (the card holds K6 ≡ K4 bitwise for fp pools:
        tests/test_torch_cuda.py)."""
        rng = np.random.default_rng(61)
        c = _ragged_case(rng, 2, 2, 2, 16, 8, 8, 4, 4, kv_int8, force_kvl=[13, 7],
                         force_qln=[1, 1])
        for b, n in enumerate(c["kvl"]):
            p, r = c["tab"][b, (n - 1) // 8], (n - 1) % 8
            k, v = c["kp"][p, r].astype(np.float32), c["vp"][p, r].astype(np.float32)
            if kv_int8:
                k, v = k * c["ks"][p, r], v * c["vs"][p, r]
            c["kn"][b], c["vn"][b] = k, v
        got = _port(c, 4)
        dec = tops.paged_decode_attention(
            _t(c["q"])[:, None], _t(c["kp"]), _t(c["vp"]), _t(c["tab"]), _t(c["kvl"]),
            k_scale_pages=_t(c["ks"]), v_scale_pages=_t(c["vs"]))[:, 0].numpy()
        np.testing.assert_allclose(got, dec, rtol=1e-5, atol=1e-5)

    def test_against_pallas_interpret(self):
        """One case against the reference's Pallas kernel in interpret mode."""
        rng = np.random.default_rng(91)
        c = _ragged_case(rng, 3, 2, 2, 16, 8, 8, 4, 8, True, force_kvl=[11, 1, 20],
                         force_qln=[5, 0, 8])
        j = lambda a: jnp.asarray(a)  # noqa: E731
        want = jops.ragged_prefill_attention(
            j(c["q"]), j(c["kn"]), j(c["vn"]), j(c["kp"]), j(c["vp"]), j(c["tab"]),
            j(c["qs"]), j(c["qln"]), j(c["kvl"]), chunk_cap=8, k_scale_pages=j(c["ks"]),
            v_scale_pages=j(c["vs"]))
        np.testing.assert_allclose(_port(c, 8), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- serving

class TestChunkedServing:
    @pytest.mark.parametrize("kv", ["fp", "int8"])
    @pytest.mark.parametrize("tb", [9, 12])
    def test_token_exact_vs_jax_chunked(self, small, jax_ref_exec, kv, tb):
        want, ej = _serve_j(small, kv_cache=kv, chunked=True, token_budget=tb)
        got, et = _serve_t(small, kv_cache=kv, chunked=True, token_budget=tb)
        assert got == want
        _same_counters(ej, et)
        assert et.counters["chunk_prefill_rows"] > 0     # multi-chunk prompts
        assert et.counters["prefix_hits"] > 0

    @pytest.mark.parametrize("tb", [8, 10, 14, 16, 24, 64])
    def test_fp_kv_chunked_equals_bucketed(self, small, tb):
        """fp KV is chunk-invariant: every budget serves the bucketed tokens."""
        base, _ = _serve_t(small)
        got, eng = _serve_t(small, chunked=True, token_budget=tb)
        assert got == base
        assert eng.counters["chunk_steps"] > 0

    def test_chunked_speculative(self, small, jax_ref_exec):
        """Draft windows ride the packed launch as q_len > 1 rows."""
        want, ej = _serve_j(small, kv_cache="int8", chunked=True, token_budget=16,
                            speculate=4)
        got, et = _serve_t(small, kv_cache="int8", chunked=True, token_budget=16, speculate=4)
        assert got == want
        _same_counters(ej, et)
        base, _ = _serve_t(small, chunked=True, token_budget=16)
        fp_spec, _ = _serve_t(small, chunked=True, token_budget=16, speculate=4)
        assert fp_spec == base

    def test_admission_burst(self, small, jax_ref_exec):
        """Requests injected mid-run interleave with the decoding slots."""
        late = [np.arange(2, 2 + n, dtype=np.int32) * 5 % 251 + 1 for n in (18, 11)]
        outs = []
        for build, kw in ((JE.ServeEngine, {}), (TE.ServeEngine, {"device": "cpu"})):
            cfg, params, cfg_cls, quant = (
                (small[0], small[2], JEngineConfig, jql.W8A8_INT8)
                if build is JE.ServeEngine else
                (small[1], small[3], EngineConfig, tql.W8A8_INT8))
            eng = build(cfg, params, quant=quant, **kw,
                        config=cfg_cls(batch_size=3, max_len=T, page_size=PS,
                                       cache_layout="paged", path="fused-int8",
                                       kv_cache="int8", chunked=True, token_budget=10))
            eng.submit(_prompts(), MAX_NEW)
            finished = []
            for _ in range(3):
                assert eng.step(finished)
            eng.submit(late, [5, 5])
            while eng.step(finished):
                pass
            outs.append(({r.rid: list(r.out) for r in finished}, eng))
        (want, ej), (got, et) = outs
        assert got == want and len(got) == 6
        _same_counters(ej, et)
        assert et.counters["mid_decode_admissions"] > 0

    def test_long_prompt_retires_at_cap(self, small):
        prompts = [np.random.default_rng(9).integers(1, 256, size=T).astype(np.int32)]
        base, _ = _serve_t(small, prompts=prompts, max_new=[4])
        got, _ = _serve_t(small, prompts=prompts, max_new=[4], chunked=True, token_budget=8)
        assert got == base and all(len(v) == 1 for v in got.values())

    def test_pure_decode_steps_take_the_decode_launch(self, small):
        """With fp KV a step with no prefill work runs the decode step; with int8
        KV or speculation every step is a packed one."""
        calls = {}
        for kv in ("fp", "int8"):
            _, cfg, _, params = small
            eng = TE.ServeEngine(cfg, params, quant=tql.W8A8_INT8, device="cpu",
                                 config=EngineConfig(batch_size=3, max_len=T, page_size=PS,
                                                     cache_layout="paged", path="fused-int8",
                                                     kv_cache=kv, chunked=True,
                                                     token_budget=12))
            n = [0]
            inner = eng._decode_step

            def counted(*a, inner=inner, n=n):
                n[0] += 1
                return inner(*a)

            eng._decode_step = counted
            eng.submit(_prompts(), MAX_NEW)
            eng.run()
            calls[kv] = (n[0], eng.counters["chunk_steps"], eng.counters["decode_steps"])
            assert eng.counters["chunk_decode_only_steps"] == n[0]
        assert calls["fp"][0] > 0 and calls["int8"][0] == 0
        # every decode step is either a packed step with decode rows or a plain one
        assert calls["int8"][1] >= calls["int8"][2]

    def test_packed_step_launches_live_rows_only(self, small):
        """A packed step's rows are its decode rows and chunks, never padding up
        to the budget; prefill steps fill the budget."""
        _, cfg, _, params = small
        eng = TE.ServeEngine(cfg, params, quant=tql.W8A8_INT8, device="cpu",
                             config=EngineConfig(batch_size=3, max_len=T, page_size=PS,
                                                 cache_layout="paged", path="fused-int8",
                                                 kv_cache="int8", chunked=True,
                                                 token_budget=12))
        rows, inner = [], eng._chunk_step

        def counted(params, tokens, q_start, q_len, *rest):
            rows.append((tokens.shape[1], int(q_len.sum()), int(rest[1].numel())))
            return inner(params, tokens, q_start, q_len, *rest)

        eng._chunk_step = counted
        eng.submit(_prompts(), MAX_NEW)
        eng.run()
        assert rows and all(n == live == npos <= 12 for n, live, npos in rows)
        assert any(n == 12 for n, _, _ in rows) and any(n < 12 for n, _, _ in rows)


class TestChunkedModelAndValidation:
    def test_chunk_mode_arguments(self, small):
        _, cfg, _, params = small
        caches = TM.init_cache(cfg, 2, T, dtype=torch.float32, layout="paged", page_size=PS,
                               device="cpu")
        with pytest.raises(ValueError, match="chunk"):
            TM.apply(params, {"tokens": torch.zeros((1, 4), dtype=torch.int64)}, cfg,
                     mode="chunked", caches=caches)
        with pytest.raises(ValueError, match="chunk"):
            TM.apply(params, {"tokens": torch.zeros((1, 4), dtype=torch.int64)}, cfg,
                     mode="decode", caches=caches, chunk={})
        dense = TM.init_cache(cfg, 2, T, dtype=torch.float32, device="cpu")
        chunk = {k: torch.zeros(n, dtype=torch.int32) for k, n in
                 (("q_start", 2), ("q_len", 2), ("kv_len", 2), ("positions", 4),
                  ("slot_ids", 4))}
        with pytest.raises(ValueError, match="paged"):
            TM.apply(params, {"tokens": torch.zeros((1, 4), dtype=torch.int64)}, cfg,
                     mode="chunked", caches=dense, chunk=chunk)

    def test_model_chunk_logits_match_jax(self, small, jax_ref_exec):
        """One packed row (a 5-token cold chunk, a dead slot, a 3-token chunk) gives
        the reference's logits at every row and its int8 pages, within one code
        (RoPE's sin/cos differ by ulps, ROADMAP queue C)."""
        cfg_j, cfg_t, qparams, tparams = small
        rng = np.random.default_rng(3)
        toks = rng.integers(1, 256, size=(1, 8)).astype(np.int32)
        table = np.full((3, T // PS), 9, np.int32)
        table[0, 0], table[2, 0] = 4, 1
        chunk = dict(q_start=np.array([0, 5, 5], np.int32), q_len=np.array([5, 0, 3], np.int32),
                     kv_len=np.array([5, 0, 3], np.int32),
                     positions=np.array([0, 1, 2, 3, 4, 0, 1, 2], np.int32),
                     slot_ids=np.array([0, 0, 0, 0, 0, 2, 2, 2], np.int32))
        jc = JM.init_cache(cfg_j, 3, T, dtype=jnp.float32, kv_int8=True, layout="paged",
                           page_size=PS, n_pages=9)
        jc["page_table"] = jnp.asarray(table)
        jl, jex = JM.apply(qparams, {"tokens": jnp.asarray(toks)}, cfg_j, mode="chunked",
                           caches=jc, chunk={k: jnp.asarray(v) for k, v in chunk.items()})
        tc = TM.init_cache(cfg_t, 3, T, dtype=torch.float32, kv_int8=True, layout="paged",
                           page_size=PS, n_pages=9, device="cpu")
        tc["page_table"] = torch.from_numpy(table)
        tl, _ = TM.apply(tparams, {"tokens": torch.from_numpy(toks).long()}, cfg_t,
                         mode="chunked", caches=tc,
                         chunk={k: torch.from_numpy(v) for k, v in chunk.items()})
        assert tl.shape == (1, 8, cfg_t.vocab_padded)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        for name in ("k_pages", "v_pages"):
            a = np.asarray(jex["caches"]["blocks"][0][name]).astype(np.int32)
            b = tc["blocks"][0][name].numpy().astype(np.int32)
            assert np.abs(a - b).max() <= 1

    def test_budget_floor_enforced(self):
        with pytest.raises(ValueError, match="token_budget"):
            EngineConfig(batch_size=3, max_len=T, cache_layout="paged", page_size=PS,
                         chunked=True, token_budget=8, speculate=4)
        with pytest.raises(ValueError):
            JEngineConfig(batch_size=3, max_len=T, cache_layout="paged", page_size=PS,
                          chunked=True, token_budget=8, speculate=4)

    def test_chunked_requires_paged(self):
        with pytest.raises(ValueError, match="paged"):
            EngineConfig(batch_size=3, max_len=T, chunked=True, token_budget=16)
        with pytest.raises(ValueError):
            JEngineConfig(batch_size=3, max_len=T, chunked=True, token_budget=16)
