"""The rest of the dense zoo in the PyTorch port against the JAX reference (CPU).

Smoke configs in float32, params from ``repro.models.model.init_params`` carried
across with ``convert.params_from_numpy``; the reference runs under ``jax.jit``
and, in its engines, with its paged kernels through their jnp oracles
(``REPRO_KERNEL_EXEC=ref``).

* **gemma2-9b** (window 16, so the 20-40 token prompts bind it; attention and
  final softcaps; ``embed_scale``): ``apply`` logits on train / prefill / decode
  within rtol 1e-5, the scaled embedding bitwise, and ``ServeEngine`` token-exact
  against the JAX engine on fused-int8 × {dense, paged} × {fp, int8 KV},
  ``speculate=4``, and chunked against the JAX *chunked* engine.
* **nemotron-4-15b and deepseek-coder-33b** (untied heads): token-exact on
  fused-int8, dequant-fp and fake. Under ``mode="int8"`` the fp ``lm_head`` is
  prepared on the fly from the column max of the call's rows: that column max is
  bitwise the reference's and the codes and scales follow it (ROADMAP queue C's
  pow rule). A chunked step whose budget exceeds its live rows launches all
  ``token_budget`` rows, as the reference does; launching only the live rows
  moves the head's column max and with it the logits. The step builders
  (``make_prefill_step``/``make_decode_step``) match the reference's.
* **pixtral-12b**: prefill with patch embeddings and decode within rtol 1e-5;
  text-only serving token-exact. **hubert-xlarge**: ``make_prefill_step``'s
  encoder logits at S = 128 (the flash rule) within 1e-5 through the fp and the
  fused-int8 ctx; the slot-table engine refuses it.
* **convert** round-trips ``lm_head``, ``frontend`` and both ``blocks`` entries;
  calibration names ``/L{b}/S{i}/...`` stack onto ``blocks/{i}``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.config import EngineConfig as JEngineConfig  # noqa: E402

import _jax_jitted as J  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import calibration as tcal, qlinear as tql  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import QuantContext  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.config import EngineConfig, NotPortedError  # noqa: E402

torch.set_num_threads(2)

T = 64                                   # cache length of every engine here
GEMMA_LENS, GEMMA_NEW = [20, 33, 40], [5, 3, 4]
LENS, MAX_NEW = [6, 11, 9], [4, 3, 5]
ARCHS = ("gemma2-9b", "nemotron-4-15b", "deepseek-coder-33b", "pixtral-12b", "hubert-xlarge")


@dataclasses.dataclass
class Zoo:
    cfg_j: object
    cfg_t: object
    jtrees: dict                         # "fp" raw, "int8" quantize_tree (W8A8, c = 1)
    ttrees: dict


_ZOO = {}


def _zoo(arch: str) -> Zoo:
    if arch not in _ZOO:
        cfg_j = dataclasses.replace(jget(arch, smoke=True), dtype="float32")
        cfg_t = dataclasses.replace(tget(arch, smoke=True), dtype="float32")
        raw = JM.init_params(jax.random.PRNGKey(0), cfg_j)
        jtrees = {"fp": raw, "int8": J.quantize_tree(raw, jql.W8A8_INT8)}
        ttrees = {k: convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, v),
                                               device="cpu") for k, v in jtrees.items()}
        _ZOO[arch] = Zoo(cfg_j, cfg_t, jtrees, ttrees)
    return _ZOO[arch]


@pytest.fixture
def jax_ref_exec(monkeypatch):
    """The JAX engine's paged kernels run their jnp oracles, not interpret mode."""
    monkeypatch.setenv("REPRO_KERNEL_EXEC", "ref")


def _np(t):
    return t.detach().cpu().float().numpy()


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


QUANTS = {"fused-int8": ("int8", "W8A8_INT8"), "dequant-fp": ("int8", "W8A8_INT8"),
          "fake": ("fp", "W8A8_CROSSQUANT")}


def _serve_pair(z: Zoo, path, prompts, max_new, **kw):
    """The same traffic through the JAX engine and the port's; returns both."""
    tree, quant = QUANTS[path]
    jeng = JE.ServeEngine(z.cfg_j, z.jtrees[tree], quant=getattr(jql, quant),
                          config=JEngineConfig(batch_size=2, max_len=T, path=path, **kw))
    jeng.submit([p.copy() for p in prompts], max_new=max_new)
    jdone = jeng.run()
    teng = TE.ServeEngine(z.cfg_t, z.ttrees[tree], quant=getattr(tql, quant), device="cpu",
                          config=EngineConfig(batch_size=2, max_len=T, path=path, **kw))
    teng.submit([p.copy() for p in prompts], max_new=max_new)
    tdone = teng.run()
    return jeng, jdone, teng, tdone


def _token_exact(jdone, tdone, label):
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for tr, jr in zip(tdone, jdone):
        assert tr.out == jr.out, (label, tr.rid, tr.out, jr.out)


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


# ======================================================================================
# Structure: block spec, init, convert, calibration names
# ======================================================================================

@pytest.mark.parametrize("arch", ARCHS)
def test_tree_matches_reference(arch):
    """``init_params``' tree has the reference's leaves and shapes (lm_head when
    untied, frontend/proj, one ``blocks`` entry per sublayer kind), and convert
    round-trips the reference's tree, both blocks entries included."""
    z = _zoo(arch)
    spec = TM.block_spec(z.cfg_t)
    jspec = JM.block_spec(z.cfg_j)
    assert (spec.sublayers, spec.n_blocks) == (jspec.sublayers, jspec.n_blocks)
    mine = TM.init_params(torch.Generator().manual_seed(0), z.cfg_t, device="cpu")
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(convert.params_to_numpy(mine)) == shapes(z.jtrees["fp"])
    back = convert.params_to_numpy(z.ttrees["int8"])
    flat_j = jax.tree_util.tree_leaves_with_path(z.jtrees["int8"])
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path], np.asarray(leaf))
    assert ("lm_head" in back) == (not z.cfg_t.tie_embeddings)
    assert ("frontend" in back) == (z.cfg_t.frontend != "none")
    assert len(back["blocks"]) == len(spec.sublayers)


def test_calibration_names_stack_per_sublayer():
    """gemma2's observer names /L{b}/S0/... (local) and /L{b}/S1/... (global) stack
    onto blocks/0 and blocks/1, the lm_head's stays top-level; the port's tables
    from its own calibration pass equal the reference's (under ``jax.jit``)."""
    z = _zoo("gemma2-9b")
    toks = np.random.default_rng(3).integers(1, z.cfg_t.vocab, (2, 24))
    tobs = tcal.Observer()
    jt = J.stacked_tables(z.jtrees["fp"], {"tokens": jnp.asarray(toks)}, z.cfg_j,
                          jql.W8A8_INT8, mode="train", unroll=True)
    TM.apply(z.ttrees["fp"], {"tokens": torch.as_tensor(toks)}, z.cfg_t,
             ctx=QuantContext(tql.W8A8_INT8, observer=tobs), mode="train", unroll=True)
    tt = tcal.stack_tables(tobs.tables())
    assert sorted(jt) == sorted(tt)
    L2 = z.cfg_t.n_layers // 2
    for i in (0, 1):
        assert tt[f"blocks/{i}/attn/wq"].shape == (L2, z.cfg_t.d_model)
        assert tt[f"blocks/{i}/mlp/down"].shape == (L2, z.cfg_t.d_ff)
    assert "lm_head" not in tt                     # gemma2 ties its head
    for k in jt:
        np.testing.assert_allclose(tt[k], jt[k], rtol=1e-5, atol=1e-6)


def test_unsupported_families_still_raise():
    """No family is refused any more: the SSM and hybrid block specs equal the
    reference's (mamba2 [ssm] × L; zamba2 smoke 2 super-blocks of 2 and a tail of
    1, FULL 6 super-blocks of 6 with the shared block and a 2-layer tail), as do
    the MoE's (tests/test_torch_moe.py serves it). An unknown family raises."""
    for arch in ("mamba2-130m", "zamba2-1.2b", "granite-moe-3b-a800m"):
        for smoke in (True, False):
            assert TM.block_spec(tget(arch, smoke=smoke)) == TM.BlockSpec(
                **dataclasses.asdict(JM.block_spec(jget(arch, smoke=smoke))))
    full = TM.block_spec(tget("zamba2-1.2b"))
    assert (full.sublayers, full.n_blocks, full.tail, full.shared_attn) == (
        ("ssm",) * 6, 6, ("ssm",) * 2, True)
    with pytest.raises(ValueError, match="unknown family"):
        TM.block_spec(dataclasses.replace(tget("mamba2-130m", smoke=True), family="rnn"))


# ======================================================================================
# gemma2-9b: local/global attention with softcaps
# ======================================================================================

def test_gemma2_embed_scale_bitwise():
    z = _zoo("gemma2-9b")
    toks = np.random.default_rng(1).integers(0, z.cfg_t.vocab, (2, 9))
    want = np.asarray(jax.jit(lambda p, t: JM._embed(p, {"tokens": t}, z.cfg_j))(
        z.jtrees["fp"], jnp.asarray(toks)))
    got = _np(TM._embed(z.ttrees["fp"], {"tokens": torch.as_tensor(toks)}, z.cfg_t))
    np.testing.assert_array_equal(got, want)


def test_gemma2_apply_modes():
    """train / prefill (right-padded, per-slot lengths) / 4 decode steps, dense fp
    KV, fp ctx: logits within rtol 1e-5 of the jitted reference; the window (16)
    binds on every local layer."""
    z = _zoo("gemma2-9b")
    cfg_j, cfg_t = z.cfg_j, z.cfg_t
    assert cfg_t.window == 16 and cfg_t.layer_pattern == "local_global"
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg_t.vocab, (2, 40))
    lens = np.array([40, 29], np.int32)
    jp, tp = z.jtrees["fp"], z.ttrees["fp"]

    want = np.asarray(jax.jit(lambda p, t: JM.apply(p, {"tokens": t}, cfg_j)[0])(
        jp, jnp.asarray(toks)))
    got = _np(TM.apply(tp, {"tokens": torch.as_tensor(toks)}, cfg_t)[0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    jc = JM.init_cache(cfg_j, 2, T, dtype=jnp.float32)
    tc = TM.init_cache(cfg_t, 2, T, dtype=torch.float32, device="cpu")

    @jax.jit
    def jpre(p, t, c, n):
        lg, ex = JM.apply(p, {"tokens": t}, cfg_j, mode="prefill", caches=c, cur_len=n)
        return lg, ex["caches"]

    @jax.jit
    def jdec(p, t, c, n):
        lg, ex = JM.apply(p, {"tokens": t}, cfg_j, mode="decode", caches=c, cur_len=n)
        return lg, ex["caches"]

    jl, jc = jpre(jp, jnp.asarray(toks), jc, jnp.asarray(lens))
    tl, _ = TM.apply(tp, {"tokens": torch.as_tensor(toks)}, cfg_t, mode="prefill", caches=tc,
                     cur_len=torch.as_tensor(lens))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5, atol=1e-5)
    for i in range(4):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.asarray(lens + i + 1))
        tl, _ = TM.apply(tp, {"tokens": torch.as_tensor(tok.copy())}, cfg_t, mode="decode",
                         caches=tc, cur_len=torch.as_tensor(lens + i + 1))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_gemma2_window_binds():
    """The local layers' window changes the logits: the same tree with the window
    widened past every prompt gives other logits at the 40-token prompt."""
    z = _zoo("gemma2-9b")
    toks = torch.as_tensor(np.random.default_rng(2).integers(1, z.cfg_t.vocab, (1, 40)))
    base = _np(TM.apply(z.ttrees["fp"], {"tokens": toks}, z.cfg_t)[0])
    wide = _np(TM.apply(z.ttrees["fp"], {"tokens": toks},
                        dataclasses.replace(z.cfg_t, window=4096))[0])
    assert np.abs(base[0, :16] - wide[0, :16]).max() == 0.0     # inside the window
    assert np.abs(base[0, 16:] - wide[0, 16:]).max() > 1e-4     # past it


@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_gemma2_serving_token_exact(jax_ref_exec, layout, kv):
    z = _zoo("gemma2-9b")
    jeng, jdone, teng, tdone = _serve_pair(
        z, "fused-int8", _prompts(z.cfg_t.vocab, GEMMA_LENS), GEMMA_NEW, kv_cache=kv,
        cache_layout=layout, page_size=8)
    _token_exact(jdone, tdone, (layout, kv))
    for key in ("prefill_calls", "decode_steps", "prefix_tokens_reused"):
        assert teng.counters[key] == jeng.counters[key], key


def test_gemma2_speculative_token_exact(jax_ref_exec):
    """speculate=4 over motif-tiled prompts (the drafter proposes every step)."""
    z = _zoo("gemma2-9b")
    rng = np.random.default_rng(4)
    prompts = [np.tile(rng.integers(1, z.cfg_t.vocab, size=6).astype(np.int32), 5)[:n]
               for n in (20, 27, 30)]
    jeng, jdone, teng, tdone = _serve_pair(z, "fused-int8", prompts, [8, 6, 7],
                                           cache_layout="paged", page_size=8, speculate=4)
    _token_exact(jdone, tdone, "speculate=4")
    assert teng.counters["spec_steps"] == jeng.counters["spec_steps"] > 0
    assert teng.counters["spec_accepted"] == jeng.counters["spec_accepted"]


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_gemma2_chunked_token_exact(jax_ref_exec, kv):
    """Against the JAX chunked engine (budget 16: every prompt in 2-3 chunks, the
    later ones past the window)."""
    z = _zoo("gemma2-9b")
    jeng, jdone, teng, tdone = _serve_pair(
        z, "fused-int8", _prompts(z.cfg_t.vocab, GEMMA_LENS), GEMMA_NEW, kv_cache=kv,
        cache_layout="paged", page_size=8, chunked=True, token_budget=16)
    _token_exact(jdone, tdone, ("chunked", kv))
    assert teng.counters["chunk_steps"] == jeng.counters["chunk_steps"] > 0
    assert teng.counters["chunk_prefill_rows"] == jeng.counters["chunk_prefill_rows"]


# ======================================================================================
# Untied heads: nemotron-4-15b and deepseek-coder-33b
# ======================================================================================

@pytest.mark.parametrize("path", ["fused-int8", "dequant-fp", "fake"])
@pytest.mark.parametrize("arch", ["nemotron-4-15b", "deepseek-coder-33b"])
def test_untied_serving_token_exact(jax_ref_exec, arch, path):
    z = _zoo(arch)
    tops.reset_launches()
    jeng, jdone, teng, tdone = _serve_pair(z, path, _prompts(z.cfg_t.vocab, LENS, seed=1),
                                           MAX_NEW)
    _token_exact(jdone, tdone, (arch, path))
    assert all(n == 0 for n in tops.LAUNCHES.values())      # CPU: plain versions only
    assert teng._rows_coupled               # the head is prepared on the fly, or fake


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "deepseek-coder-33b"])
def test_untied_head_prepared_on_the_fly(arch):
    """The head's fp ``{"w"}`` under ``mode="int8"``: the column max of the call's
    rows is bitwise the reference's, and so is the leaf prepared in the jitted
    form (``sw`` by the f32 reciprocal of qmax) where no pow intervenes (α = 1);
    at α = 0.15 the codes stay within one step and the scales within rel 1e-6
    (torch's and XLA's f32 pow part by an ulp, ROADMAP C). The linear's output
    agrees within rel 1e-5."""
    z = _zoo(arch)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 1, z.cfg_t.d_model)).astype(np.float32)
    x[..., rng.choice(z.cfg_t.d_model, 3, replace=False)] *= 25.0
    w = np.asarray(z.jtrees["int8"]["lm_head"]["w"])
    jcm = np.asarray(jax.jit(lambda v: jnp.max(jnp.abs(v), axis=(0, 1)))(x))
    tcm = _np(tql._col_absmax(torch.as_tensor(x)))
    np.testing.assert_array_equal(tcm, jcm)
    for cfg_j, cfg_t in ((dataclasses.replace(jql.W8A8_INT8, alpha=1.0),
                          dataclasses.replace(tql.W8A8_INT8, alpha=1.0)),
                         (jql.W8A8_INT8, tql.W8A8_INT8)):
        want = jax.jit(lambda ww, c: jql.prepare_int8({"w": ww}, cfg_j, cmax=c))(w, jcm)
        got = tql.prepare_int8({"w": torch.as_tensor(w.copy())}, cfg_t,
                               cmax=torch.as_tensor(tcm), jitted=True)
        want = {k: np.asarray(v) for k, v in want.items()}
        got = {k: _np(v) for k, v in got.items()}
        if cfg_t.alpha == 1.0:
            for k in ("qw", "sw", "bcol"):
                np.testing.assert_array_equal(got[k], want[k])
        else:
            assert np.abs(got["qw"].astype(np.int32) - want["qw"].astype(np.int32)).max() <= 1
            np.testing.assert_allclose(got["sw"], want["sw"], rtol=1e-6)
            np.testing.assert_allclose(got["bcol"], want["bcol"], rtol=1e-6)
    jy = np.asarray(jax.jit(lambda p, v: jql.apply(p, v, jql.W8A8_INT8))(
        z.jtrees["int8"]["lm_head"], x))
    ty = _np(tql.apply(z.ttrees["int8"]["lm_head"], torch.as_tensor(x), tql.W8A8_INT8))
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5 * np.abs(jy).max())


def test_rows_coupled_rule():
    """A step's rows couple under fake quantization, and under ``mode="int8"``
    wherever a linear is still fp (the untied head); a tied, prepared tree's rows
    are independent."""
    assert TE._rows_coupled(_zoo("nemotron-4-15b").ttrees["int8"], tql.W8A8_INT8)
    assert not TE._rows_coupled(_zoo("gemma2-9b").ttrees["int8"], tql.W8A8_INT8)
    assert TE._rows_coupled(_zoo("gemma2-9b").ttrees["fp"], tql.W8A8_INT8)
    assert TE._rows_coupled(_zoo("gemma2-9b").ttrees["fp"], tql.W8A8_CROSSQUANT)
    assert not TE._rows_coupled(_zoo("nemotron-4-15b").ttrees["int8"], tql.FP)


def test_untied_chunked_rows_coupled(jax_ref_exec, monkeypatch):
    """Chunked fused-int8 with int8 KV (every step packed) and a budget of 24,
    more than the live rows of most steps: the port's packed steps launch all 24
    rows into the head, as the JAX chunked engine does, and serve its tokens.
    Launching only the live rows moves the head's on-the-fly column max (padding
    rows enter it) and with it the logits."""
    z = _zoo("deepseek-coder-33b")
    prompts = _prompts(z.cfg_t.vocab, [14, 9, 19], seed=6)
    kw = dict(kv_cache="int8", cache_layout="paged", page_size=8, chunked=True,
              token_budget=24)
    heads = []                                     # (rows, column max) per head call
    col_absmax = tql._col_absmax

    def recording(x):
        cm = col_absmax(x)
        heads.append((x.shape[:-1].numel(), cm.clone()))
        return cm

    monkeypatch.setattr(tql, "_col_absmax", recording)   # only the head is unprepared
    calls = _record_samplers(monkeypatch)
    jeng, jdone, teng, tdone = _serve_pair(z, "fused-int8", prompts, MAX_NEW, **kw)
    jax.effects_barrier()
    _token_exact(jdone, tdone, "chunked rows coupled")
    assert teng._rows_coupled and teng.counters["chunk_steps"] == jeng.counters["chunk_steps"]
    coupled, coupled_logits = list(heads), list(calls[TE])
    assert len(coupled) == teng.counters["chunk_steps"] and all(n == 24 for n, _ in coupled)
    heads.clear()
    calls[TE].clear()
    live = TE.ServeEngine(z.cfg_t, z.ttrees["int8"], quant=tql.W8A8_INT8, device="cpu",
                          config=EngineConfig(batch_size=2, max_len=T, path="fused-int8", **kw))
    live._rows_coupled = False                     # launch only the live rows
    live.submit([p.copy() for p in prompts], max_new=MAX_NEW)
    live.run()
    assert any(n < 24 for n, _ in heads)
    moved = [i for i, ((n0, c0), (n1, c1)) in enumerate(zip(coupled, heads))
             if n1 < n0 and not torch.equal(c0, c1)]
    assert moved, "the padding rows never entered the head's column max"
    i = moved[0]
    assert float(np.abs(calls[TE][i] - coupled_logits[i]).max()) > 0.0


# ======================================================================================
# Frontends: pixtral-12b (vision stub) and hubert-xlarge (audio stub, encoder-only)
# ======================================================================================

def test_pixtral_patch_prefill_and_decode():
    """Prefill with projected patch embeddings replacing the first n_patches
    positions, then 3 text-only decode steps: logits within rtol 1e-5."""
    z = _zoo("pixtral-12b")
    cfg_j, cfg_t = z.cfg_j, z.cfg_t
    rng = np.random.default_rng(7)
    S = 20
    toks = rng.integers(1, cfg_t.vocab, (2, S))
    patches = rng.standard_normal((2, cfg_t.n_patches, cfg_t.frontend_dim)).astype(np.float32)
    lens = np.array([S, 15], np.int32)
    jp, tp = z.jtrees["fp"], z.ttrees["fp"]

    @jax.jit
    def jpre(p, t, pe, c, n):
        lg, ex = JM.apply(p, {"tokens": t, "patch_embeds": pe}, cfg_j, mode="prefill",
                          caches=c, cur_len=n)
        return lg, ex["caches"]

    @jax.jit
    def jdec(p, t, c, n):
        lg, ex = JM.apply(p, {"tokens": t}, cfg_j, mode="decode", caches=c, cur_len=n)
        return lg, ex["caches"]

    jc = JM.init_cache(cfg_j, 2, T, dtype=jnp.float32)
    tc = TM.init_cache(cfg_t, 2, T, dtype=torch.float32, device="cpu")
    jl, jc = jpre(jp, jnp.asarray(toks), jnp.asarray(patches), jc, jnp.asarray(lens))
    tl, _ = TM.apply(tp, {"tokens": torch.as_tensor(toks),
                          "patch_embeds": torch.as_tensor(patches)}, cfg_t, mode="prefill",
                     caches=tc, cur_len=torch.as_tensor(lens))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5, atol=1e-5)
    text_only, _ = TM.apply(tp, {"tokens": torch.as_tensor(toks)}, cfg_t)
    assert np.abs(_np(text_only)[:, -1] - _np(tl)[:, -1]).max() > 1e-4   # patches count
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.asarray(lens + i + 1))
        tl, _ = TM.apply(tp, {"tokens": torch.as_tensor(tok.copy())}, cfg_t, mode="decode",
                         caches=tc, cur_len=torch.as_tensor(lens + i + 1))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_pixtral_text_only_serving_token_exact(jax_ref_exec):
    z = _zoo("pixtral-12b")
    _, jdone, _, tdone = _serve_pair(z, "fused-int8", _prompts(z.cfg_t.vocab, LENS, seed=2),
                                     MAX_NEW)
    _token_exact(jdone, tdone, "pixtral text-only")


@pytest.mark.parametrize("path", ["fp", "fused-int8"])
def test_hubert_prefill_step(path):
    """The encoder through make_prefill_step at S = 128 (fused-int8: the flash
    kernel's plain version, non-causal, beside the reference's flash kernel):
    last-position logits within 1e-5, caches passed through; the full train-mode
    logits too."""
    z = _zoo("hubert-xlarge")
    cfg_j, cfg_t = z.cfg_j, z.cfg_t
    assert not cfg_t.causal
    tree, quant = ("fp", "FP") if path == "fp" else ("int8", "W8A8_INT8")
    frames = np.random.default_rng(8).standard_normal(
        (2, 128, cfg_t.frontend_dim)).astype(np.float32)
    jstep = JE.make_prefill_step(cfg_j, getattr(jql, quant), path=path)
    want, _ = jax.jit(lambda p, f: jstep(p, {"frames": f}, None))(z.jtrees[tree],
                                                                 jnp.asarray(frames))
    tops.reset_launches()
    tstep = TE.make_prefill_step(cfg_t, getattr(tql, quant), path=path)
    sentinel = {}
    got, caches = tstep(z.ttrees[tree], {"frames": torch.as_tensor(frames)}, sentinel)
    assert caches is sentinel and got.shape == (2, 1, cfg_t.vocab_padded)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(want)).max()))
    ctx_kw = {} if path == "fp" else dict(use_kernels=True, int_exec="kernel")
    full, _ = TM.apply(z.ttrees[tree], {"frames": torch.as_tensor(frames)}, cfg_t,
                       ctx=QuantContext(getattr(tql, quant), **ctx_kw))
    np.testing.assert_array_equal(_np(full)[:, -1:], _np(got))


def test_hubert_engine_refuses():
    z = _zoo("hubert-xlarge")
    with pytest.raises(NotPortedError, match="make_prefill_step"):
        TE.ServeEngine(z.cfg_t, z.ttrees["int8"], quant=tql.W8A8_INT8, device="cpu",
                       config=EngineConfig(batch_size=2, max_len=T))


def test_decode_step_builder():
    """make_prefill_step / make_decode_step on a decoder (nemotron's untied head):
    prefill with per-slot lengths, then decode, against the reference's step
    builders: fp logits within rtol 1e-5; fused-int8 greedy tokens equal (an
    ulp apart, an int8 code can move a step: ROADMAP C)."""
    z = _zoo("nemotron-4-15b")
    cfg_j, cfg_t = z.cfg_j, z.cfg_t
    rng = np.random.default_rng(9)
    toks = rng.integers(1, cfg_t.vocab, (2, 12))
    lens = np.array([12, 7], np.int32)
    for path, tree, quant in (("fp", "fp", "FP"), ("fused-int8", "int8", "W8A8_INT8")):
        jpre = jax.jit(JE.make_prefill_step(cfg_j, getattr(jql, quant), path=path))
        jdec = jax.jit(JE.make_decode_step(cfg_j, getattr(jql, quant), path=path))
        tpre = TE.make_prefill_step(cfg_t, getattr(tql, quant), path=path)
        tdec = TE.make_decode_step(cfg_t, getattr(tql, quant), path=path)
        jc = JM.init_cache(cfg_j, 2, T, dtype=jnp.float32)
        tc = TM.init_cache(cfg_t, 2, T, dtype=torch.float32, device="cpu")
        jl, jc = jpre(z.jtrees[tree], {"tokens": jnp.asarray(toks), "lens": jnp.asarray(lens)},
                      jc)
        tl, tc = tpre(z.ttrees[tree], {"tokens": torch.as_tensor(toks),
                                       "lens": torch.as_tensor(lens)}, tc)
        for i in range(3):
            if path == "fp":
                np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5, atol=1e-5)
            tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
            np.testing.assert_array_equal(_np(tl[:, -1]).argmax(-1)[:, None], tok)
            jl, jc = jdec(z.jtrees[tree], jnp.asarray(tok), jc, jnp.asarray(lens + i + 1))
            tl, tc = tdec(z.ttrees[tree], torch.as_tensor(tok.copy()), tc,
                          torch.as_tensor(lens + i + 1))
