"""The PyTorch port's mixture of experts against the JAX reference (CPU).

Smoke configs in float32: granite-moe-3b-a800m (8 experts, top-2) and
llama4-scout-17b-a16e (4 experts, top-1, one shared expert), params from
``repro.models.model.init_params`` carried across with ``convert``. Inputs are
numpy from a seed; the reference runs under ``jax.jit`` (its eager results
differ) and, in its engines, with its paged kernels through their jnp oracles
(``REPRO_KERNEL_EXEC=ref``).

* ``capacity`` for token counts 1..4096; ``_route_group`` with ``gate_w`` within
  1e-6 and ``e_idx``, ``pos`` and ``keep`` exactly equal on random rows, on tied
  rows (zero and repeated rows, where ``jax.lax.top_k`` puts the lower expert
  first) and under overflow; ``moe_apply`` and its aux loss in fp within 1e-5,
  and on prepared int8 experts (ref and dequant backends, codes bitwise) and in
  fake mode.
* The expert-batched ``ops.act_quantize_experts`` and ``ops.qgemm_w8a8_experts``
  (plain versions here) bitwise against the reference's stacked
  ``quantize_act_int8`` and ``_int8_matmul_ref``; the stacked dequant and W4
  products.
* ``quantize_tree`` of a MoE tree with column tables leaf by leaf (codes
  bitwise, scales within rel 1e-6: the column factor carries a ``pow``),
  ``make_sparsity_plan`` over each package's observer pass, ``dequantize_tree``,
  ``fake_quantize_weights`` and ``sparsify_tree`` on ``(L, E, d_in, d_out)``
  leaves; calibration tables keyed as the reference's.
* ``ServeEngine`` token-exact against the JAX engine with the same batch:
  fused-int8 dense (fp and int8 KV, and a calibrated tree), paged with prefix
  reuse, ``speculate=4``, chunked against the JAX chunked engine, fake,
  dequant-fp, W4A8 experts, and a run whose admissions overflow the capacity.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import calibration as jcal, qlinear as jql  # noqa: E402
from repro.models import model as JM, moe as JMOE  # noqa: E402
from repro.models import quantize as JMQ  # noqa: E402
from repro.models.layers import QuantContext as JQuantContext  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.config import EngineConfig as JEngineConfig  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import calibration as tcal, qlinear as tql  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import model as TM, moe as TMOE  # noqa: E402
from repro_torch.models import quantize as TMQ  # noqa: E402
from repro_torch.models.layers import QuantContext  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402

torch.set_num_threads(2)

ARCHS = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e")
T = 64                                        # cache length of every engine here
LENS, MAX_NEW = [6, 11, 9], [4, 3, 5]
W4_J = dataclasses.replace(jql.W4A8_G128, mode="int8", w_group=32)
W4_T = dataclasses.replace(tql.W4A8_G128, mode="int8", w_group=32)


@dataclasses.dataclass
class Moe:
    cfg_j: object
    cfg_t: object
    jtrees: dict          # "fp" raw, "int8" W8A8 (c = 1), "int8c" calibrated, "w4" W4A8 g32
    ttrees: dict
    tables: dict


_MOE = {}


def _tables(cfg, seed=1):
    """Column-absmax tables under the names calibration gives a MoE tree (the
    shared expert observes under its parent's ``moe/up``), seeded positive values
    with outlier columns: what ``quantize_tree`` reads, without the reference's
    eager calibration pass (test_calibration_tables holds the names to it)."""
    rng = np.random.default_rng(seed)
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff_expert
    widths = {"attn/wq": d, "attn/wk": d, "attn/wv": d,
              "attn/wo": cfg.n_heads * cfg.head_dim, "moe/up": d, "moe/gate": d,
              "moe/down": f}
    out = {}
    for name, w in widths.items():
        t = rng.random((L, w)).astype(np.float32) * 2 + 0.05
        t[:, rng.integers(0, w, 3)] *= 20
        out[f"blocks/0/{name}"] = t
    return out


def _moe(arch: str) -> Moe:
    if arch not in _MOE:
        cfg_j = dataclasses.replace(jget(arch, smoke=True), dtype="float32")
        cfg_t = dataclasses.replace(tget(arch, smoke=True), dtype="float32")
        raw = JM.init_params(jax.random.PRNGKey(0), cfg_j)
        tables = _tables(cfg_j)
        jtrees = {"fp": raw, "int8": JMQ.quantize_tree(raw, jql.W8A8_INT8),
                  "int8c": JMQ.quantize_tree(raw, jql.W8A8_INT8, tables=tables),
                  "w4": JMQ.quantize_tree(raw, W4_J)}
        ttrees = {k: convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, v),
                                               device="cpu") for k, v in jtrees.items()}
        _MOE[arch] = Moe(cfg_j, cfg_t, jtrees, ttrees, tables)
    return _MOE[arch]


@pytest.fixture
def jax_ref_exec(monkeypatch):
    """The JAX engine's paged kernels run their jnp oracles, not interpret mode."""
    monkeypatch.setenv("REPRO_KERNEL_EXEC", "ref")


def _np(t):
    return t.detach().cpu().float().numpy()


def _layer(tree, i=0):
    """Layer i of the MoE sublayer's stacked leaves."""
    return jax.tree_util.tree_map(lambda a: a[i], tree["blocks"][0]["moe"])


def _tlayer(tree, i=0):
    return TM.layer_slice(tree["blocks"][0]["moe"], i)


def _rows(cfg, n, seed, kind="random"):
    """(n, d) f32 rows: random, or with zero and repeated rows (tied routers)."""
    x = np.random.default_rng(seed).standard_normal((n, cfg.d_model)).astype(np.float32)
    if kind == "tied":
        x[1:4] = 0.0
        x[5:] = x[4]
    return x


# ======================================================================================
# Routing
# ======================================================================================

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 31, 64, 100, 257, 1000, 2048, 4096])
def test_capacity(arch, n):
    for smoke in (True, False):
        cj, ct = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
        assert TMOE.capacity(n, ct) == JMOE.capacity(n, cj)
        for cf in (0.25, 2.0):
            assert (TMOE.capacity(n, dataclasses.replace(ct, capacity_factor=cf))
                    == JMOE.capacity(n, dataclasses.replace(cj, capacity_factor=cf)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["random", "tied", "overflow"])
def test_route_group(arch, kind):
    z = _moe(arch)
    cj, ct = z.cfg_j, z.cfg_t
    if kind == "overflow":
        cj = dataclasses.replace(cj, capacity_factor=0.25)
        ct = dataclasses.replace(ct, capacity_factor=0.25)
    x = _rows(cj, 40, 3, "tied" if kind == "tied" else "random")
    w = z.jtrees["fp"]["blocks"][0]["moe"]["router"]["w"][0]
    want = jax.jit(lambda xf, rw: JMOE._route_group(xf, rw, cj))(jnp.asarray(x), w)
    got = TMOE._route_group(torch.as_tensor(x), torch.as_tensor(np.array(w)), ct)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), atol=1e-6)
    for g, j in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=1e-6)
    if kind == "overflow":
        assert not bool(got[3].all())                 # tokens dropped
    if kind == "tied":                                # zero rows tie every expert
        np.testing.assert_array_equal(got[1].reshape(40, -1)[1].numpy(),
                                      np.arange(ct.top_k))


# ======================================================================================
# The layer
# ======================================================================================

def _moe_pair(z, tree, quant_j, quant_t, x, **ctx_kw):
    jctx = JQuantContext(quant_j, **{k.replace("kernels", "pallas"): v
                                     for k, v in ctx_kw.items()})
    want = jax.jit(lambda p, xx: JMOE.moe_apply(p, xx, z.cfg_j, jctx))(
        _layer(z.jtrees[tree]), jnp.asarray(x))
    got = TMOE.moe_apply(_tlayer(z.ttrees[tree]), torch.as_tensor(x), z.cfg_t,
                         QuantContext(quant_t, **ctx_kw))
    return (np.asarray(want[0]), float(want[1])), (_np(got[0]), float(got[1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_fp(arch):
    z = _moe(arch)
    x = _rows(z.cfg_j, 21, 4, "tied").reshape(3, 7, -1)
    (yj, aj), (yt, at) = _moe_pair(z, "fp", jql.FP, tql.FP, x)
    np.testing.assert_allclose(yt, yj, atol=1e-5)
    np.testing.assert_allclose(at, aj, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ["ref", "dequant", "kernel"])
@pytest.mark.parametrize("tree", ["int8", "int8c"])
def test_moe_apply_prepared(arch, backend, tree):
    """Prepared int8 experts; the port's kernel backend (plain versions on the
    CPU) against the reference's kernel path, which quantizes experts in jnp."""
    z = _moe(arch)
    x = _rows(z.cfg_j, 24, 5).reshape(2, 12, -1)
    kw = {"use_kernels": True} if backend == "kernel" else {"int_exec": backend}
    (yj, aj), (yt, at) = _moe_pair(z, tree, jql.W8A8_INT8, tql.W8A8_INT8, x, **kw)
    # calibrated leaves carry t^0.15 in the row scale: a pow ulp can move a code
    tol = 2e-5 if tree == "int8" else 5e-3
    assert np.abs(yt - yj).max() <= tol * np.abs(yj).max()
    assert at == pytest.approx(aj, rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_fake_and_w4(arch):
    z = _moe(arch)
    x = _rows(z.cfg_j, 18, 6).reshape(2, 9, -1)
    (yj, _), (yt, _) = _moe_pair(z, "fp", jql.W8A8_CROSSQUANT, tql.W8A8_CROSSQUANT, x)
    assert np.abs(yt - yj).max() <= 2e-5 * np.abs(yj).max()
    for kw in ({}, {"int_exec": "dequant"}):
        (yj, _), (yt, _) = _moe_pair(z, "w4", W4_J, W4_T, x, **kw)
        assert np.abs(yt - yj).max() <= 2e-5 * np.abs(yj).max()


# ======================================================================================
# Expert-batched kernels' plain versions, stacked products
# ======================================================================================

def _stacked_case(seed, E=5, C=8, K=64, N=48):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((E, C, K)) * 2).astype(np.float32)
    x[1, 3:] = 0.0                                    # empty capacity rows
    bcol = (rng.random((E, K)) * 3 + 0.25).astype(np.float32)
    qw = rng.integers(-127, 128, (E, K, N)).astype(np.int8)
    sw = (rng.random((E, N)) * 0.01 + 1e-3).astype(np.float32)
    return x, bcol, qw, sw


@pytest.mark.parametrize("alpha", [1.0, 0.15])
def test_expert_ops_vs_stacked_ref(alpha):
    x, bcol, qw, sw = _stacked_case(7)
    E = x.shape[0]
    qalpha = np.full(E, alpha, np.float32)
    qalpha[0] = 1.0
    ref = jax.jit(lambda xx, b, a: jql.quantize_act_int8(xx, b, jql.W8A8_INT8, alpha=a))
    jq, ja = (np.asarray(v) for v in ref(jnp.asarray(x), jnp.asarray(bcol), jnp.asarray(qalpha)))
    tq, ta = tops.act_quantize_experts(torch.as_tensor(x), torch.as_tensor(bcol),
                                       torch.as_tensor(qalpha))
    assert tq.shape == x.shape and ta.shape == (E, x.shape[1], 1)
    if alpha == 1.0:
        np.testing.assert_array_equal(tq.numpy(), jq)
        np.testing.assert_array_equal(ta.numpy(), ja)
    else:                               # the two libraries' pow part by an ulp at most
        assert np.abs(tq.numpy().astype(int) - jq).max() <= 1
        ulps = np.abs(ta.numpy().view(np.int32).astype(np.int64) - ja.view(np.int32))
        assert ulps.max() <= 1
    mm = jax.jit(jql._int8_matmul_ref)
    want = np.asarray(mm(jnp.asarray(jq), jnp.asarray(qw), jnp.asarray(ja), jnp.asarray(sw)))
    got = tops.qgemm_w8a8_experts(torch.as_tensor(jq), torch.as_tensor(qw),
                                  torch.as_tensor(ja), torch.as_tensor(sw))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tql._int8_matmul_ref(*map(torch.as_tensor, (jq, qw, ja, sw))).numpy(), want)


def test_expert_ops_reject_bad_shapes():
    x, bcol, qw, sw = map(torch.as_tensor, _stacked_case(8))
    with pytest.raises(ValueError):
        tops.act_quantize_experts(x, bcol[:, :-1])
    with pytest.raises(ValueError):
        tops.act_quantize_experts(x, bcol, torch.ones(3))
    q, a = tops.act_quantize_experts(x, bcol, 0.15)
    with pytest.raises(ValueError):
        tops.qgemm_w8a8_experts(q, qw[:-1], a, sw)
    with pytest.raises(ValueError):
        tops.qgemm_w8a8_experts(q, qw, a[:, :, 0], sw)


def test_stacked_dequant_and_w4_products():
    x, bcol, qw, sw = _stacked_case(9)
    jq, ja = jax.jit(lambda xx, b: jql.quantize_act_int8(xx, b, jql.W8A8_INT8, alpha=1.0))(
        jnp.asarray(x), jnp.asarray(bcol))
    want = np.asarray(jax.jit(jql._int8_dequant_fp)(jq, jnp.asarray(qw), ja, jnp.asarray(sw)))
    t = [torch.as_tensor(np.asarray(v)) for v in (jq, qw, ja, sw)]
    np.testing.assert_allclose(tql._int8_dequant_fp(*t).numpy(), want, rtol=1e-5, atol=1e-6)
    rng = np.random.default_rng(10)
    qw4 = rng.integers(-128, 128, (x.shape[0], 32, 48)).astype(np.int8)
    sw4 = (rng.random((x.shape[0], 2, 48)) * 0.01).astype(np.float32)
    for name in ("_int4_matmul_ref", "_int4_dequant_fp"):
        fn = jax.jit(lambda a_, b_, c_, d_, f=getattr(jql, name): f(a_, b_, c_, d_, 32))
        want = np.asarray(fn(jq, jnp.asarray(qw4), ja, jnp.asarray(sw4)))
        got = getattr(tql, name)(t[0], torch.as_tensor(qw4), t[2], torch.as_tensor(sw4), 32)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# ======================================================================================
# Trees: structure, calibration, PTQ
# ======================================================================================

@pytest.mark.parametrize("arch", ARCHS)
def test_tree_matches_reference(arch):
    z = _moe(arch)
    assert TM.block_spec(z.cfg_t).sublayers == ("attn_moe",) == JM.block_spec(z.cfg_j).sublayers
    mine = TM.init_params(torch.Generator().manual_seed(0), z.cfg_t, device="cpu")
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(convert.params_to_numpy(mine)) == shapes(z.jtrees["fp"])
    assert ("shared" in mine["blocks"][0]["moe"]) == bool(z.cfg_t.n_shared_experts)
    for name in ("fp", "int8c", "w4"):
        back = dict(jax.tree_util.tree_leaves_with_path(convert.params_to_numpy(z.ttrees[name])))
        flat = jax.tree_util.tree_leaves_with_path(z.jtrees[name])
        assert len(back) == len(flat)
        for path, leaf in flat:
            np.testing.assert_array_equal(back[path], np.asarray(leaf))


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_tables(arch):
    """Observer names key the experts' tables at ``blocks/0/moe/{up,gate,down}``
    (d_in wide, shared by the experts, capacity rows included; llama4's shared
    expert observes under the same names), as the reference's, with the same
    values."""
    z = _moe(arch)
    toks = np.random.default_rng(1).integers(1, z.cfg_t.vocab, (2, 16))
    jobs, tobs = jcal.Observer(), tcal.Observer()
    JM.apply(z.jtrees["fp"], {"tokens": jnp.asarray(toks)}, z.cfg_j,
             ctx=JQuantContext(jql.W8A8_INT8, observer=jobs), mode="train", unroll=True)
    TM.apply(z.ttrees["fp"], {"tokens": torch.as_tensor(toks)}, z.cfg_t,
             ctx=QuantContext(tql.W8A8_INT8, observer=tobs), mode="train", unroll=True)
    jt, tt = jcal.stack_tables(jobs.tables()), tcal.stack_tables(tobs.tables())
    assert sorted(tt) == sorted(jt) == sorted(z.tables)
    L = z.cfg_t.n_layers
    assert tt["blocks/0/moe/up"].shape == (L, z.cfg_t.d_model)
    assert tt["blocks/0/moe/down"].shape == (L, z.cfg_t.d_ff_expert)
    for k in tt:
        np.testing.assert_allclose(tt[k], jt[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("quant", ["W8A8", "W4A8"])
def test_quantize_tree_leaves(arch, quant):
    z = _moe(arch)
    jq, tq = (jql.W8A8_INT8, tql.W8A8_INT8) if quant == "W8A8" else (W4_J, W4_T)
    want = jax.tree_util.tree_leaves_with_path(
        JMQ.quantize_tree(z.jtrees["fp"], jq, tables=z.tables))
    tree = TMQ.quantize_tree(z.ttrees["fp"], tq, tables=z.tables)
    L, E, d = z.cfg_t.n_layers, z.cfg_t.n_experts, z.cfg_t.d_model
    up = tree["blocks"][0]["moe"]["up"]
    assert up["qalpha"].shape == (L, E) and up["bcol"].shape == (L, E, d)
    assert float(up["qalpha"].min()) == pytest.approx(0.15)   # calibrated experts
    got = dict(jax.tree_util.tree_leaves_with_path(convert.params_to_numpy(tree)))
    assert len(got) == len(want)
    for path, leaf in want:
        leaf = np.asarray(leaf)
        assert got[path].shape == leaf.shape, path
        if leaf.dtype == np.int8:
            np.testing.assert_array_equal(got[path], leaf)
        else:
            np.testing.assert_allclose(got[path], leaf, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_dequantize_fake_weights_sparsify(arch):
    z = _moe(arch)
    pairs = [
        (JMQ.dequantize_tree(z.jtrees["int8c"], jql.W8A8_INT8),
         TMQ.dequantize_tree(z.ttrees["int8c"], tql.W8A8_INT8)),
        (JMQ.fake_quantize_weights(z.jtrees["fp"], jql.W8A8_CROSSQUANT),
         TMQ.fake_quantize_weights(z.ttrees["fp"], tql.W8A8_CROSSQUANT)),
        (JMQ.sparsify_tree(z.jtrees["int8"], JMQ.SparsityPlan(nm=(2, 4))),
         TMQ.sparsify_tree(z.ttrees["int8"], TMQ.SparsityPlan(nm=(2, 4)))),
    ]
    for want, got in pairs:
        got = dict(jax.tree_util.tree_leaves_with_path(convert.params_to_numpy(got)))
        flat = jax.tree_util.tree_leaves_with_path(want)
        assert len(got) == len(flat)
        for path, leaf in flat:
            leaf = np.asarray(leaf)
            if leaf.dtype in (np.int8, np.uint8):
                np.testing.assert_array_equal(got[path], leaf)
            else:
                np.testing.assert_allclose(got[path], leaf, rtol=1e-5, atol=1e-7)
    sparse = TMQ.with_tile_occupancy(pairs[2][1])
    assert "mask" in sparse["blocks"][0]["moe"]["up"]
    assert "occ" not in sparse["blocks"][0]["moe"]["up"]      # experts run dense K2


@pytest.mark.parametrize("arch", ARCHS)
def test_make_sparsity_plan(arch):
    """The §4.1 plan over each package's own observer pass: the experts' inputs are
    their (E, C, d) dispatch buffers, zero capacity rows included (zeros lie in the
    kernel). Fractions within two elements of the smallest input (a ulp-apart
    ``pow`` can move a fake-quant code downstream), the same leaves and layers."""
    z = _moe(arch)
    toks = np.random.default_rng(3).integers(1, z.cfg_t.vocab, (2, 16))
    jp = JMQ.make_sparsity_plan(z.cfg_j, z.jtrees["fp"], [{"tokens": jnp.asarray(toks)}],
                                threshold=1.0)
    tp = TMQ.make_sparsity_plan(z.cfg_t, z.ttrees["fp"], [{"tokens": torch.as_tensor(toks)}],
                                threshold=1.0)
    assert sorted(tp.fractions) == sorted(jp.fractions)
    assert {"blocks/0/moe/up", "blocks/0/moe/gate", "blocks/0/moe/down"} <= set(tp.fractions)
    for k, f in jp.fractions.items():
        assert abs(tp.fractions[k] - f) <= 2 / (32 * z.cfg_t.d_model), k
    assert tp.layers == jp.layers


# ======================================================================================
# Serving
# ======================================================================================

def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


QUANTS = {"fused-int8": (jql.W8A8_INT8, tql.W8A8_INT8), "dequant-fp": (jql.W8A8_INT8,
                                                                       tql.W8A8_INT8),
          "fake": (jql.W8A8_CROSSQUANT, tql.W8A8_CROSSQUANT), "w4": (W4_J, W4_T)}


def _serve_pair(z, tree, path, prompts, max_new, cfgs=None, quant=None, **kw):
    cfg_j, cfg_t = cfgs or (z.cfg_j, z.cfg_t)
    qj, qt = QUANTS[quant or path]
    jeng = JE.ServeEngine(cfg_j, z.jtrees[tree], quant=qj,
                          config=JEngineConfig(batch_size=2, max_len=T, path=path, **kw))
    jeng.submit([p.copy() for p in prompts], max_new=max_new)
    jdone = jeng.run()
    teng = TE.ServeEngine(cfg_t, z.ttrees[tree], quant=qt, device="cpu",
                          config=EngineConfig(batch_size=2, max_len=T, path=path, **kw))
    teng.submit([p.copy() for p in prompts], max_new=max_new)
    tdone = teng.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for tr, jr in zip(tdone, jdone):
        assert tr.out == jr.out, (tr.rid, tr.out, jr.out)
    return jeng, teng


SERVE_CASES = {
    "dense-fp": ("int8", "fused-int8", {"kv_cache": "fp"}),
    "dense-int8kv": ("int8", "fused-int8", {"kv_cache": "int8"}),
    "dense-calibrated": ("int8c", "fused-int8", {"kv_cache": "fp"}),
    "paged-prefix": ("int8", "fused-int8", {"kv_cache": "int8", "cache_layout": "paged",
                                            "page_size": 4}),
    "speculate": ("int8", "fused-int8", {"cache_layout": "paged", "page_size": 4,
                                         "speculate": 4}),
    "chunked": ("int8", "fused-int8", {"kv_cache": "int8", "cache_layout": "paged",
                                       "page_size": 4, "chunked": True, "token_budget": 16}),
    "fake": ("fp", "fake", {}),
    "dequant-fp": ("int8", "dequant-fp", {"kv_cache": "int8"}),
    "w4a8": ("w4", "fused-int8", {}),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_granite_serving_token_exact(jax_ref_exec, case):
    z = _moe(ARCHS[0])
    tree, path, kw = SERVE_CASES[case]
    prompts = _prompts(z.cfg_t.vocab, LENS, seed=11)
    if case in ("paged-prefix", "speculate"):    # a shared prefix, motif-tiled tails
        system = _prompts(z.cfg_t.vocab, [9], seed=12)[0]
        prompts = [np.concatenate([system, np.tile(p[:3], 3)]) for p in prompts]
    jeng, teng = _serve_pair(z, tree, path, prompts, MAX_NEW,
                             quant="w4" if case == "w4a8" else None, **kw)
    if case == "paged-prefix":
        assert teng.counters["prefix_hits"] > 0
        assert all(teng.counters[k] == v for k, v in jeng.counters.items()
                   if k in teng.counters)
    if case == "chunked":
        assert teng.counters["chunk_steps"] == jeng.counters["chunk_steps"] > 0


def test_llama4_serving_token_exact(jax_ref_exec):
    """Top-1 routing without renormalisation and the shared expert, on a
    calibrated tree (per-expert α = 0.15)."""
    z = _moe(ARCHS[1])
    _serve_pair(z, "int8c", "fused-int8", _prompts(z.cfg_t.vocab, LENS, seed=13), MAX_NEW,
                kv_cache="fp")


def test_dropped_tokens_token_exact(jax_ref_exec, monkeypatch):
    """capacity_factor 0.25: the admission prefills overflow the experts, and the
    (token, k) pairs they drop are the reference's."""
    z = _moe(ARCHS[0])
    cfgs = (dataclasses.replace(z.cfg_j, capacity_factor=0.25),
            dataclasses.replace(z.cfg_t, capacity_factor=0.25))
    dropped = []
    route = TMOE._route_group

    def recording(xf, w, cfg):
        out = route(xf, w, cfg)
        dropped.append(int((~out[3]).sum()))
        return out

    monkeypatch.setattr(TMOE, "_route_group", recording)
    _serve_pair(z, "int8", "fused-int8", _prompts(z.cfg_t.vocab, [14, 12, 10], seed=14),
                [4, 3, 5], cfgs=cfgs)
    assert max(dropped) > 0


def test_chunked_step_launches_all_rows():
    """The capacity counts the step's rows: a chunked MoE step hands the model all
    ``token_budget`` rows, as the reference does, whatever the path."""
    z = _moe(ARCHS[0])
    seen = []
    apply = TM.apply

    def counting(p, batch, *a, **kw):
        seen.append(batch["tokens"].shape[1])
        return apply(p, batch, *a, **kw)

    eng = TE.ServeEngine(z.cfg_t, z.ttrees["int8"], quant=tql.W8A8_INT8, device="cpu",
                         config=EngineConfig(batch_size=2, max_len=T, path="fused-int8",
                                             kv_cache="int8", cache_layout="paged",
                                             page_size=4, chunked=True, token_budget=16))
    assert eng._rows_coupled
    eng.submit(_prompts(z.cfg_t.vocab, [5, 3], seed=15), max_new=3)
    TM.apply = counting
    try:
        eng.run()
    finally:
        TM.apply = apply
    assert seen and set(seen) == {16}
