"""The PyTorch port's N:M-sparse W8A8 and W4A8 against the JAX reference (CPU).

* **Bitwise** — mask and int4 packing round trips (and equal to the reference's
  bytes), ``nm_keep_mask``, ``sparsify_tree`` leaves (``qw``/``sw``/``mask``,
  prepared and fp trees, with and without calibration tables), ``prepare_int4``
  (``qw4``, group scales, ``bcol``, ``qalpha``), and the integer paths of the
  sparse and W4A8 plain versions.
* **Plain versions against the reference** — ``ops.qgemm_w8a8_sparse`` (K7's
  plain version; full-occupancy routing and tile occupancy included) and
  ``ops.qgemm_w4a8`` (K8's), each once against the Pallas kernel in interpret
  mode.
* **Serving** — ``sparsity="2:4"`` and a W4A8 g32 tree serve token-exact against
  the JAX engine with the same config, on fused-int8 (the smoke model's 64-wide
  linears take groups of 32; the card runs g128 at full width).
* **Accounting** — ``sparsity_summary`` and ``quantized_bytes(deploy_sparse=…)``
  equal the reference's; ``parse_nm`` and ``EngineConfig.sparsity`` validation.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import packing as jpacking, qlinear as jql  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import model as JM, quantize as JMQ  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.config import EngineConfig as JEngineConfig  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import packing as tpacking, qlinear as tql  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import quantize as TMQ  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402

torch.set_num_threads(2)

T = 32
W4_J = dataclasses.replace(jql.W4A8_G128, mode="int8", w_group=32)
W4_T = dataclasses.replace(tql.W4A8_G128, mode="int8", w_group=32)


def _to_t(tree):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _assert_trees_equal(a, b, path=""):
    """Bitwise equality of two trees of numpy arrays, leaf names included."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}/{i}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        assert np.array_equal(a, b), path


@pytest.fixture(scope="module")
def small():
    cfg_j = dataclasses.replace(jget("starcoder2-7b", smoke=True), dtype="float32")
    cfg_t = dataclasses.replace(tget("starcoder2-7b", smoke=True), dtype="float32")
    params = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    qparams = JMQ.quantize_tree(params, jql.W8A8_INT8)
    return cfg_j, cfg_t, params, qparams


@pytest.fixture(scope="module")
def tables(small):
    """Calibration-like column tables for every linear of the smoke tree."""
    rng = np.random.default_rng(11)
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            if "qw" in node:
                L, d_in = node["qw"].shape[0], node["qw"].shape[1]
                out[prefix] = (rng.random((L, d_in)) * 4 + 0.1).astype(np.float32)
                return
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")

    walk(small[3], "")
    return out


# ---------------------------------------------------------------- packing

class TestPacking:
    @pytest.mark.parametrize("shape,axis", [((13, 5), -2), ((3, 16, 7), -2), ((4, 9), -1)])
    def test_mask_round_trip_and_bytes(self, shape, axis):
        m = (np.random.default_rng(1).random(shape) > 0.5).astype(np.uint8)
        packed = tpacking.pack_mask(torch.from_numpy(m), axis=axis)
        assert np.array_equal(packed.numpy(), np.asarray(jpacking.pack_mask(m, axis=axis)))
        back = tpacking.unpack_mask(packed, count=shape[axis], axis=axis)
        assert np.array_equal(back.numpy(), m)

    @pytest.mark.parametrize("axis", [-1, -2])
    def test_int4_round_trip_and_bytes(self, axis):
        codes = np.random.default_rng(2).integers(-8, 8, (2, 8, 6)).astype(np.int8)
        packed = tpacking.pack_int4(torch.from_numpy(codes), axis=axis)
        assert np.array_equal(packed.numpy(),
                              np.asarray(jpacking.pack_int4(jnp.asarray(codes), axis=axis)))
        assert np.array_equal(tpacking.unpack_int4(packed, axis=axis).numpy(), codes)
        # every int4 value, both nibbles
        allv = torch.arange(-8, 8, dtype=torch.int8).repeat(2)
        assert torch.equal(tpacking.unpack_int4(tpacking.pack_int4(allv)), allv)


# ---------------------------------------------------------------- N:M sparsity

class TestSparsityPrep:
    @pytest.mark.parametrize("n,m", [(2, 4), (4, 8), (1, 4)])
    @pytest.mark.parametrize("K", [16, 18])                 # 18: a dense tail remainder
    def test_nm_keep_mask_bitwise(self, n, m, K):
        rng = np.random.default_rng(K + m)
        score = np.round(rng.random((2, K, 6)) * 4).astype(np.float32)   # many ties
        want = np.asarray(JMQ.nm_keep_mask(jnp.asarray(score), n, m))
        got = TMQ.nm_keep_mask(torch.from_numpy(score), n, m).numpy()
        assert np.array_equal(got, want)

    @pytest.mark.parametrize("nm", [(2, 4), (4, 8)])
    @pytest.mark.parametrize("with_tables", [False, True])
    def test_sparsify_prepared_tree_bitwise(self, small, tables, nm, with_tables):
        tb = tables if with_tables else None
        want = JMQ.sparsify_tree(small[3], JMQ.SparsityPlan(nm=nm), tb)
        got = TMQ.sparsify_tree(_to_t(small[3]), TMQ.SparsityPlan(nm=nm), tb)
        _assert_trees_equal(convert.params_to_numpy(_to_t(want)),
                            convert.params_to_numpy(got))
        assert TMQ.sparsity_summary(got) == JMQ.sparsity_summary(want)
        for deploy in (False, True):
            assert (TMQ.quantized_bytes(got, deploy_sparse=deploy)
                    == JMQ.quantized_bytes(want, deploy_sparse=deploy))
        # idempotent on masked trees
        again = TMQ.sparsify_tree(got, TMQ.SparsityPlan(nm=nm))
        _assert_trees_equal(convert.params_to_numpy(again), convert.params_to_numpy(got))

    def test_sparsify_fp_tree_and_plan_layers(self, small):
        plan_j = JMQ.SparsityPlan(nm=(2, 4), layers=("blocks/0/attn/wq", "blocks/0/mlp/up"))
        plan_t = TMQ.SparsityPlan(nm=(2, 4), layers=plan_j.layers)
        want = JMQ.sparsify_tree(small[2], plan_j)
        got = TMQ.sparsify_tree(_to_t(small[2]), plan_t)
        _assert_trees_equal(convert.params_to_numpy(_to_t(want)),
                            convert.params_to_numpy(got))
        assert set(TMQ.sparsity_summary(got)) == set(plan_t.layers)

    def test_convert_bridge_carries_lowbit_leaves(self, small):
        """qw4 (int8), mask (uint8, bit-packed) and the (L, G, d_out) group scales
        cross the numpy bridge both ways unchanged."""
        trees = {"w4": JMQ.quantize_tree(small[2], W4_J),
                 "2:4": JMQ.sparsify_tree(small[3], JMQ.SparsityPlan(nm=(2, 4)))}
        for tree in trees.values():
            np_tree = jax.tree_util.tree_map(np.asarray, tree)
            back = convert.params_to_numpy(convert.params_from_numpy(np_tree, device="cpu"))
            _assert_trees_equal(np_tree, back)
        wq4 = trees["w4"]["blocks"][0]["attn"]["wq"]
        wqm = trees["2:4"]["blocks"][0]["attn"]["wq"]
        assert wq4["qw4"].dtype == np.int8 and wq4["sw"].ndim == 3
        assert wqm["mask"].dtype == np.uint8

    def test_parse_nm(self):
        assert TMQ.parse_nm("2:4") == JMQ.parse_nm("2:4") == (2, 4)
        for bad in ("2-4", "4:4", "0:4", "x"):
            with pytest.raises(ValueError):
                TMQ.parse_nm(bad)
            with pytest.raises(ValueError):
                JMQ.parse_nm(bad)

    def test_engine_config_sparsity(self):
        assert EngineConfig(batch_size=2, max_len=T, sparsity="4:8").sparsity == "4:8"
        for bad in ("2-4", "3:4"):
            with pytest.raises(ValueError):
                EngineConfig(batch_size=2, max_len=T, sparsity=bad)


def _sparse_operands(rng, M, K, N, kind):
    """int8 operands with a keep-mask: ``2:4`` fills every 64x64 tile; ``block``
    also empties every other 64-row k-tile (K7's skipping path)."""
    qx = rng.integers(-127, 128, (M, K)).astype(np.int8)
    keep = np.zeros((K, N), np.uint8)
    keep[0::4] = keep[1::4] = 1
    if kind == "block":
        for k0 in range(0, K, 128):
            keep[k0:k0 + 64] = 0
    qw = (rng.integers(-127, 128, (K, N)) * keep).astype(np.int8)
    a = (rng.random((M, 1)) + 0.01).astype(np.float32)
    sw = (rng.random(N) + 0.01).astype(np.float32)
    return qx, qw, a, sw, keep


class TestSparseGemmPlainVersion:
    @pytest.mark.parametrize("kind", ["2:4", "block"])
    @pytest.mark.parametrize("M,K,N", [(4, 256, 64), (33, 200, 70), (1, 320, 130)])
    def test_bitwise_vs_reference_oracle(self, M, K, N, kind):
        qx, qw, a, sw, keep = _sparse_operands(np.random.default_rng(M + K), M, K, N, kind)
        mask = tpacking.pack_mask(torch.from_numpy(keep), axis=0)
        got = tops.qgemm_w8a8_sparse(*map(torch.from_numpy, (qx, qw, a, sw)), mask)
        want = jref.qgemm_w8a8_sparse_ref(jnp.asarray(qx), jnp.asarray(qw), jnp.asarray(a),
                                          jnp.asarray(sw), jnp.asarray(keep))
        assert np.array_equal(got.numpy(), np.asarray(want))
        # the integer path: the masked int32 accumulator equals the reference's
        acc = qx.astype(np.int64) @ (qw.astype(np.int64) * keep)
        assert np.array_equal(acc, np.asarray(jnp.asarray(qx, jnp.int32)
                                              @ jnp.asarray(qw * keep, jnp.int32)))

    def test_against_pallas_interpret(self):
        qx, qw, a, sw, keep = _sparse_operands(np.random.default_rng(7), 8, 1024, 256, "block")
        mask = tpacking.pack_mask(torch.from_numpy(keep), axis=0)
        got = tops.qgemm_w8a8_sparse(*map(torch.from_numpy, (qx, qw, a, sw)), mask)
        want = jops.qgemm_w8a8_sparse(jnp.asarray(qx), jnp.asarray(qw), jnp.asarray(a),
                                      jnp.asarray(sw), jnp.asarray(keep))
        assert np.array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("K,N", [(256, 64), (200, 70), (640, 130)])
    def test_tile_occupancy(self, K, N):
        """One int32 entry per (64, 64) weight tile, 1 iff a survivor lies in it."""
        keep = (np.random.default_rng(K).random((K, N)) > 0.97).astype(np.uint8)
        keep[:64] = 0
        occ = tops.tile_occupancy(tpacking.pack_mask(torch.from_numpy(keep), axis=0), K)
        pad = np.zeros((-(-K // 64) * 64, -(-N // 64) * 64), np.uint8)
        pad[:K, :N] = keep
        want = pad.reshape(pad.shape[0] // 64, 64, pad.shape[1] // 64, 64).max(axis=(1, 3))
        assert occ.dtype == torch.int32 and np.array_equal(occ.numpy(), want)
        assert not occ[0].any()

    def test_with_tile_occupancy(self):
        """An ``occ`` leaf, one table per layer, joins a stacked masked leaf with an
        empty tile in some layer; masks that fill every tile get none, and a
        re-derivation after the codes change drops a stale table."""
        keep = np.ones((2, 128, 64), np.uint8)
        keep[1, :64] = 0
        leaf = {"qw": torch.from_numpy(keep.astype(np.int8)),
                "sw": torch.ones(2, 64), "mask": tpacking.pack_mask(torch.from_numpy(keep))}
        tree = {"blocks": [{"mlp": {"up": leaf}}], "embed": {"w": torch.zeros(3, 4)}}
        out = TMQ.prepare_served(tree)
        occ = out["blocks"][0]["mlp"]["up"]["occ"]
        assert occ.dtype == torch.int32 and occ.tolist() == [[[1], [1]], [[0], [1]]]
        assert out["embed"]["w"] is tree["embed"]["w"] and "occ" not in leaf
        leaf["mask"].fill_(255)
        again = TMQ.prepare_served(out)
        assert "occ" not in again["blocks"][0]["mlp"]["up"]

    def test_engine_derives_occupancy_at_build(self, small):
        """The engine attaches the tables at build: a 2:4 tree fills every tile
        (no table, K2 on the card); emptying a k-tile of one leaf gives that leaf
        a table (K7 on the card) and no other."""
        _, cfg_t, _, qparams = small
        tree = TMQ.sparsify_tree(_to_t(qparams), TMQ.SparsityPlan(nm=(2, 4)))
        config = EngineConfig(batch_size=3, max_len=T, path="fused-int8")

        def leaves(t):
            return {(n, k): v for blk in t["blocks"] for n in ("attn", "mlp")
                    for k, v in blk[n].items()}

        eng = TE.ServeEngine(cfg_t, tree, quant=tql.W8A8_INT8, device="cpu", config=config)
        assert not any("occ" in v for v in leaves(eng.params).values())
        up = tree["blocks"][0]["mlp"]["up"]
        L = up["qw"].shape[0]
        up["qw"].view(L, -1, 64, up["qw"].shape[-1])[:, 0] = 0
        up["mask"].view(L, -1, 8, up["mask"].shape[-1])[:, 0] = 0
        eng = TE.ServeEngine(cfg_t, tree, quant=tql.W8A8_INT8, device="cpu", config=config)
        with_occ = {k for k, v in leaves(eng.params).items() if "occ" in v}
        assert with_occ == {("mlp", "up")}
        occ = eng.params["blocks"][0]["mlp"]["up"]["occ"]
        assert occ.shape[0] == L and not occ[:, 0].any()


# ---------------------------------------------------------------- W4A8

class TestW4A8:
    @pytest.mark.parametrize("with_cmax", [False, True])
    @pytest.mark.parametrize("group", [32, 128])
    def test_prepare_int4_bitwise(self, with_cmax, group):
        cfg_j = dataclasses.replace(W4_J, w_group=group)
        cfg_t = dataclasses.replace(W4_T, w_group=group)
        rng = np.random.default_rng(group)
        w = (rng.standard_normal((2, 256, 48)) * 0.1).astype(np.float32)
        cmax = (rng.random((2, 256)) * 3 + 0.1).astype(np.float32) if with_cmax else None
        want = [jql.prepare_int4({"w": jnp.asarray(w[i])}, cfg_j,
                                 None if cmax is None else jnp.asarray(cmax[i]))
                for i in range(2)]
        got = TMQ.quantize_tree({"blocks": [{"attn": {"wq": {"w": torch.from_numpy(w)}}}]},
                                cfg_t, None if cmax is None else
                                {"blocks/0/attn/wq": cmax})["blocks"][0]["attn"]["wq"]
        want_np = {k: np.stack([np.asarray(p[k]) for p in want]) for k in want[0]}
        np.testing.assert_array_equal(got["qalpha"].numpy(), want_np["qalpha"])
        if with_cmax:
            # b = c^(1-α): torch's and XLA's f32 pow differ by an ulp on some
            # inputs (ROADMAP queue C), and the group scales inherit it
            for k in ("sw", "bcol"):
                np.testing.assert_allclose(got[k].numpy(), want_np[k], rtol=1e-6, atol=0)
            codes = tpacking.unpack_int4(got["qw4"], axis=-2).numpy().astype(np.int32)
            wcodes = np.asarray(jpacking.unpack_int4(jnp.asarray(want_np["qw4"]), axis=-2))
            d = np.abs(codes - wcodes.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3
            return
        for k in ("qw4", "sw", "bcol"):
            np.testing.assert_array_equal(got[k].numpy(), want_np[k], err_msg=k)
        assert got["qw4"].shape == (2, 128, 48) and got["sw"].shape == (2, 256 // group, 48)
        deq = tql.dequant_int4_weight(got["qw4"][0], got["sw"][0], group)
        np.testing.assert_array_equal(
            deq.numpy(), np.asarray(jql.dequant_int4_weight(want[0]["qw4"], want[0]["sw"],
                                                            group)))

    def test_quantize_tree_w4_matches_reference(self, small):
        want = JMQ.quantize_tree(small[2], W4_J)
        got = TMQ.quantize_tree(_to_t(small[2]), W4_T)
        _assert_trees_equal(convert.params_to_numpy(_to_t(want)),
                            convert.params_to_numpy(got))

    @pytest.mark.parametrize("M,K,N,group", [(4, 256, 64, 128), (33, 384, 70, 64),
                                             (1, 128, 130, 32)])
    def test_plain_version_vs_reference_oracle(self, M, K, N, group):
        rng = np.random.default_rng(M + K + N)
        qx = rng.integers(-127, 128, (M, K)).astype(np.int8)
        qw4 = rng.integers(-128, 128, (K // 2, N)).astype(np.int8)
        a = (rng.random((M, 1)) + 0.01).astype(np.float32)
        sw = (rng.random((K // group, N)) * 0.01 + 1e-4).astype(np.float32)
        got = tops.qgemm_w4a8(*map(torch.from_numpy, (qx, qw4, a, sw)), group=group)
        want = jref.qgemm_w4a8_ref(jnp.asarray(qx), jnp.asarray(qw4), jnp.asarray(a),
                                   jnp.asarray(sw), group=group)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=0)
        # the integer path: per-group int32 partials of the unpacked codes
        qw = tpacking.unpack_int4(torch.from_numpy(qw4), axis=-2).numpy().astype(np.int64)
        part = np.einsum("mgk,gkn->mgn", qx.astype(np.int64).reshape(M, -1, group),
                         qw.reshape(-1, group, N))
        jqw = np.asarray(jpacking.unpack_int4(jnp.asarray(qw4), axis=-2)).astype(np.int64)
        assert np.array_equal(qw, jqw)
        assert np.array_equal(part, np.einsum("mgk,gkn->mgn",
                                              qx.astype(np.int64).reshape(M, -1, group),
                                              jqw.reshape(-1, group, N)))

    def test_against_pallas_interpret(self):
        rng = np.random.default_rng(5)
        M, K, N = 8, 256, 128
        qx = rng.integers(-127, 128, (M, K)).astype(np.int8)
        qw4 = rng.integers(-128, 128, (K // 2, N)).astype(np.int8)
        a = (rng.random((M, 1)) + 0.01).astype(np.float32)
        sw = (rng.random((K // 128, N)) * 0.01 + 1e-4).astype(np.float32)
        got = tops.qgemm_w4a8(*map(torch.from_numpy, (qx, qw4, a, sw)), group=128)
        want = jops.qgemm_w4a8(*map(jnp.asarray, (qx, qw4, a, sw)), group=128)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-6)

    def test_linear_ref_and_kernel_paths_agree(self):
        """The ``ref`` exec (``_int4_matmul_ref``) and the ``kernel`` exec (K8's
        plain version on the CPU) of one prepared W4 linear."""
        rng = np.random.default_rng(9)
        prep = tql.prepare_int4({"w": torch.from_numpy(
            (rng.standard_normal((256, 96)) * 0.1).astype(np.float32))}, W4_T)
        x = torch.from_numpy(rng.standard_normal((2, 5, 256)).astype(np.float32))
        y_ref = tql.apply(prep, x, W4_T)
        y_ker = tql.apply(prep, x, W4_T, int_exec="kernel")
        np.testing.assert_allclose(y_ker.numpy(), y_ref.numpy(), rtol=2e-6, atol=1e-7)
        want = jql.apply({k: jnp.asarray(v.numpy()) for k, v in prep.items()},
                         jnp.asarray(x.numpy()), W4_J)
        np.testing.assert_allclose(y_ref.numpy(), np.asarray(want), rtol=2e-6, atol=1e-7)


# ---------------------------------------------------------------- serving

LENS = [4, 7, 12, 9, 5]
MAX_NEW = [5, 3, 6, 2, 4]


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 256, size=n).astype(np.int32) for n in LENS]


def _serve(build, cfg, params, quant, cfg_cls, **kw):
    extra = {"device": "cpu"} if build is TE.ServeEngine else {}
    eng = build(cfg, params, quant=quant, **extra,
                config=cfg_cls(batch_size=3, max_len=T, path="fused-int8", **kw))
    eng.submit(_prompts(), MAX_NEW)
    return {r.rid: r.out for r in eng.run()}, eng


class TestLowBitServing:
    @pytest.mark.parametrize("layout", ["dense", "paged"])
    def test_sparse_2_4_token_exact(self, small, layout, monkeypatch):
        monkeypatch.setenv("REPRO_KERNEL_EXEC", "ref")
        cfg_j, cfg_t, _, qparams = small
        want, _ = _serve(JE.ServeEngine, cfg_j, qparams, jql.W8A8_INT8, JEngineConfig,
                         sparsity="2:4", cache_layout=layout)
        got, eng = _serve(TE.ServeEngine, cfg_t, _to_t(qparams), tql.W8A8_INT8, EngineConfig,
                          sparsity="2:4", cache_layout=layout)
        assert got == want
        assert set(TMQ.sparsity_summary(eng.params).values()) == {0.5}
        dense, _ = _serve(TE.ServeEngine, cfg_t, _to_t(qparams), tql.W8A8_INT8, EngineConfig,
                          cache_layout=layout)
        assert dense != got                # pruning changes the model

    def test_sparse_chunked_int8_kv(self, small, monkeypatch):
        """Sparsity composes with chunked serving on int8 KV."""
        monkeypatch.setenv("REPRO_KERNEL_EXEC", "ref")
        cfg_j, cfg_t, _, qparams = small
        kw = dict(sparsity="4:8", cache_layout="paged", kv_cache="int8", chunked=True,
                  token_budget=12)
        want, _ = _serve(JE.ServeEngine, cfg_j, qparams, jql.W8A8_INT8, JEngineConfig, **kw)
        got, _ = _serve(TE.ServeEngine, cfg_t, _to_t(qparams), tql.W8A8_INT8, EngineConfig,
                        **kw)
        assert got == want

    @pytest.mark.parametrize("kv", ["fp", "int8"])
    def test_w4a8_tree_token_exact(self, small, kv):
        cfg_j, cfg_t, params, _ = small
        q4 = JMQ.quantize_tree(params, W4_J)
        want, _ = _serve(JE.ServeEngine, cfg_j, q4, W4_J, JEngineConfig, kv_cache=kv)
        got, _ = _serve(TE.ServeEngine, cfg_t, _to_t(q4), W4_T, EngineConfig, kv_cache=kv)
        assert got == want
