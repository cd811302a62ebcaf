"""Parity of the PyTorch port's attention pieces with the JAX reference (CPU).

The flash kernel's plain version is held against ``repro.kernels.ops``
(the Pallas kernel in interpret mode) at atol 1e-5 in f32: both compute the same
softmax, in another summation order. The int8 KV codes are bitwise equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


class TestFlashAttentionPlain:
    @pytest.mark.parametrize("H,Hkv", [(4, 2), (9, 1)])
    @pytest.mark.parametrize("S", [128, 200])
    @pytest.mark.parametrize("ragged", [False, True])
    def test_matches_pallas_interpret(self, H, Hkv, S, ragged):
        rng = np.random.default_rng(H * 1000 + S + ragged)
        B, D = 2, 16
        q = rng.standard_normal((B, H, S, D)).astype(np.float32)
        k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
        v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
        kv_len = np.array([S, S // 2 + 3], np.int32) if ragged else None
        want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    None if kv_len is None else jnp.asarray(kv_len),
                                    causal=True)
        got = tops.flash_attention(_t(q), _t(k), _t(v),
                                   None if kv_len is None else _t(kv_len), causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        assert tops.LAUNCHES["flash_attention"] == 0

    def test_kv_len_clipped_to_sk(self):
        rng = np.random.default_rng(7)
        q = _t(rng.standard_normal((2, 2, 130, 16)).astype(np.float32))
        kv = _t(rng.standard_normal((2, 1, 130, 16)).astype(np.float32))
        over = tops.flash_attention(q, kv, kv, torch.tensor([500, 130]))
        exact = tops.flash_attention(q, kv, kv, torch.tensor([130, 130]))
        torch.testing.assert_close(over, exact, rtol=0, atol=0)


class TestLayers:
    def test_kv_quantize_codes_bitwise(self):
        rng = np.random.default_rng(11)
        x = (rng.standard_normal((3, 17, 2, 16)) * 3).astype(np.float32)
        x[0, 0] = 0.0                                   # an all-zero row: EPS floor
        jq, js = JL.kv_quantize(jnp.asarray(x))
        tq, ts = TL.kv_quantize(_t(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    @pytest.mark.parametrize("kv_int8", [False, True])
    def test_decode_attention(self, kv_int8):
        rng = np.random.default_rng(12 + kv_int8)
        B, T, H, Hkv, D = 3, 24, 4, 2, 16
        q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
        k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
        v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
        cur = np.array([1, 13, 24], np.int32)
        jargs, targs = {}, {}
        if kv_int8:
            kq, ks = JL.kv_quantize(jnp.asarray(k))
            vq, vs = JL.kv_quantize(jnp.asarray(v))
            jk, jv = kq, vq
            jargs = {"k_scale": ks, "v_scale": vs}
            tk, tv = _t(kq), _t(vq)
            targs = {"k_scale": _t(ks), "v_scale": _t(vs)}
        else:
            jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), _t(k), _t(v)
        want = JL.decode_attention(jnp.asarray(q), jk, jv, cur_len=jnp.asarray(cur),
                                   window=None, softcap=None, **jargs)
        got = TL.decode_attention(_t(q), tk, tv, cur_len=_t(cur), window=None,
                                  softcap=None, **targs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)

    @pytest.mark.parametrize("S", [12, 40])
    def test_blockwise_attention(self, S):
        rng = np.random.default_rng(S)
        B, H, Hkv, D = 2, 4, 2, 16
        q = rng.standard_normal((B, S, H, D)).astype(np.float32)
        k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
        v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
        lens = np.array([S, S - 5], np.int32)
        blk = min(1024, max(S, 16))
        want = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=True, window=None, softcap=None,
                                      kv_valid_len=jnp.asarray(lens), q_block=blk,
                                      kv_block=blk)
        got = TL.blockwise_attention(_t(q), _t(k), _t(v), causal=True, window=None,
                                     softcap=None, kv_valid_len=_t(lens), q_block=blk,
                                     kv_block=blk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)

    def test_norm_and_rope(self):
        cfg_j = dataclasses.replace(jget("starcoder2-7b", smoke=True), dtype="float32")
        cfg_t = dataclasses.replace(tget("starcoder2-7b", smoke=True), dtype="float32")
        rng = np.random.default_rng(13)
        x = rng.standard_normal((2, 9, 64)).astype(np.float32) * 4 + 1
        p = {"scale": rng.uniform(0.5, 2, 64).astype(np.float32),
             "bias": rng.standard_normal(64).astype(np.float32)}
        want = JL.norm_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfg_j)
        got = TL.norm_apply({k: _t(v) for k, v in p.items()}, _t(x), cfg_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        xr = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
        pos = np.array([[3], [7]], np.int32) + np.arange(9)[None]
        want = JL.rope(jnp.asarray(xr), jnp.asarray(pos), 1e6)
        got = TL.rope(_t(xr), _t(pos), 1e6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
