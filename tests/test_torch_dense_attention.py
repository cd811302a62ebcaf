"""The dense decode / verify attention op (``ops.dense_decode_attention``,
``ops.dense_verify_attention``), its launch plan and K3's body chooser, on the CPU.

On a card the op runs ``csrc/dense_attention.cu``, a kernel whose sums run in one
order per head; on the CPU it runs its plain version, the einsum forms of
``models.layers`` (bitwise, no launch counted), which hold to the JAX reference's
``decode_attention`` / ``verify_attention`` at 1e-5 in f32 (another summation
order). The checks the kernel needs are made on every device. The launch plan is
plain Python: for one (T, D, W) its order is the same whatever B, Hkv, the GQA
group or the rank, and its blocks cover every row once.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.core import qlinear as ql  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.dense_attention import (  # noqa: E402
    MAX_ROWS, SMEM_BYTES, THREADS, dense_plan,
)
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_body  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, B=3, W=1, H=4, Hkv=2, T=24, D=16, kv_int8=False):
    """numpy q (B, W, H, D), caches (B, T, Hkv, D) (int8 codes + scales through the
    reference's kv_quantize where asked), as (jax kwargs, torch kwargs)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, W, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    if kv_int8:
        kq, ks = JL.kv_quantize(jnp.asarray(k))
        vq, vs = JL.kv_quantize(jnp.asarray(v))
        j = dict(k_cache=kq, v_cache=vq, k_scale=ks, v_scale=vs)
    else:
        j = dict(k_cache=jnp.asarray(k), v_cache=jnp.asarray(v))
    t = {n: _t(a) for n, a in j.items()}
    return jnp.asarray(q), _t(q), j, t


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("window,softcap", [(None, None), (5, None), (None, 3.0), (7, 2.5)])
@pytest.mark.parametrize("W", [1, 4])
def test_plain_matches_jax(kv_int8, window, softcap, W):
    """The op on CPU tensors against the reference's decode_attention (W = 1) and
    verify_attention (W = 4, rows past q_len clamped) on the same numpy inputs: fp
    and int8 KV, window and softcap; f32 at atol 1e-5. A slot at cur_len 0 (decode)
    attends uniformly, as the reference's does."""
    jq, tq, jc, tc = _inputs(100 * W + 10 * (window or 0) + kv_int8, W=W, kv_int8=kv_int8)
    kw = dict(window=window, softcap=softcap)
    ops.reset_launches()
    if W == 1:
        cur = np.array([0, 13, 24], np.int32)
        want = JL.decode_attention(jq, jc["k_cache"], jc["v_cache"], cur_len=jnp.asarray(cur),
                                   k_scale=jc.get("k_scale"), v_scale=jc.get("v_scale"), **kw)
        got = ops.dense_decode_attention(tq, tc["k_cache"], tc["v_cache"], _t(cur),
                                         k_scale=tc.get("k_scale"), v_scale=tc.get("v_scale"),
                                         **kw)
    else:
        cur, qln = np.array([4, 13, 24], np.int32), np.array([4, 1, 3], np.int32)
        want = JL.verify_attention(jq, jc["k_cache"], jc["v_cache"], cur_len=jnp.asarray(cur),
                                   q_len=jnp.asarray(qln), k_scale=jc.get("k_scale"),
                                   v_scale=jc.get("v_scale"), **kw)
        got = ops.dense_verify_attention(tq, tc["k_cache"], tc["v_cache"], _t(cur), _t(qln),
                                         k_scale=tc.get("k_scale"), v_scale=tc.get("v_scale"),
                                         **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert not any(ops.LAUNCHES.values()) and not any(ops.BODY_LAUNCHES.values())


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_cpu_takes_the_einsum_forms(cache_dtype, q_dtype):
    """CPU tensors run models.layers' einsum forms, bitwise, and count no launch, for
    every cache and q dtype the kernel takes."""
    _, tq, _, tc = _inputs(7, W=3, kv_int8=cache_dtype == torch.int8)
    q = tq.to(q_dtype)
    kc, vc = tc["k_cache"], tc["v_cache"]
    if cache_dtype != torch.int8:
        kc, vc = kc.to(cache_dtype), vc.to(cache_dtype)
    sc = {n: tc[n] for n in ("k_scale", "v_scale") if n in tc}
    cl, qln = torch.tensor([3, 17, 24]), torch.tensor([3, 2, 1])
    ops.reset_launches()
    got = ops.dense_decode_attention(q[:, :1], kc, vc, cl, window=6, softcap=2.0, **sc)
    want = TL.decode_attention(q[:, :1], kc, vc, cur_len=cl, window=6, softcap=2.0, **sc)
    assert torch.equal(got, want) and got.dtype == q_dtype
    got = ops.dense_verify_attention(q, kc, vc, cl, qln, window=None, softcap=None, **sc)
    want = TL.verify_attention(q, kc, vc, cur_len=cl, q_len=qln, window=None, softcap=None,
                               **sc)
    assert torch.equal(got, want)
    assert not any(ops.LAUNCHES.values()) and not any(ops.BODY_LAUNCHES.values())


def _bad(name):
    """(q, k_cache, v_cache, kwargs) with one rule of the kernel broken."""
    _, q, _, tc = _inputs(3, kv_int8=True)
    kc, vc = tc["k_cache"], tc["v_cache"]
    sc = dict(k_scale=tc["k_scale"], v_scale=tc["v_scale"])
    fk, fv = kc.float(), vc.float()
    return {
        "q 3-D": (q[:, 0], kc, vc, sc),
        "caches differ": (q, kc, vc[:, :-1], sc),
        "slots differ": (q[:2], kc, vc, sc),
        "H not a multiple of Hkv": (q[:, :, :3], kc, vc, sc),
        "head_dim 12": (q[..., :12], kc[..., :12], vc[..., :12], sc),
        "q float16": (q.half(), kc, vc, sc),
        "cache int16": (q, kc.short(), vc.short(), sc),
        "int8 without scales": (q, kc, vc, {}),
        "one scale": (q, kc, vc, dict(k_scale=sc["k_scale"])),
        "fp cache with scales": (q, fk, fv, sc),
        "scale shape": (q, kc, vc, {n: s[:, :, :1] for n, s in sc.items()}),
        "scale float64": (q, kc, vc, {n: s.double() for n, s in sc.items()}),
        "window 0": (q, fk, fv, dict(window=0)),
        "softcap 0": (q, fk, fv, dict(softcap=0.0)),
    }[name]


BAD = ["q 3-D", "caches differ", "slots differ", "H not a multiple of Hkv", "head_dim 12",
       "q float16", "cache int16", "int8 without scales", "one scale", "fp cache with scales",
       "scale shape", "scale float64", "window 0", "softcap 0"]


@pytest.mark.parametrize("name", BAD)
def test_refuses_what_the_kernel_does_not_take(name):
    """Shapes, dtypes, head sizes, scales and window / softcap the kernel does not
    take raise ValueError on every device, decode and verify alike."""
    q, kc, vc, kw = _bad(name)
    cl = torch.full((q.shape[0],), 5)
    with pytest.raises(ValueError):
        ops.dense_decode_attention(q, kc, vc, cl, **kw)
    with pytest.raises(ValueError):
        ops.dense_verify_attention(q, kc, vc, cl, torch.ones_like(cl), **kw)


def test_decode_takes_one_token():
    _, q, _, tc = _inputs(4, W=2)
    with pytest.raises(ValueError):
        ops.dense_decode_attention(q, tc["k_cache"], tc["v_cache"], torch.tensor([5, 5, 5]))


# starcoder2-7b's decode and verify (T = 1024, 36 / 4 heads of 128) and its decode
# at the shape grid's 32k context (the scores in the global scratch), gemma2-9b's
# local decode (D = 256, T = 8192), a smoke width (D = 16)
PLAN_SHAPES = [(1, 1024, 36, 4, 128), (5, 1024, 36, 4, 128), (1, 32768, 36, 4, 128),
               (1, 8192, 16, 8, 256), (4, 64, 4, 2, 16)]


@pytest.mark.parametrize("W,T,H,Hkv,D", PLAN_SHAPES)
def test_plan_order_is_the_same_on_every_rank(W, T, H, Hkv, D):
    """One (T, D, W) laid out for one device, a tensor-parallel rank (half the heads,
    either way round), a GQA group of 1 (uneven tp_kv_rep: every query head its own
    kv row) and other slot counts: the same order (softmax stripes, p.v stripes of
    THREADS // D, groups of 4 keys); the row blocks cover each (slot, kv head)'s W·G
    rows once, at most MAX_ROWS a block, inside SMEM_BYTES, and every plan keeps
    the scores where every other does (shared memory or the scratch)."""
    G = H // Hkv
    variants = [(B, W, H, Hkv) for B in (1, 4, 8)]
    variants += [(4, W, H // 2, Hkv // 2), (4, W, H, H), (4, W, G, 1), (4, W, 1, 1)]
    plans = [dense_plan(B_, W_, H_, Hkv_, T, D) for B_, W_, H_, Hkv_ in variants]
    assert {p.order for p in plans} == {(32, 4 * THREADS // D, 4)}
    assert len({p.scratch > 0 for p in plans}) == 1
    for (B_, W_, H_, Hkv_), p in zip(variants, plans):
        R = W_ * (H_ // Hkv_)
        assert 1 <= p.rows <= MAX_ROWS and p.smem <= SMEM_BYTES
        assert p.grid == (-(-R // p.rows), Hkv_, B_)
        assert (p.grid[0] - 1) * p.rows < R <= p.grid[0] * p.rows
    # starcoder2: a row a block at decode (144 blocks), 5 at a q_win 5 verify (144)
    assert dense_plan(4, 1, 36, 4, 1024, 128)[:2] == (1, (9, 4, 4))
    assert dense_plan(4, 5, 36, 4, 1024, 128)[:2] == (5, (9, 4, 4))


@pytest.mark.parametrize("W,T,H,Hkv,D", [(1, 20000, 2, 1, 256), (1, 30000, 2, 1, 256),
                                         (1, 32768, 36, 4, 128), (4, 65536, 16, 8, 256)])
def test_plan_spills_scores_past_shared_memory(W, T, H, Hkv, D):
    """A cache whose scores leave shared memory no room for one row is planned with
    its scores in a global scratch of (rows + 1) padded rows a block, and shared
    memory for q and the p.v partials alone; the order is the one every T has."""
    B, tpad = 4, -(-T // 4) * 4
    p = dense_plan(B, W, H, Hkv, T, D)
    per_row = 4 * (D + 4 * THREADS)
    fits = per_row + 8 * tpad <= SMEM_BYTES
    assert p.order == (32, 4 * THREADS // D, 4) and 1 <= p.rows <= MAX_ROWS
    assert p.smem <= SMEM_BYTES
    if fits:
        assert p.scratch == 0 and p.smem == p.rows * per_row + 4 * (p.rows + 1) * tpad
    else:
        assert p.smem == p.rows * per_row
        assert p.scratch == p.grid[0] * Hkv * B * (p.rows + 1) * tpad
    assert fits == (T == 20000)


def test_ops_serve_a_cache_past_shared_memory():
    """The op takes a 32k cache (the shape grid's decode_32k length) on every device;
    on the CPU it is the einsum form's result."""
    _, q, _, tc = _inputs(6, B=2, H=2, Hkv=1, T=32768, D=16)
    cl = torch.tensor([32768, 9000])
    out = ops.dense_decode_attention(q, tc["k_cache"], tc["v_cache"], cl)
    assert torch.equal(out, TL.decode_attention(q, tc["k_cache"], tc["v_cache"], cur_len=cl,
                                                window=None, softcap=None))


def test_flash_body_chooser():
    """K3's wgmma body serves bf16 at D = 256 and nothing else."""
    for D in HEAD_DIMS:
        assert flash_body(torch.bfloat16, D) == ("bf16_wgmma" if D == 256 else "bf16_mma")
        assert flash_body(torch.float32, D) == "f32"


@pytest.mark.parametrize("kv_int8", [False, True])
def test_attention_apply_routes_dense_decode_and_verify_through_the_op(monkeypatch, kv_int8):
    """Every dense decode and dense verify step of attention_apply goes through the
    op (so a card runs the kernel there), with the slot lengths, window and softcap
    of the layer; its result is the op's."""
    cfg = dataclasses.replace(get("gemma2-9b", smoke=True), dtype="float32")
    ctx = TL.QuantContext(ql.QuantConfig())
    gen = torch.Generator().manual_seed(0)
    params = TL.init_attention(gen, cfg, device="cpu")
    calls = []
    for name in ("dense_decode_attention", "dense_verify_attention"):
        real = getattr(ops, name)

        def rec(*a, _real=real, _name=name, **kw):
            calls.append((_name, kw["window"], kw["softcap"], "k_scale" in kw))
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, rec)
    B, T = 2, 32
    x = torch.randn(B, 6, cfg.d_model, generator=gen)
    cache = {"k": torch.zeros(B, T, cfg.n_kv_heads, cfg.head_dim),
             "v": torch.zeros(B, T, cfg.n_kv_heads, cfg.head_dim)}
    if kv_int8:
        cache = {"k": cache["k"].to(torch.int8), "v": cache["v"].to(torch.int8),
                 "k_scale": torch.ones(B, T, cfg.n_kv_heads, 1),
                 "v_scale": torch.ones(B, T, cfg.n_kv_heads, 1)}
    lens = torch.tensor([6, 4])
    TL.attention_apply(params, x, cfg, ctx, cache=cache, cur_len=lens, local=True)
    assert calls == []                                      # prefill: not this op
    TL.attention_apply(params, x[:, :1], cfg, ctx, cache=cache, cur_len=lens + 1, local=True)
    TL.attention_apply(params, x[:, :3], cfg, ctx, cache=cache, cur_len=lens + 4,
                       q_len=torch.tensor([3, 2]))
    assert calls == [("dense_decode_attention", cfg.window, cfg.attn_softcap, kv_int8),
                     ("dense_verify_attention", None, cfg.attn_softcap, kv_int8)]
