"""K2's, K7's and K8's body routing and K-split plans (``repro_torch.kernels.qgemm``),
K1's body plan (``repro_torch.kernels.act_quantize``) and the paged bf16 body's
key-walk split (``repro_torch.kernels.paged_attention``), on the CPU.

The decode and wgmma bodies split K across a thread-block cluster, K1's split body
a row; the plans that pick the body and the splits are plain Python, checked here
for every linear shape of every registered config, and K7's on-card compaction of
each block's occupied k-tiles through its plain-Python model. The paged body cuts each slot's
key walk into partitions sized from shapes alone. CPU tensors take the plain
versions and move no launch count; the plain K1 and K8 versions hold to the JAX
reference's own plain functions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402

from repro_torch.configs import all_archs, get  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import act_quantize as K1, ops, ref  # noqa: E402
from repro_torch.kernels.paged_attention import SPLIT_CHUNK, SPLIT_MAX, split_plan  # noqa: E402
from repro_torch.kernels.qgemm import (  # noqa: E402
    DECODE_MAX_M, MAX_SPLITS, TILE_K, WGMMA_MIN_SPLIT_K_TILES, WGMMA_TILE_K,
    WGMMA_TILE_N, decode_splits, qgemm_w4a8_plan, qgemm_w8a8_plan, qgemm_w8a8_sparse_plan,
    sparse_stage_ranges, split_bounds, w4a8_decode_splits, w4a8_split_unit, w4a8_wgmma_splits,
    wgmma_splits, wgmma_tile_m,
)


def linear_shapes(cfg):
    """(K, N) of every quantizable linear a block of ``cfg`` holds: attention
    wq/wk/wv/wo, the MLP's up/gate and down, and the experts' where it has them."""
    d = cfg.d_model
    hd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {(d, hd), (d, kvd), (hd, d), (d, cfg.d_ff), (cfg.d_ff, d)}
    if cfg.n_experts and cfg.d_ff_expert:
        shapes |= {(d, cfg.d_ff_expert), (cfg.d_ff_expert, d)}
    return sorted((k, n) for k, n in shapes if k > 0 and n > 0)


CONFIG_SHAPES = sorted({(name, smoke, k, n) for name in all_archs() for smoke in (False, True)
                        for k, n in linear_shapes(get(name, smoke=smoke))})


@pytest.mark.parametrize("name,smoke,K,N", CONFIG_SHAPES)
def test_splits_cover_k_on_tile_boundaries(name, smoke, K, N):
    """The decode body's splits cover [0, K) in order, each starting on a 64-row
    k-tile boundary, none empty, at most one cluster of them."""
    splits = decode_splits(K, N)
    assert 1 <= splits <= MAX_SPLITS
    bounds = split_bounds(K, splits)
    assert len(bounds) == splits
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    for (b0, e0), (b1, _) in zip(bounds, bounds[1:]):
        assert e0 == b1
    for b, e in bounds:
        assert b % TILE_K == 0 and e > b
        assert e % TILE_K == 0 or e == K


@pytest.mark.parametrize("name,smoke,K,N", CONFIG_SHAPES)
def test_plan_routes_small_m_to_the_decode_body(name, smoke, K, N):
    """M ≤ T runs the decode body where K and N take 16-byte chunks; larger M runs
    the wgmma body there; shapes and addresses neither takes run the tile body."""
    takes = K % 16 == 0 and N % 16 == 0
    for M in (1, 4, DECODE_MAX_M):
        body, splits = qgemm_w8a8_plan(M, K, N)
        assert (body, splits) == (("decode", decode_splits(K, N)) if takes else ("tile", 1))
        assert qgemm_w8a8_plan(M, K, N, aligned=False) == ("tile", 1)
    for M in (DECODE_MAX_M + 1, 128, 2048):
        want = ("wgmma", wgmma_splits(M, K, N)) if takes else ("tile", 1)
        assert qgemm_w8a8_plan(M, K, N) == want
        assert qgemm_w8a8_plan(M, K, N, aligned=False) == ("tile", 1)


@pytest.mark.parametrize("name,smoke,K,N", CONFIG_SHAPES)
def test_wgmma_splits_fill_the_card(name, smoke, K, N):
    """The wgmma body's K splits: at least WGMMA_MIN_SPLIT_K_TILES 128-row k-tiles
    each, at most one cluster of them, none where its output tiles alone give every
    SM a block, and enough otherwise that the split grid reaches one block per SM
    or runs out of such splits or cluster ranks. Its token tile covers M up to 128
    rows, in steps of 16, and cuts larger M into 128-row tiles."""
    k_tiles = -(-K // WGMMA_TILE_K)
    max_by_k = max(1, k_tiles // WGMMA_MIN_SPLIT_K_TILES)
    for M in (33, 40, 64, 100, 128, 512, 2047, 2048):
        bm = wgmma_tile_m(M)
        assert bm % 16 == 0 and 48 <= bm <= 128 and (bm >= M or bm == 128)
        assert bm - M < 16 or M > 128
        tiles = -(-N // WGMMA_TILE_N) * -(-M // bm)
        splits = wgmma_splits(M, K, N)
        assert 1 <= splits <= min(MAX_SPLITS, max_by_k)
        assert k_tiles // splits >= min(k_tiles, WGMMA_MIN_SPLIT_K_TILES)
        if tiles >= 132:
            assert splits == 1
        else:
            assert tiles * splits >= 132 or splits in (MAX_SPLITS, max_by_k)


@pytest.mark.parametrize("maxP,ps", [(1, 1), (1, 16), (4, 8), (7, 3), (64, 8), (128, 8),
                                     (128, 16), (513, 8), (4096, 16)])
def test_paged_split_covers_each_walk(maxP, ps):
    """The paged bf16 body's partitions cover [0, maxP·ps) in order, each a whole
    number of 32-key chunks and none empty; at every walk length a slot can have
    (kv_len, or a chunk row's last key + 1) the partitions that reach it are
    exactly the first ceil(walk / part_len), each non-empty inside the walk. The
    plan reads maxP and ps only, so a decode and a ragged launch over one table
    (whatever their rows or Nt) cut every walk alike."""
    span = maxP * ps
    n_parts, part_len = split_plan(maxP, ps)
    assert 1 <= n_parts <= SPLIT_MAX and part_len % SPLIT_CHUNK == 0
    bounds = [(p * part_len, min(span, (p + 1) * part_len)) for p in range(n_parts)]
    assert bounds[0][0] == 0 and bounds[-1][1] == span
    assert all(e > b for b, e in bounds)
    assert all(e0 == b1 for (_, e0), (b1, _) in zip(bounds, bounds[1:]))
    for walk in sorted({1, ps, ps + 1, part_len, part_len + 1, span - 1, span} - {0}):
        if walk > span:
            continue
        live = [p for p, (b, _) in enumerate(bounds) if b < walk]
        assert live == list(range(-(-walk // part_len)))
        assert all(min(e, walk) > b for b, e in (bounds[p] for p in live))
    assert split_plan(maxP, ps) == (n_parts, part_len)


def test_paged_split_main_path():
    """The serving shapes: max_len 1024 in pages of 8 or 16 gives 8 partitions of
    128 positions, so slot kv_len [700, 517, 130, 1] walks 6, 5, 2 and 1 of them; a
    short table runs one partition (no combine launch)."""
    assert split_plan(128, 8) == (8, 128) == split_plan(64, 16)
    assert [-(-n // 128) for n in (700, 517, 130, 1)] == [6, 5, 2, 1]
    assert split_plan(4, 8) == (1, 32) and split_plan(8, 16) == (1, 128)


def test_plan_edges():
    """T is 16 or 32 (picked from the two bodies' times); no rows, K or N not a
    multiple of 16, and a K shorter than one k-tile."""
    assert DECODE_MAX_M in (16, 32)
    assert qgemm_w8a8_plan(0, 4608, 4608) == ("tile", 1)
    assert qgemm_w8a8_plan(4, 4600, 4608) == ("tile", 1)
    assert qgemm_w8a8_plan(4, 4608, 4600) == ("tile", 1)
    assert qgemm_w8a8_plan(4, 48, 4608) == ("decode", 1)
    assert split_bounds(48, 1) == [(0, 48)]
    # the main path's decode shapes (starcoder2-7b at M = 4)
    assert [decode_splits(k, n) for k, n in ((4608, 4608), (4608, 512), (4608, 18432),
                                              (18432, 4608))] == [8, 8, 4, 8]
    assert split_bounds(4608, 8)[1] == (576, 1152)
    assert split_bounds(18432 + 64, 8)[-1] == (16128, 18496)   # 289 k-tiles: 252..288
    # the wgmma body: K = 4608 never splits; down (K = 18432) splits 4 ways at M <= 128
    assert [wgmma_splits(m, k, n) for m in (33, 128, 2048)
            for k, n in ((4608, 4608), (4608, 512), (4608, 18432), (18432, 4608))] == \
        [1, 1, 1, 4, 1, 1, 1, 4, 1, 1, 1, 1]
    assert qgemm_w8a8_plan(33, 4600, 4608) == ("tile", 1)
    assert qgemm_w8a8_plan(33, 4608, 4600) == ("tile", 1)


@pytest.mark.parametrize("M", [1, 4, DECODE_MAX_M, DECODE_MAX_M + 1, 128])
def test_cpu_tensors_take_the_plain_versions(M):
    """On the CPU the wrappers return the plain versions' results and count no
    launch, per op or per body."""
    rng = np.random.default_rng(M)
    K, N = 320, 96
    qx = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    a = torch.from_numpy(rng.random((M, 1)).astype(np.float32) + 0.01)
    sw = torch.from_numpy(rng.random(N).astype(np.float32) + 0.01)
    q = torch.from_numpy(rng.standard_normal((1, 2, 130, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 1, 130, 16)).astype(np.float32))
    ops.reset_launches()
    assert torch.equal(ops.qgemm_w8a8(qx, qw, a, sw), ref.qgemm_w8a8_ref(qx, qw, a, sw))
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd = q.to(dtype), kv.to(dtype)
        assert torch.equal(ops.flash_attention(qd, kd, kd, torch.tensor([M])),
                           ref.flash_attention_ref(qd, kd, kd, torch.tensor([M])))
    B, Hkv, G, D, P, ps, maxP = 2, 2, 3, 16, 6, 4, 3
    pages = torch.from_numpy(rng.standard_normal((P, ps, Hkv, D)).astype(np.float32))
    tab = torch.tensor([[0, 2, P], [1, 3, 4]], dtype=torch.int32)
    kvl = torch.tensor([6, 9], dtype=torch.int32)
    qd = torch.from_numpy(rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        out = ops.paged_decode_attention(qd.to(dtype), pages, pages, tab, kvl)
        want = ref.paged_decode_attention_ref(qd.to(dtype).reshape(B, Hkv, G, D), pages, pages,
                                              tab, kvl)
        assert torch.equal(out, want.reshape(out.shape))
    xs = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    bcol = torch.from_numpy(rng.random(K).astype(np.float32) + 0.5)
    for got, want in zip(ops.act_quantize(xs, bcol, 0.15), ref.act_quantize_ref(xs, bcol, 8, 0.15)):
        assert torch.equal(got, want)
    keep = np.ones((K, N), np.uint8)
    keep[64:128] = 0                                   # one empty k-tile: K7 on a card
    qws = torch.from_numpy(qw.numpy() * keep)
    mask = packing.pack_mask(torch.from_numpy(keep), axis=0)
    occ = ops.tile_occupancy(mask, K)
    assert not bool(occ.all())
    assert torch.equal(ops.qgemm_w8a8_sparse(qx, qws, a, sw, mask, occ),
                       ref.qgemm_w8a8_sparse_ref(qx, qws, a, sw, mask))
    qw4 = torch.from_numpy(rng.integers(-128, 128, (K // 2, N)).astype(np.int8))
    sw4 = torch.from_numpy(rng.random((K // 64, N)).astype(np.float32) * 0.01)
    assert torch.equal(ops.qgemm_w4a8(qx, qw4, a, sw4, group=64),
                       ref.qgemm_w4a8_ref(qx, qw4, a, sw4, 64))
    assert not any(ops.LAUNCHES.values()) and not any(ops.BODY_LAUNCHES.values())


# ---------------------------------------------------------------- K1 body plan

@pytest.mark.parametrize("K", [4608, 18432])
@pytest.mark.parametrize("M", [1, 4, 32, 33, 2048])
def test_act_quantize_plan_main_path(M, K):
    """The decode and verify rows (M <= 32) run the cluster-split body, S <= 8 ranks
    of whole 8-element units with M * S near one block per SM (32 blocks at M = 4,
    128 at M = 32); more rows run the rows body, the row in registers."""
    body, splits = K1.act_quantize_plan(M, K)
    if M <= K1.SPLIT_MAX_M:
        assert body == "split"
        assert splits == min(K1.MAX_SPLITS, 132 // M)
        assert M * splits <= 132 and (splits == K1.MAX_SPLITS or M * (splits + 1) > 132)
    else:
        assert (body, splits) == ("rows", 1)


@pytest.mark.parametrize("name,smoke,K,N", CONFIG_SHAPES)
def test_act_quantize_plan_every_config(name, smoke, K, N):
    """Every linear input of every config, at every row count a step gives: at most
    one cluster, no rank without MIN_SPLIT_UNITS units, a slice within the
    registers, the rows body within its K limit, the sweep body beyond it."""
    units = -(-K // K1.UNIT)
    for M in (1, 4, 17, 32, 33, 128, 4096):
        body, splits = K1.act_quantize_plan(M, K)
        assert 1 <= splits <= K1.MAX_SPLITS
        if body == "split":
            assert 2 <= splits and M <= K1.SPLIT_MAX_M
            assert units // splits >= K1.MIN_SPLIT_UNITS
            assert -(-units // splits) * K1.UNIT <= K1.SPLIT_MAX_SLICE
        else:
            assert splits == 1
            assert body == ("rows" if K <= K1.ROWS_MAX_K else "sweep")


def test_act_quantize_plan_edges():
    """Small K leaves no split worth a cluster; K past the registers sweeps."""
    assert K1.act_quantize_plan(4, 128) == ("rows", 1)
    assert K1.act_quantize_plan(4, 8 * 64) == ("split", 2)
    assert K1.act_quantize_plan(1, 8 * 64 * 8) == ("split", 8)
    assert K1.act_quantize_plan(2048, K1.ROWS_MAX_K) == ("rows", 1)
    assert K1.act_quantize_plan(2048, K1.ROWS_MAX_K + 8) == ("sweep", 1)
    assert K1.act_quantize_plan(0, 4608) == ("rows", 1)


# ---------------------------------------------------------------- K8 body plan

@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("name,smoke,K,N", CONFIG_SHAPES)
def test_w4a8_plan_routes_by_rows(name, smoke, K, N, group):
    """M <= T runs K8's decode body, larger M its wgmma body, where N takes 16-byte
    chunks and the group divides K; other shapes and unaligned operands the tile
    body."""
    takes = N % 16 == 0 and K % group == 0
    for M in (1, 4, DECODE_MAX_M):
        want = ("decode", w4a8_decode_splits(K, N, group)) if takes else ("tile", 1)
        assert qgemm_w4a8_plan(M, K, N, group) == want
        assert qgemm_w4a8_plan(M, K, N, group, aligned=False) == ("tile", 1)
    for M in (DECODE_MAX_M + 1, 128, 2048):
        want = ("wgmma", w4a8_wgmma_splits(M, K, N, group)) if takes else ("tile", 1)
        assert qgemm_w4a8_plan(M, K, N, group) == want
        assert qgemm_w4a8_plan(M, K, N, group, aligned=False) == ("tile", 1)


@pytest.mark.parametrize("name,smoke,K,N,group",
                         [c + (g,) for c in CONFIG_SHAPES for g in (64, 128) if c[2] % g == 0])
def test_w4a8_splits_on_group_boundaries(name, smoke, K, N, group):
    """Both new bodies' splits cover [0, K) in order, none empty, at most one
    cluster, each starting on a group boundary (the wgmma body's on a 128-row stage
    too) and ending on one or at K, so no group straddles two splits. (A K the
    group does not divide runs the tile body: test_w4a8_plan_routes_by_rows.)"""
    for body, splits in (("decode", w4a8_decode_splits(K, N, group)),
                         *(("wgmma", w4a8_wgmma_splits(M, K, N, group)) for M in (33, 128, 2048))):
        assert 1 <= splits <= MAX_SPLITS
        unit = w4a8_split_unit(body, group)
        bounds = split_bounds(K, splits, unit)
        assert bounds[0][0] == 0 and bounds[-1][1] == K
        assert all(e0 == b1 for (_, e0), (b1, _) in zip(bounds, bounds[1:]))
        for b, e in bounds:
            assert e > b and b % group == 0 and b % unit == 0
            assert e % group == 0


def test_w4a8_plan_edges():
    """The tile body takes what the new bodies do not: no rows, N not a multiple of
    16, a group that does not divide K or is not a multiple of 64, and at M > T a
    group neither 64 nor a multiple of 128 (the wgmma body's 128-row stages); the
    main path's splits (starcoder2-7b, g128)."""
    assert qgemm_w4a8_plan(0, 4608, 4608, 128) == ("tile", 1)
    assert qgemm_w4a8_plan(4, 4608, 4600, 128) == ("tile", 1)
    assert qgemm_w4a8_plan(4, 4608 + 64, 4608, 128) == ("tile", 1)
    assert qgemm_w4a8_plan(4, 4608, 4608, 96) == ("tile", 1)
    assert qgemm_w4a8_plan(4, 4608 + 64 * 3, 512, 192)[0] == "decode"
    assert qgemm_w4a8_plan(33, 4608 + 64 * 3, 512, 192) == ("tile", 1)
    assert qgemm_w4a8_plan(33, 4608 + 64, 512, 64)[0] == "wgmma"
    shapes = ((4608, 4608), (4608, 512), (4608, 18432), (18432, 4608))
    assert [qgemm_w4a8_plan(4, k, n, 128) for k, n in shapes] == \
        [("decode", 8), ("decode", 8), ("decode", 4), ("decode", 8)]
    assert [qgemm_w4a8_plan(m, k, n, 128)[1] for m in (33, 128, 2048) for k, n in shapes] == \
        [1, 1, 1, 4, 1, 1, 1, 4, 1, 1, 1, 1]
    # g64, K = 4672 (73 groups): the wgmma body's 128-row units, the last one half
    assert split_bounds(4608 + 64, 3, w4a8_split_unit("wgmma", 64)) == [
        (0, 1536), (1536, 3072), (3072, 4672)]
    assert split_bounds(4608, 4, w4a8_split_unit("decode", 128))[1] == (1152, 2304)


# ---------------------------------------------------------------- plain K1 and K8 vs JAX

def _outlier_rows(rng, M, K):
    x = rng.standard_normal((M, K)).astype(np.float32) * 2
    x[:, rng.choice(K, size=4, replace=False)] *= 30
    return x


@pytest.mark.parametrize("alpha", [1.0, 0.15])
@pytest.mark.parametrize("M,K", [(4, 4608), (33, 1000), (130, 256)])
def test_act_quantize_ref_matches_jax(M, K, alpha):
    """The port's plain K1 against the reference's jitted ``ref.act_quantize_ref``
    on seeded numpy inputs: the row scale within one ulp (torch's and XLA's f32
    pow differ by one on a few inputs at alpha < 1; bitwise at alpha = 1), and the
    codes bitwise on every row whose scale is bitwise."""
    rng = np.random.default_rng(M + K)
    x = _outlier_rows(rng, M, K)
    bcol = rng.uniform(0.25, 3.25, size=K).astype(np.float32)
    jq, ja = jax.jit(lambda x, b: jref.act_quantize_ref(x, b, 8, alpha))(
        jnp.asarray(x), jnp.asarray(bcol))
    tq, ta = ref.act_quantize_ref(torch.from_numpy(x), torch.from_numpy(bcol), 8,
                                  torch.tensor(alpha))
    jq, ja, tq, ta = np.asarray(jq), np.asarray(ja), tq.numpy(), ta.numpy()
    ulps = np.abs(ta.view(np.int32).astype(np.int64) - ja.view(np.int32).astype(np.int64))
    assert ulps.max() <= (0 if alpha == 1.0 else 1)
    same = ulps[:, 0] == 0
    assert same.mean() > 0.5
    np.testing.assert_array_equal(tq[same], jq[same])


@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("M,K,N", [(4, 4608, 96), (33, 1024, 130), (2, 256, 16)])
def test_qgemm_w4a8_ref_matches_jax(M, K, N, group):
    """The port's plain K8 against the reference's ``ref.qgemm_w4a8_ref`` on seeded
    numpy inputs, under the bar the kernel is held to: 2e-4 |plain| + 1e-5
    max|plain| (the group partials summed in another order)."""
    rng = np.random.default_rng(M * K + N + group)
    qx = rng.integers(-127, 128, (M, K)).astype(np.int8)
    qw4 = rng.integers(-128, 128, (K // 2, N)).astype(np.int8)
    a = (rng.random((M, 1)) + 0.01).astype(np.float32)
    sw = (rng.random((K // group, N)) * 0.01 + 1e-4).astype(np.float32)
    want = np.asarray(jref.qgemm_w4a8_ref(jnp.asarray(qx), jnp.asarray(qw4), jnp.asarray(a),
                                          jnp.asarray(sw), group))
    got = ref.qgemm_w4a8_ref(*(torch.from_numpy(t) for t in (qx, qw4, a, sw)), group).numpy()
    tol = 2e-4 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all()


# ---------------------------------------------------------------- K7 body plan and tile lists

@pytest.mark.parametrize("name,smoke,K,N", CONFIG_SHAPES)
def test_sparse_plan_routes_like_k2(name, smoke, K, N):
    """K7 takes K2's body and split count at every row count a step gives (its
    decode and wgmma bodies carry the skip), and the tile body where K2 does."""
    for M in (0, 1, 4, DECODE_MAX_M, DECODE_MAX_M + 1, 128, 2048):
        assert qgemm_w8a8_sparse_plan(M, K, N) == qgemm_w8a8_plan(M, K, N)
        assert qgemm_w8a8_sparse_plan(M, K, N, aligned=False) == ("tile", 1)


def _occ_table(kind, KT, NT, splits, seed):
    """(KT, NT) int32 occupancy tables: seeded random at a few densities, every
    tile, none, every other k-tile, the first 128-column block empty and the second
    holding one tile, and the k-tiles of one contiguous split empty."""
    rng = np.random.default_rng(seed)
    if kind.startswith("random"):
        return (rng.random((KT, NT)) < float(kind[6:])).astype(np.int32)
    t = np.ones((KT, NT), np.int32)
    if kind == "none":
        t[:] = 0
    elif kind == "alt":
        t[1::2] = 0
    elif kind == "block_empty":
        t[1::2] = 0
        t[:, :4] = 0
        if NT > 2:
            t[KT - 1, 2] = 1
    elif kind == "split_empty":
        t[KT // splits: 2 * KT // splits] = 0
    return t


@pytest.mark.parametrize("kind", ["random0.5", "random0.1", "random0.9", "ones", "none", "alt",
                                  "block_empty", "split_empty"])
@pytest.mark.parametrize("K,N,splits", [(4608, 18432, 4), (18432, 4608, 8), (4608, 512, 8),
                                        (4608 + 48, 496, 5), (1040, 144, 3), (64, 16, 1),
                                        (576, 128, 7)])
def test_sparse_stage_ranges_cover_each_block_once(K, N, splits, kind):
    """The model of K7's on-card lists: for every 128-column block, the splits'
    stages taken in order hold exactly the block's occupied k-tiles (occupied in
    either of its two table columns), each once and ascending; split s holds
    entries [s·L/S, (s+1)·L/S) of the L, so shares differ by at most one; a decode
    stage is one k-tile, a wgmma stage two, but for the last stage of an odd
    share. Empty blocks and splits get empty lists."""
    KT, NT = -(-K // TILE_K), -(-N // 64)
    occ = _occ_table(kind, KT, NT, splits, K + N + splits)
    for body, per in (("decode", 1), ("wgmma", 2)):
        ranges = sparse_stage_ranges(torch.from_numpy(occ), K, N, body, splits)
        assert len(ranges) == -(-N // 128)
        for b, shares in enumerate(ranges):
            want = np.nonzero(occ[:, 2 * b:2 * b + 2].any(axis=1))[0].tolist()
            assert len(shares) == splits
            got = [kt for share in shares for stage in share for kt in stage]
            assert got == want
            sizes = [sum(len(st) for st in share) for share in shares]
            assert sizes == [(s + 1) * len(want) // splits - s * len(want) // splits
                             for s in range(splits)]
            for share, size in zip(shares, sizes):
                assert [len(st) for st in share] == [per] * (size // per) + [1] * (size % per)
        if kind == "none":
            assert all(share == [] for shares in ranges for share in shares)
        if kind == "ones":
            assert [kt for share in ranges[0] for st in share for kt in st] == list(range(KT))


def test_sparse_stage_ranges_main_path():
    """The block-sparse serving tree's up projection (every other 64-row k-tile
    empty, K = 4608): each 128-column block streams 36 of its 72 k-tiles, 9 per
    split on the decode body's 4 splits and 18 two-tile stages on the wgmma body's
    one, half of K2's 72 and 36 stages; a block with one occupied tile leaves three
    of four decode splits empty; the table's shape is checked."""
    K, N = 4608, 18432
    occ = _occ_table("alt", K // 64, N // 64, 4, 0)
    dec = sparse_stage_ranges(occ, K, N, "decode", decode_splits(K, N))
    assert decode_splits(K, N) == 4 and all([len(sh) for sh in blk] == [9] * 4 for blk in dec)
    wg = sparse_stage_ranges(occ, K, N, "wgmma", wgmma_splits(2048, K, N))
    assert all(len(blk) == 1 and len(blk[0]) == 18 for blk in wg)
    one = np.zeros((K // 64, 2), np.int32)
    one[5, 1] = 1
    assert sparse_stage_ranges(one, K, 128, "decode", 4) == [[[], [], [], [(5,)]]]
    with pytest.raises(ValueError):
        sparse_stage_ranges(occ[:-1], K, N, "decode", 4)
