"""Hand-written CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere. This file
imports no jax, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ops():
    from repro_torch.kernels import ops, ref
    return ops, ref


@pytest.mark.parametrize("M,K", [(1, 16), (4, 4608), (37, 1000), (130, 18432)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quantize(dev, M, K, dtype):
    ops, ref = _ops()
    g = torch.Generator(device=dev).manual_seed(M + K)
    x = (torch.randn(M, K, generator=g, device=dev) * 3).to(dtype)
    bcol = torch.rand(K, generator=g, device=dev) + 0.5
    alpha = torch.tensor(0.15, device=dev)
    q, a = ops.act_quantize(x, bcol, alpha)
    qr, ar = ref.act_quantize_ref(x, bcol, 8, alpha)
    torch.cuda.synchronize()
    assert torch.equal(a, ar)
    assert (q.int() - qr.int()).abs().max().item() <= 1
    assert (q != qr).float().mean().item() <= 1e-5


@pytest.mark.parametrize("M,K,N", [(1, 32, 8), (4, 4608, 512), (70, 300, 130),
                                   (256, 1024, 384), (5, 18432, 64)])
def test_qgemm_w8a8_bitwise(dev, M, K, N):
    ops, ref = _ops()
    g = torch.Generator(device=dev).manual_seed(M * K + N)
    qx = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
    qw = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    a = torch.rand(M, 1, generator=g, device=dev) + 0.01
    sw = torch.rand(N, generator=g, device=dev) + 0.01
    out = ops.qgemm_w8a8(qx, qw, a, sw)
    want = ref.qgemm_w8a8_ref(qx, qw, a, sw)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("H,Hkv,S,D", [(4, 2, 128, 64), (9, 1, 200, 128), (2, 2, 70, 16)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_flash_attention(dev, H, Hkv, S, D, dtype, atol):
    ops, ref = _ops()
    g = torch.Generator(device=dev).manual_seed(H * S + D)
    q = torch.randn(2, H, S, D, generator=g, device=dev).to(dtype)
    k = torch.randn(2, Hkv, S, D, generator=g, device=dev).to(dtype)
    v = torch.randn(2, Hkv, S, D, generator=g, device=dev).to(dtype)
    kv_len = torch.tensor([S, S // 2 + 1], device=dev)
    out = ops.flash_attention(q, k, v, kv_len)
    want = ref.flash_attention_ref(q, k, v, kv_len)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=atol, rtol=0)


# ---------------------------------------------------------------- K2 decode body

DECODE_SHAPES = [(4608, 4608), (4608, 512), (4608, 18432), (18432, 4608)]   # wq/wo, wk/wv, up, down


def _w8a8_inputs(dev, M, K, N, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    qx = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
    qw = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    a = torch.rand(M, 1, generator=g, device=dev) + 0.01
    sw = torch.rand(N, generator=g, device=dev) + 0.01
    return qx, qw, a, sw


def _decode_max_m():
    from repro_torch.kernels.qgemm import DECODE_MAX_M
    return DECODE_MAX_M


@pytest.mark.parametrize("K,N", DECODE_SHAPES)
@pytest.mark.parametrize("m_case", ["1", "4", "T", "T+1", "20", "128"])
def test_qgemm_w8a8_routed_bitwise(dev, K, N, m_case):
    """Across the routing rule (M = T goes to the decode body, T + 1 to the wgmma
    body) at the main path's shapes, the routed launch is bitwise the plain version."""
    ops, ref = _ops()
    T = _decode_max_m()
    M = {"T": T, "T+1": T + 1}.get(m_case) or int(m_case)
    qx, qw, a, sw = _w8a8_inputs(dev, M, K, N, M + K + N)
    before = dict(ops.BODY_LAUNCHES)
    out = ops.qgemm_w8a8(qx, qw, a, sw)
    want = ref.qgemm_w8a8_ref(qx, qw, a, sw)
    torch.cuda.synchronize()
    body = "decode" if M <= T else "wgmma"
    assert ops.BODY_LAUNCHES[f"qgemm_w8a8/{body}"] == before[f"qgemm_w8a8/{body}"] + 1
    assert torch.equal(out, want)


@pytest.mark.parametrize("M,K,N,splits", [
    (4, 4608 + 48, 496, 8),        # K not a multiple of 64 nor of the split; N not of 128
    (3, 1040, 144, 7),             # 17 k-tiles over 7 splits, the last one cut at K
    (7, 16, 16, 1),                # less than one k-tile
    (1, 64 * 9 + 32, 1008, 5),
    (20, 4608, 18432, 4), (33, 4608, 18432, 4), (64, 4608, 4608, 8),
    (128, 4608, 18432, 4),         # every M tile count the body is built for
])
def test_qgemm_w8a8_decode_body_ragged_bitwise(dev, M, K, N, splits):
    """The decode body itself at ragged K and N, every split count it takes and M
    up to 128: bitwise the plain version."""
    from repro_torch.kernels.qgemm import qgemm_w8a8_decode_cuda
    _, ref = _ops()
    qx, qw, a, sw = _w8a8_inputs(dev, M, K, N, M * 7 + K)
    out = qgemm_w8a8_decode_cuda(qx, qw, a, sw, splits)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.qgemm_w8a8_ref(qx, qw, a, sw))


def test_qgemm_w8a8_decode_body_graph_replay(dev):
    """Captured in a CUDA graph, the decode body's cluster reduction replays to
    the same bits on every replay, and to the plain version's."""
    from repro_torch.kernels.qgemm import decode_splits, qgemm_w8a8_decode_cuda
    _, ref = _ops()
    for K, N in ((4608, 512), (18432, 4608)):
        qx, qw, a, sw = _w8a8_inputs(dev, 4, K, N, K + N)
        splits = decode_splits(K, N)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            qgemm_w8a8_decode_cuda(qx, qw, a, sw, splits)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = qgemm_w8a8_decode_cuda(qx, qw, a, sw, splits)
        want = ref.qgemm_w8a8_ref(qx, qw, a, sw)
        for _ in range(3):
            out.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, want)


# ---------------------------------------------------------------- K2 wgmma body

WGMMA_M = [33, 40, 64, 100, 128, 512, 2047, 2048]


@pytest.mark.parametrize("K,N", DECODE_SHAPES + [(4608 + 48, 496)])
@pytest.mark.parametrize("M", WGMMA_M)
def test_qgemm_w8a8_wgmma_bitwise(dev, M, K, N):
    """Through ops.qgemm_w8a8's routing, packed-chunk and prefill row counts (M
    edges 33, 100, 2047 inside a token tile) at the four linear shapes and at a
    ragged K and N (neither a multiple of 128) run the wgmma body, bitwise the
    plain version."""
    from repro_torch.kernels.qgemm import qgemm_w8a8_plan
    ops, ref = _ops()
    qx, qw, a, sw = _w8a8_inputs(dev, M, K, N, 3 * M + K + N)
    assert qgemm_w8a8_plan(M, K, N)[0] == "wgmma"
    before = ops.BODY_LAUNCHES["qgemm_w8a8/wgmma"]
    out = ops.qgemm_w8a8(qx, qw, a, sw)
    want = ref.qgemm_w8a8_ref(qx, qw, a, sw)
    torch.cuda.synchronize()
    assert ops.BODY_LAUNCHES["qgemm_w8a8/wgmma"] == before + 1
    assert torch.equal(out, want)


@pytest.mark.parametrize("M,K,N,splits", [
    (33, 18432, 4608, 2), (128, 18432, 4608, 4), (64, 18432, 512, 8),
    (100, 4608 + 48, 496, 5),      # 37 k-tiles over 5 splits, the last one cut at K
    (48, 16 * 9, 16, 1),           # less than one k-tile, one output column tile
    (300, 1040, 144, 3),
])
def test_qgemm_w8a8_wgmma_splits_bitwise(dev, M, K, N, splits):
    """The wgmma body itself at every cluster split it takes, ragged K and N and
    more than one token tile: bitwise the plain version."""
    from repro_torch.kernels.qgemm import qgemm_w8a8_wgmma_cuda
    _, ref = _ops()
    qx, qw, a, sw = _w8a8_inputs(dev, M, K, N, M * 5 + K)
    out = qgemm_w8a8_wgmma_cuda(qx, qw, a, sw, splits)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.qgemm_w8a8_ref(qx, qw, a, sw))


def test_qgemm_w8a8_wgmma_graph_replay(dev):
    """Captured in a CUDA graph (tensor maps encoded at capture), the wgmma body
    replays to the plain version's bits, with and without the cluster split."""
    from repro_torch.kernels.qgemm import qgemm_w8a8_wgmma_cuda, wgmma_splits
    _, ref = _ops()
    for M, K, N in ((128, 18432, 4608), (2048, 4608, 512), (33, 4608, 18432)):
        qx, qw, a, sw = _w8a8_inputs(dev, M, K, N, M + K + N)
        splits = wgmma_splits(M, K, N)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            qgemm_w8a8_wgmma_cuda(qx, qw, a, sw, splits)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = qgemm_w8a8_wgmma_cuda(qx, qw, a, sw, splits)
        want = ref.qgemm_w8a8_ref(qx, qw, a, sw)
        for _ in range(3):
            out.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, want)


# ---------------------------------------------------------------- K3 bf16 body

@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 9])
@pytest.mark.parametrize("S", [200, 256])
@pytest.mark.parametrize("window,softcap", [(None, None), (48, None), (None, 30.0)])
def test_flash_attention_bf16_body(dev, D, G, S, window, softcap):
    """The tensor-core body at kv_len 0, 1, a length not a multiple of 64 and S;
    S a multiple of the 64-row tile or not; window and softcap; GQA groups of 1
    and 9. Rows with a valid key are within 2e-2 of the plain version; every row,
    those with no valid key too, within 2e-2 of the f32 body (the rows past
    kv_len behave as the kernel always had them); kv_len 0 gives zeros."""
    ops, ref = _ops()
    B, Hkv = 4, 2
    H = Hkv * G
    g = torch.Generator(device=dev).manual_seed(D * 1000 + G * 10 + S)
    q = torch.randn(B, H, S, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, Hkv, S, D, generator=g, device=dev).to(torch.bfloat16)
    kv_len = torch.tensor([0, 1, S - 37, S], device=dev, dtype=torch.int32)
    kw = dict(window=window, softcap=softcap)
    before = dict(ops.BODY_LAUNCHES)
    out = ops.flash_attention(q, k, v, kv_len, **kw)
    assert ops.BODY_LAUNCHES["flash_attention/bf16_mma"] == before["flash_attention/bf16_mma"] + 1
    want = ref.flash_attention_ref(q, k, v, kv_len, **kw)
    f32 = ops.flash_attention(q.float(), k.float(), v.float(), kv_len, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    # row i's first visible key: 0, or i - window + 1 under a window
    qi = torch.arange(S, device=dev)
    first = torch.zeros_like(qi) if window is None else (qi - window + 1).clamp_min(0)
    has_key = (kv_len[:, None] >= 1) & (first[None, :] <= kv_len[:, None] - 1)   # (B, S)
    rows = has_key[:, None, :, None].expand_as(out)
    err = (out.float() - want.float()).abs()
    assert float(err[rows].max()) <= 2e-2
    assert float((out.float() - f32).abs().max()) <= 2e-2
    assert float(out[0].float().abs().max()) == 0.0


SWEEP = [(2, 2, 2, 16, 8, 8, 4), (1, 1, 4, 32, 4, 16, 2), (3, 2, 1, 64, 16, 4, 8),
         (4, 4, 9, 128, 64, 8, 16)]     # the last: starcoder2-7b's G = 9, D = 128


def _paged_inputs(dev, B, Hkv, D, P, ps, maxP, pool_dtype, seed):
    """Seeded pools of ``pool_dtype`` (int8 with scale pools), an injective page
    table with sentinel tails, and kv_len inside each row's last page."""
    rng = np.random.default_rng(seed)
    if pool_dtype == torch.int8:
        kp = torch.from_numpy(rng.integers(-127, 128, (P, ps, Hkv, D)).astype(np.int8))
        vp = torch.from_numpy(rng.integers(-127, 128, (P, ps, Hkv, D)).astype(np.int8))
        ks = torch.from_numpy(0.002 + 0.05 * rng.random((P, ps, Hkv, 1))).float()
        vs = torch.from_numpy(0.002 + 0.05 * rng.random((P, ps, Hkv, 1))).float()
        scales = (ks.to(dev), vs.to(dev))
    else:
        kp = torch.from_numpy(rng.standard_normal((P, ps, Hkv, D))).to(pool_dtype)
        vp = torch.from_numpy(rng.standard_normal((P, ps, Hkv, D))).to(pool_dtype)
        scales = (None, None)
    tab = np.full((B, maxP), P, np.int32)
    kvl = np.zeros(B, np.int32)
    perm, off = rng.permutation(P), 0
    for b in range(B):
        n = int(rng.integers(1, min(maxP, P - off) + 1))
        tab[b, :n] = perm[off: off + n]
        off += n
        kvl[b] = int(rng.integers((n - 1) * ps + 1, n * ps + 1))
    return (kp.to(dev), vp.to(dev), *scales, torch.from_numpy(tab).to(dev),
            torch.from_numpy(kvl).to(dev))


@pytest.mark.parametrize("B,Hkv,G,D,P,ps,maxP", SWEEP)
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_paged_decode_attention(dev, B, Hkv, G, D, P, ps, maxP, pool_dtype):
    ops, ref = _ops()
    kp, vp, ks, vs, tab, kvl = _paged_inputs(dev, B, Hkv, D, P, ps, maxP, pool_dtype, B + D)
    q = torch.randn(B, 1, Hkv * G, D, generator=torch.Generator(device=dev).manual_seed(D),
                    device=dev)
    for window, softcap in ((None, None), (5, None), (None, 30.0)):
        out = ops.paged_decode_attention(q, kp, vp, tab, kvl, k_scale_pages=ks,
                                         v_scale_pages=vs, window=window, softcap=softcap)
        want = ref.paged_decode_attention_ref(q.reshape(B, Hkv, G, D), kp, vp, tab, kvl,
                                              k_scale_pages=ks, v_scale_pages=vs,
                                              window=window, softcap=softcap)
        torch.cuda.synchronize()
        np.testing.assert_allclose(out.reshape(B, Hkv, G, D).cpu().numpy(),
                                   want.cpu().numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,Hkv,G,D,P,ps,maxP", SWEEP)
@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.int8])
def test_paged_verify_attention(dev, B, Hkv, G, D, P, ps, maxP, W, pool_dtype):
    ops, ref = _ops()
    kp, vp, ks, vs, tab, kvl = _paged_inputs(dev, B, Hkv, D, P, ps, maxP, pool_dtype, W + D)
    qln = torch.minimum(kvl, torch.full_like(kvl, W))
    qln = torch.clamp(qln - torch.arange(B, device=dev, dtype=qln.dtype) % 2, min=1)
    q = torch.randn(B, W, Hkv * G, D, generator=torch.Generator(device=dev).manual_seed(W),
                    device=dev)
    out = ops.paged_verify_attention(q, kp, vp, tab, kvl, qln, k_scale_pages=ks,
                                     v_scale_pages=vs)
    qg = q.reshape(B, W, Hkv, G, D).permute(0, 2, 1, 3, 4)
    want = ref.paged_verify_attention_ref(qg, kp, vp, tab, kvl, qln, k_scale_pages=ks,
                                          v_scale_pages=vs).permute(0, 2, 1, 3, 4)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    for b in range(B):
        n = int(qln[b])
        np.testing.assert_allclose(out[b, :n].reshape(n, Hkv, G, D).cpu().numpy(),
                                   want[b, :n].cpu().numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.int8])
def test_paged_all_sentinel_row_and_w1(dev, pool_dtype):
    """A free slot's all-sentinel row (kv_len 1) and an empty slot (kv_len 0) give
    finite output without touching the live row's; verify at W = 1 is bitwise
    the decode launch."""
    ops, ref = _ops()
    B, Hkv, G, D, P, ps, maxP = 3, 4, 9, 128, 8, 8, 4
    kp, vp, ks, vs, _, _ = _paged_inputs(dev, B, Hkv, D, P, ps, maxP, pool_dtype, 5)
    tab = torch.tensor([[5, 2, P, P], [P] * 4, [P] * 4], dtype=torch.int32, device=dev)
    kvl = torch.tensor([11, 1, 0], dtype=torch.int32, device=dev)
    q = torch.randn(B, 1, Hkv * G, D, device=dev, dtype=torch.bfloat16)
    out = ops.paged_decode_attention(q, kp, vp, tab, kvl, k_scale_pages=ks, v_scale_pages=vs)
    ver = ops.paged_verify_attention(q, kp, vp, tab, kvl, torch.ones_like(kvl),
                                     k_scale_pages=ks, v_scale_pages=vs)
    want = ref.paged_decode_attention_ref(q.reshape(B, Hkv, G, D), kp, vp, tab, kvl,
                                          k_scale_pages=ks, v_scale_pages=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.equal(out, ver)
    assert float((out[2].float()).abs().max()) == 0.0
    np.testing.assert_allclose(out[0].reshape(Hkv, G, D).float().cpu().numpy(),
                               want[0].float().cpu().numpy(), atol=2e-2, rtol=0)


# ---------------------------------------------------------------- K4/K5 bf16 body

def _edge_paged(dev, maxP, ps, pool_dtype, seed):
    """Five slots over (P, ps, 4, 128) pools: kv_len 0, 1, one full page (a page
    boundary), the whole table (maxP·ps) and 3 on an all-sentinel table row."""
    Hkv, D = 4, 128
    span = maxP * ps
    kv_lens = [0, 1, ps, span, 3]
    P = maxP + 4
    kp, vp, ks, vs, _, _ = _paged_inputs(dev, 1, Hkv, D, P, ps, maxP, pool_dtype, seed)
    rng = np.random.default_rng(seed)
    tab = np.full((5, maxP), P, np.int32)
    perm, off = rng.permutation(P), 0
    for b in range(4):
        n = -(-kv_lens[b] // ps)
        tab[b, :n] = perm[off: off + n]
        off += n
    t = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(dev)  # noqa: E731
    return kp, vp, ks, vs, t(tab), t(kv_lens)


@pytest.mark.parametrize("maxP,ps", [(4, 8), (32, 8), (16, 16)])   # 1, 2 and 2 partitions
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("window,softcap", [(None, None), (5, None), (None, 30.0)])
def test_paged_bf16_body(dev, maxP, ps, pool_dtype, window, softcap):
    """bf16 q runs the split tensor-core body: decode (K4) and a q_win = 4 verify
    (K5) at kv_len 0, 1, a page boundary and maxP·ps, with one and with several
    key partitions, within 2e-2 of the plain version; kv_len 0 gives zeros and an
    all-sentinel table row finite values; verify at q_win = 1 is bitwise decode."""
    from repro_torch.kernels.paged_attention import split_plan
    ops, ref = _ops()
    Hkv, G, D, W = 4, 9, 128, 4
    assert split_plan(maxP, ps)[0] == (1 if maxP * ps <= 32 else 2)
    kp, vp, ks, vs, tab, kvl = _edge_paged(dev, maxP, ps, pool_dtype, maxP + ps)
    kw = dict(k_scale_pages=ks, v_scale_pages=vs, window=window, softcap=softcap)
    g = torch.Generator(device=dev).manual_seed(maxP * ps)
    q = torch.randn(5, 1, Hkv * G, D, generator=g, device=dev).to(torch.bfloat16)
    before = ops.BODY_LAUNCHES["paged_attention/bf16_mma"]
    out = ops.paged_decode_attention(q, kp, vp, tab, kvl, **kw)
    ver1 = ops.paged_verify_attention(q, kp, vp, tab, kvl, torch.ones_like(kvl), **kw)
    want = ref.paged_decode_attention_ref(q.reshape(5, Hkv, G, D), kp, vp, tab, kvl, **kw)
    qw = torch.randn(5, W, Hkv * G, D, generator=g, device=dev).to(torch.bfloat16)
    qln = torch.tensor([1, 1, 3, 4, 2], dtype=torch.int32, device=dev)
    outw = ops.paged_verify_attention(qw, kp, vp, tab, kvl, qln, **kw)
    wantw = ref.paged_verify_attention_ref(qw.reshape(5, W, Hkv, G, D).permute(0, 2, 1, 3, 4),
                                           kp, vp, tab, kvl, qln, **kw).permute(0, 2, 1, 3, 4)
    torch.cuda.synchronize()
    assert ops.BODY_LAUNCHES["paged_attention/bf16_mma"] == before + 3
    assert torch.isfinite(out.float()).all() and torch.isfinite(outw.float()).all()
    assert torch.equal(out, ver1)
    assert float(out[0].float().abs().max()) == 0.0
    err = (out.reshape(5, Hkv, G, D).float() - want.float()).abs()[1:4]
    assert float(err.max()) <= 2e-2
    for b in (1, 2, 3):
        n = int(qln[b])
        errw = (outw[b, :n].reshape(n, Hkv, G, D).float() - wantw[b, :n].float()).abs()
        assert float(errw.max()) <= 2e-2


def test_paged_bf16_body_graph_replay(dev):
    """The split body and its combine launch, captured in a CUDA graph (the
    partition scratch comes from the graph's pool), replay to the eager bits."""
    ops, _ = _ops()
    kp, vp, ks, vs, tab, kvl = _edge_paged(dev, 128, 8, torch.int8, 7)
    q = torch.randn(5, 1, 36, 128, device=dev).to(torch.bfloat16)
    call = lambda: ops.paged_decode_attention(q, kp, vp, tab, kvl, k_scale_pages=ks,  # noqa: E731
                                              v_scale_pages=vs)
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(3):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


# ---------------------------------------------------------------- K7 and K8

def _int8(g, shape, dev, lo=-127, hi=128):
    return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int8)


@pytest.mark.parametrize("M,K,N", [(1, 64, 8), (4, 4608, 512), (70, 320, 130),
                                   (256, 1024, 384), (5, 18432, 64)])
def test_qgemm_w8a8_sparse_bitwise(dev, M, K, N):
    """A block-sparse mask (every other 64-row k-tile empty, 2:4 elsewhere) runs
    K7 and is bitwise the plain version; a 2:4 mask fills every tile and runs K2,
    bitwise too; K7 with every tile forced occupied is bitwise K2."""
    from repro_torch.core import packing
    ops, ref = _ops()
    g = torch.Generator(device=dev).manual_seed(M * K + N)
    qx = _int8(g, (M, K), dev)
    keep = torch.zeros(K, N, dtype=torch.uint8, device=dev)
    keep[0::4] = 1
    keep[2::4] = 1
    block = keep.clone()
    for k0 in range(0, K, 128):
        block[k0:k0 + 64] = 0
    a = torch.rand(M, 1, generator=g, device=dev) + 0.01
    sw = torch.rand(N, generator=g, device=dev) + 0.01
    for mask_u, kernel in ((block, "qgemm_w8a8_sparse"), (keep, "qgemm_w8a8")):
        qw = _int8(g, (K, N), dev) * mask_u.to(torch.int8)
        mask = packing.pack_mask(mask_u, axis=0)
        occ = ops.tile_occupancy(mask, K)
        occ = None if bool(occ.all()) else occ   # as with_tile_occupancy routes
        before = dict(ops.LAUNCHES)
        out = ops.qgemm_w8a8_sparse(qx, qw, a, sw, mask, occ)
        want = ref.qgemm_w8a8_sparse_ref(qx, qw, a, sw, mask)
        torch.cuda.synchronize()
        assert ops.LAUNCHES[kernel] == before[kernel] + 1
        assert torch.equal(out, want)
        from repro_torch.kernels.qgemm import qgemm_w8a8_sparse_cuda
        ones = torch.ones_like(ops.tile_occupancy(mask, K))
        assert torch.equal(qgemm_w8a8_sparse_cuda(qx, qw, a, sw, ones),
                           ops.qgemm_w8a8(qx, qw, a, sw))


@pytest.mark.parametrize("M,K,N,group", [(1, 128, 8, 128), (4, 4608, 512, 128),
                                         (70, 384, 130, 64), (256, 1024, 384, 128),
                                         (5, 18432, 64, 128)])
def test_qgemm_w4a8(dev, M, K, N, group):
    """Every int4 value unpacks in the kernel; the group sums are f32-close to the
    plain version, which sums the groups in another order."""
    ops, ref = _ops()
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    qx = _int8(g, (M, K), dev)
    qw4 = _int8(g, (K // 2, N), dev, -128, 128)
    a = torch.rand(M, 1, generator=g, device=dev) + 0.01
    sw = torch.rand(K // group, N, generator=g, device=dev) * 0.01 + 1e-4
    out = ops.qgemm_w4a8(qx, qw4, a, sw, group=group)
    want = ref.qgemm_w4a8_ref(qx, qw4, a, sw, group)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), rtol=2e-4,
                               atol=1e-5 * scale)


# ---------------------------------------------------------------- K6

def _ragged_inputs(dev, B, Hkv, G, D, P, ps, maxP, q_lens, kv_lens, pool_dtype, q_dtype,
                   seed):
    kp, vp, ks, vs, _, _ = _paged_inputs(dev, B, Hkv, D, P, ps, maxP, pool_dtype, seed)
    rng = np.random.default_rng(seed + 1)
    tab = np.full((B, maxP), P, np.int32)
    perm, off = rng.permutation(P), 0
    for b in range(B):
        n = -(-kv_lens[b] // ps)
        tab[b, :n] = perm[off: off + n]
        off += n
    qln = np.asarray(q_lens, np.int32)
    qs = np.concatenate([[0], np.cumsum(qln)[:-1]]).astype(np.int32)
    Nt = max(int(qln.sum()), 1)
    q = torch.from_numpy(rng.standard_normal((Nt, Hkv * G, D))).to(q_dtype).to(dev)
    kn = torch.from_numpy(rng.standard_normal((Nt, Hkv, D))).to(q_dtype).to(dev)
    vn = torch.from_numpy(rng.standard_normal((Nt, Hkv, D))).to(q_dtype).to(dev)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa: E731
    return q, kn, vn, kp, vp, ks, vs, t(tab), t(qs), t(qln), t(kv_lens)


@pytest.mark.parametrize("case", [
    # B, Hkv, G, D, P, ps, maxP, q_lens, kv_lens
    (2, 2, 2, 16, 8, 8, 4, [5, 6], [11, 21]),           # chunks start mid-page
    (3, 2, 1, 64, 16, 4, 8, [4, 0, 3], [9, 5, 3]),      # a dead slot
    (1, 1, 4, 32, 4, 16, 2, [16], [16]),                # one slot, the whole block
    (4, 4, 9, 128, 512, 8, 128, [16, 16, 16, 16], [700, 517, 130, 16]),
    # the full-width chunked step at token_budget 128: three decode rows and a
    # 125-token chunk after a 389-token prefix; one slot's 128-token chunk
    (4, 4, 9, 128, 512, 8, 128, [1, 1, 1, 125], [700, 517, 130, 514]),
    (4, 4, 9, 128, 512, 8, 128, [128, 0, 0, 0], [517, 0, 0, 0]),
])
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_ragged_prefill_attention(dev, case, pool_dtype, q_dtype):
    ops, ref = _ops()
    B, Hkv, G, D, P, ps, maxP, q_lens, kv_lens = case
    q, kn, vn, kp, vp, ks, vs, tab, qs, qln, kvl = _ragged_inputs(
        dev, B, Hkv, G, D, P, ps, maxP, q_lens, kv_lens, pool_dtype, q_dtype, D + B)
    Nt = C = q.shape[0]                  # the engine launches chunk_cap = Nt
    for window, softcap in ((None, None), (5, None), (None, 30.0)):
        out = ops.ragged_prefill_attention(q, kn, vn, kp, vp, tab, qs, qln, kvl, chunk_cap=C,
                                           k_scale_pages=ks, v_scale_pages=vs,
                                           window=window, softcap=softcap)
        want = ref.ragged_prefill_attention_ref(
            q.reshape(Nt, Hkv, G, D), kn, vn, kp, vp, tab, qs, qln, kvl, chunk_cap=C,
            k_scale_pages=ks, v_scale_pages=vs, window=window, softcap=softcap)
        torch.cuda.synchronize()
        tol = 2e-2 if q_dtype == torch.bfloat16 else 2e-5
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.reshape(Nt, Hkv * G, D).float().cpu().numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
def test_ragged_decode_rows_bitwise_decode_kernel(dev, pool_dtype):
    """q_len == 1 rows over an fp pool, whose newest token's pool row holds the
    packed k/v value, are bitwise the decode launch (K4)."""
    ops, _ = _ops()
    B, Hkv, G, D, P, ps, maxP = 4, 4, 9, 128, 512, 8, 128
    kv_lens = [700, 517, 130, 1]
    q, _, _, kp, vp, _, _, tab, _, _, kvl = _ragged_inputs(
        dev, B, Hkv, G, D, P, ps, maxP, [1] * B, kv_lens, pool_dtype, torch.bfloat16, 3)
    rows = [(int(tab[b, (n - 1) // ps]), (n - 1) % ps) for b, n in enumerate(kv_lens)]
    kn = torch.stack([kp[p, r] for p, r in rows]).to(torch.bfloat16)
    vn = torch.stack([vp[p, r] for p, r in rows]).to(torch.bfloat16)
    for b, (p, r) in enumerate(rows):           # the pool holds the packed values
        kp[p, r], vp[p, r] = kn[b].to(pool_dtype), vn[b].to(pool_dtype)
    qs = torch.arange(B, dtype=torch.int32, device=dev)
    ones = torch.ones(B, dtype=torch.int32, device=dev)
    out = ops.ragged_prefill_attention(q, kn, vn, kp, vp, tab, qs, ones, kvl, chunk_cap=1)
    dec = ops.paged_decode_attention(q[:, None], kp, vp, tab, kvl)
    torch.cuda.synchronize()
    assert torch.equal(out, dec[:, 0])


# ---------------------------------------------------------------- K1 split and rows bodies

K1_M = [1, 4, 7, 32, 33, 2048]
K1_K = [128, 4608, 18432, 4612]           # 4612: ragged, not a multiple of the 8-element unit


def _act_inputs(dev, M, K, dtype, seed, offset=0):
    """x (M, K) with planted outlier channels; ``offset`` elements of slack in front
    move x off 16-byte alignment (the kernel's element-wise path)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.empty(M * K + offset, device=dev, dtype=dtype)
    x = base[offset:].view(M, K)
    x.copy_(torch.randn(M, K, generator=g, device=dev) * 2)
    x[:, torch.randperm(K, generator=g, device=dev)[:4]] *= 30
    bcol = torch.rand(K, generator=g, device=dev) * 3 + 0.25
    return x, bcol, torch.tensor(0.15, device=dev)


def _check_act(q, a, qr, ar):
    """Codes equal but for off-by-one on at most 1e-5 of them; a within one ulp."""
    d = (q.int() - qr.int()).abs()
    assert int(d.max()) <= 1
    assert int((d > 0).sum()) <= 1e-5 * q.numel()
    assert int((a.view(torch.int32) - ar.view(torch.int32)).abs().max()) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", K1_K)
@pytest.mark.parametrize("M", K1_M)
def test_act_quantize_bodies(dev, M, K, dtype):
    """Through ops.act_quantize's routing (the body act_quantize_plan gives, counted)
    and each of the split and rows bodies launched directly, at every M and K:
    against the plain version."""
    from repro_torch.kernels.act_quantize import act_quantize_cuda, act_quantize_plan
    ops, ref = _ops()
    x, bcol, alpha = _act_inputs(dev, M, K, dtype, M * 131 + K)
    qr, ar = ref.act_quantize_ref(x, bcol, 8, alpha)
    body, splits = act_quantize_plan(M, K)
    before = ops.BODY_LAUNCHES[f"act_quantize/{body}"]
    q, a = ops.act_quantize(x, bcol, alpha)
    torch.cuda.synchronize()
    assert ops.BODY_LAUNCHES[f"act_quantize/{body}"] == before + 1
    _check_act(q, a, qr, ar)
    units = -(-K // 8)
    for b, s in (("rows", 1), ("split", max(2, min(8, units)))):
        q, a = act_quantize_cuda(x, bcol, alpha, 0.0, 8, b, s)
        torch.cuda.synchronize()
        _check_act(q, a, qr, ar)


@pytest.mark.parametrize("body,splits", [("rows", 1), ("split", 3), ("split", 8), ("sweep", 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quantize_unaligned_and_float_alpha(dev, body, splits, dtype):
    """x off 16-byte alignment (the element-wise loads and stores) and the exponent
    passed as a float instead of a device tensor."""
    from repro_torch.kernels.act_quantize import act_quantize_cuda
    _, ref = _ops()
    x, bcol, _ = _act_inputs(dev, 5, 4608, dtype, 77, offset=1)
    assert x.data_ptr() % 16 != 0
    q, a = act_quantize_cuda(x, bcol, None, 0.15, 8, body, splits)
    qr, ar = ref.act_quantize_ref(x, bcol, 8, 0.15)
    torch.cuda.synchronize()
    _check_act(q, a, qr, ar)


def test_act_quantize_graph_replay(dev):
    """Captured in a CUDA graph, the split body's cluster launch and the rows body
    replay to the plain version's codes and scales."""
    ops, ref = _ops()
    for M, K in ((4, 18432), (4, 4608), (2048, 4608)):
        x, bcol, alpha = _act_inputs(dev, M, K, torch.bfloat16, M + K)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ops.act_quantize(x, bcol, alpha)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            q, a = ops.act_quantize(x, bcol, alpha)
        qr, ar = ref.act_quantize_ref(x, bcol, 8, alpha)
        for _ in range(3):
            q.fill_(0)
            a.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            _check_act(q, a, qr, ar)


# ---------------------------------------------------------------- K8 decode and wgmma bodies

K8_M = [1, 4, 32, 33, 128, 2047]


def _w4a8_inputs(dev, M, K, N, group, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    qx = _int8(g, (M, K), dev)
    qw4 = _int8(g, (K // 2, N), dev, -128, 128)
    a = torch.rand(M, 1, generator=g, device=dev) + 0.01
    sw = torch.rand(K // group, N, generator=g, device=dev) * 0.01 + 1e-4
    return qx, qw4, a, sw


def _check_w4a8(out, want):
    """f32-close: the plain version sums the group partials in PyTorch's order."""
    scale = float(want.abs().max())
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), rtol=2e-4,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("K,N", DECODE_SHAPES)
@pytest.mark.parametrize("M", K8_M)
def test_qgemm_w4a8_routed(dev, M, K, N, group):
    """Through ops.qgemm_w4a8's routing (decode body at M <= DECODE_MAX_M, wgmma body
    above, with the plan's split count) at the four linears: f32-close to the
    plain version, the routed body counted."""
    from repro_torch.kernels.qgemm import qgemm_w4a8_plan
    ops, ref = _ops()
    qx, qw4, a, sw = _w4a8_inputs(dev, M, K, N, group, M + K + N + group)
    body, _ = qgemm_w4a8_plan(M, K, N, group)
    assert body == ("decode" if M <= _decode_max_m() else "wgmma")
    before = ops.BODY_LAUNCHES[f"qgemm_w4a8/{body}"]
    out = ops.qgemm_w4a8(qx, qw4, a, sw, group=group)
    want = ref.qgemm_w4a8_ref(qx, qw4, a, sw, group)
    torch.cuda.synchronize()
    assert ops.BODY_LAUNCHES[f"qgemm_w4a8/{body}"] == before + 1
    _check_w4a8(out, want)


@pytest.mark.parametrize("body,M,K,N,group,splits", [
    ("decode", 4, 4608, 18432, 128, 1), ("decode", 4, 4608, 512, 64, 8),
    ("decode", 20, 18432, 4608, 128, 7), ("decode", 128, 4608, 4608, 64, 5),
    ("decode", 3, 64 * 5, 144, 64, 5),         # one group per split, ragged N tile
    ("wgmma", 33, 18432, 4608, 128, 4), ("wgmma", 128, 18432, 4608, 64, 8),
    ("wgmma", 64, 4608 + 64, 496, 64, 3),       # K ends mid-stage on a g64 group
    ("wgmma", 300, 1024, 144, 256, 2),          # a group spans two stages; two token tiles
    ("wgmma", 48, 128, 16, 128, 1),             # one stage, one column tile
])
def test_qgemm_w4a8_bodies_splits(dev, body, M, K, N, group, splits):
    """Each new body launched directly at split counts, ragged N and groups the
    plan does not pick at the main path's shapes: f32-close to the plain version."""
    from repro_torch.kernels.qgemm import qgemm_w4a8_decode_cuda, qgemm_w4a8_wgmma_cuda
    _, ref = _ops()
    qx, qw4, a, sw = _w4a8_inputs(dev, M, K, N, group, M * 3 + K + splits)
    fn = qgemm_w4a8_decode_cuda if body == "decode" else qgemm_w4a8_wgmma_cuda
    out = fn(qx, qw4, a, sw, group, splits)
    torch.cuda.synchronize()
    _check_w4a8(out, ref.qgemm_w4a8_ref(qx, qw4, a, sw, group))


def test_qgemm_w4a8_graph_replay(dev):
    """Captured in a CUDA graph, both new bodies (cluster split and not) replay to
    the same values on every replay, f32-close to the plain version."""
    ops, ref = _ops()
    for M, K, N in ((4, 18432, 4608), (4, 4608, 512), (128, 18432, 4608), (2048, 4608, 512)):
        qx, qw4, a, sw = _w4a8_inputs(dev, M, K, N, 128, M + N)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            eager = ops.qgemm_w4a8(qx, qw4, a, sw, group=128)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = ops.qgemm_w4a8(qx, qw4, a, sw, group=128)
        want = ref.qgemm_w4a8_ref(qx, qw4, a, sw, 128)
        for _ in range(3):
            out.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)
            _check_w4a8(out, want)


# ---------------------------------------------------------------- K7 decode and wgmma bodies

def _tile_pattern(name, KT, NT, splits, seed):
    """A (KT, NT) bool table of occupied (64, 64) weight tiles: every other k-tile
    empty ("alt"), a seeded half of the tiles empty ("random"), "alt" with the
    first 128-column block empty and the second holding one tile ("block_empty",
    fewer occupied stages than splits), "alt" with K2's second contiguous split of
    64-row k-tiles empty ("split_empty"), every tile ("ones") or none ("none")."""
    t = torch.ones(KT, NT, dtype=torch.bool)
    if name in ("alt", "block_empty", "split_empty"):
        t[1::2] = False
    if name == "random":
        t = torch.rand(KT, NT, generator=torch.Generator().manual_seed(seed)) < 0.5
    elif name == "block_empty":
        t[:, :4] = False
        if NT > 2:
            t[KT - 1, 2] = True
    elif name == "split_empty":
        t[KT // splits: 2 * KT // splits] = False
    elif name == "none":
        t[:] = False
    return t


def _sparse_inputs(dev, M, K, N, pattern, splits, seed):
    """qx, qw, a, sw, the packed mask and its occupancy table, with qw zero in every
    tile the pattern marks empty."""
    from repro_torch.core import packing
    ops, _ = _ops()
    KT, NT = -(-K // 64), -(-N // 64)
    qx, qw, a, sw = _w8a8_inputs(dev, M, K, N, seed)
    tiles = _tile_pattern(pattern, KT, NT, splits, seed).to(dev)
    keep = tiles.repeat_interleave(64, 0).repeat_interleave(64, 1)[:K, :N].to(torch.uint8)
    qw = qw * keep.to(torch.int8)
    mask = packing.pack_mask(keep, axis=0)
    return qx, qw, a, sw, mask, ops.tile_occupancy(mask, K)


SPARSE_BODY_CASES = [
    ("decode", 4, 4608, 18432, 4), ("decode", 4, 18432, 4608, 8),
    ("decode", 20, 4608 + 48, 496, 5),   # ragged K and N: a partial last k-tile and n-tile
    ("decode", 1, 64 * 9 + 32, 1008, 7), ("decode", 32, 1040, 144, 8),
    ("wgmma", 33, 18432, 4608, 4), ("wgmma", 128, 4608, 18432, 1),
    ("wgmma", 2048, 4608, 512, 1), ("wgmma", 100, 4608 + 48, 496, 5),
    ("wgmma", 300, 1040, 144, 3),        # two token tiles, odd shares
    ("wgmma", 64, 1040, 144, 2), ("wgmma", 80, 4608 + 48, 496, 3),
]


@pytest.mark.parametrize("pattern", ["alt", "random", "block_empty", "split_empty", "ones",
                                     "none"])
@pytest.mark.parametrize("body,M,K,N,splits", SPARSE_BODY_CASES)
def test_qgemm_w8a8_sparse_bodies_bitwise(dev, body, M, K, N, splits, pattern):
    """K7's decode and wgmma bodies, launched directly at every split count they
    take, over occupancy patterns that leave whole stages, whole blocks and whole
    split shares empty: bitwise the plain version, and bitwise K2's same body (on
    the same zeroed weights) and K7's with an all-ones table."""
    from repro_torch.kernels.qgemm import (
        qgemm_w8a8_decode_cuda, qgemm_w8a8_sparse_decode_cuda, qgemm_w8a8_sparse_wgmma_cuda,
        qgemm_w8a8_wgmma_cuda,
    )
    _, ref = _ops()
    qx, qw, a, sw, mask, occ = _sparse_inputs(dev, M, K, N, pattern, splits, M + K + N)
    k7 = qgemm_w8a8_sparse_decode_cuda if body == "decode" else qgemm_w8a8_sparse_wgmma_cuda
    k2 = qgemm_w8a8_decode_cuda if body == "decode" else qgemm_w8a8_wgmma_cuda
    out = k7(qx, qw, a, sw, occ, splits)
    full = k7(qx, qw, a, sw, torch.ones_like(occ), splits)
    dense = k2(qx, qw, a, sw, min(splits, -(-K // (64 if body == "decode" else 128))))
    want = ref.qgemm_w8a8_sparse_ref(qx, qw, a, sw, mask)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(full, want) and torch.equal(dense, want)


@pytest.mark.parametrize("K,N", DECODE_SHAPES)
@pytest.mark.parametrize("M", [1, 4, 32, 33, 128, 2047])
def test_qgemm_w8a8_sparse_routed(dev, M, K, N):
    """Through ops.qgemm_w8a8_sparse's routing (decode body up to DECODE_MAX_M, wgmma
    body above) at the four linears with every other 64-row k-tile empty: the
    routed body counted, bitwise the plain version."""
    from repro_torch.kernels.qgemm import qgemm_w8a8_sparse_plan
    ops, ref = _ops()
    body, splits = qgemm_w8a8_sparse_plan(M, K, N)
    assert body == ("decode" if M <= _decode_max_m() else "wgmma")
    qx, qw, a, sw, mask, occ = _sparse_inputs(dev, M, K, N, "alt", splits, 2 * M + K)
    before = ops.BODY_LAUNCHES[f"qgemm_w8a8_sparse/{body}"]
    out = ops.qgemm_w8a8_sparse(qx, qw, a, sw, mask, occ)
    want = ref.qgemm_w8a8_sparse_ref(qx, qw, a, sw, mask)
    torch.cuda.synchronize()
    assert ops.BODY_LAUNCHES[f"qgemm_w8a8_sparse/{body}"] == before + 1
    assert torch.equal(out, want)


@pytest.mark.parametrize("M,K,N,offset", [(4, 4608, 512, 1), (2048, 4608, 512, 1),
                                           (4, 4600, 512, 0), (40, 1040, 136, 0)])
def test_qgemm_w8a8_sparse_tile_body_routed(dev, M, K, N, offset):
    """Operands the new bodies do not take (qx off 16-byte alignment, K or N not a
    multiple of 16) route to K7's tile body, counted, bitwise the plain version."""
    from repro_torch.kernels.qgemm import qgemm_w8a8_sparse_plan
    ops, ref = _ops()
    qx, qw, a, sw, mask, occ = _sparse_inputs(dev, M, K, N, "alt", 1, M + K + N)
    qxu = torch.empty(M * K + offset, dtype=torch.int8, device=dev)[offset:].view(M, K)
    qxu.copy_(qx)
    assert qgemm_w8a8_sparse_plan(M, K, N, aligned=qxu.data_ptr() % 16 == 0)[0] == "tile"
    before = ops.BODY_LAUNCHES["qgemm_w8a8_sparse/tile"]
    out = ops.qgemm_w8a8_sparse(qxu, qw, a, sw, mask, occ)
    want = ref.qgemm_w8a8_sparse_ref(qx, qw, a, sw, mask)
    torch.cuda.synchronize()
    assert ops.BODY_LAUNCHES["qgemm_w8a8_sparse/tile"] == before + 1
    assert torch.equal(out, want)


def test_qgemm_w8a8_sparse_graph_replay(dev):
    """Captured in a CUDA graph, both new K7 bodies (cluster split and not) build
    their tile lists on the card at every replay: the same bits on every replay,
    the plain version's, and again after the table changes between replays."""
    ops, ref = _ops()
    for M, K, N in ((4, 18432, 4608), (4, 4608, 512), (128, 18432, 4608), (2048, 4608, 512)):
        qx, qw, a, sw, mask, occ = _sparse_inputs(dev, M, K, N, "alt", 4, M + N)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ops.qgemm_w8a8_sparse(qx, qw, a, sw, mask, occ)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = ops.qgemm_w8a8_sparse(qx, qw, a, sw, mask, occ)
        want = ref.qgemm_w8a8_sparse_ref(qx, qw, a, sw, mask)
        for _ in range(3):
            out.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, want)
        # every tile marked occupied: the replay streams them all, same result
        occ.fill_(1)
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


# ---------------------------------------------------------------- fake / dequant paths
# (plain torch, no hand-written kernel: the card must give the CPU's answer)

def test_kernel_analysis_past_2_24_matches_cpu(dev):
    """The §4.1 kernel count and the remove-kernel quantile on the card equal the
    CPU's on a tensor of more than 2^24 elements (a full-width prefill's down
    projection input)."""
    from repro_torch.core import kernel_analysis as KA, quantizers as Q
    g = torch.Generator().manual_seed(18)
    x = torch.randn(4, 450, 9400, generator=g) * torch.exp(torch.randn(9400, generator=g))
    assert x.numel() > 1 << 24
    xd = x.to(dev)
    scale = Q.crossquant_scale(x, 8, 0.15)
    assert int(KA.kernel_count(xd, scale.to(dev))) == int(KA.kernel_count(x, scale))
    assert float(KA.kernel_fraction(xd, scale.to(dev))) == float(KA.kernel_fraction(x, scale))
    for frac in (0.1, 0.5):
        got = KA.remove_kernel_fraction(xd, frac)
        assert torch.equal(got.cpu(), KA.remove_kernel_fraction(x, frac))


def test_fake_and_dequant_linear_match_cpu(dev):
    from repro_torch.core import qlinear as ql
    g = torch.Generator().manual_seed(19)
    x = torch.randn(4, 33, 512, generator=g) * torch.exp(torch.randn(512, generator=g))
    p = {"w": torch.randn(512, 768, generator=g) * 512 ** -0.5}
    pd = {k: v.to(dev) for k, v in p.items()}
    ops, _ = _ops()
    ops.reset_launches()
    for cfg in (ql.W8A8_PER_TOKEN, ql.W8A8_CROSSQUANT, ql.W4A8_G128):
        got = ql.apply(pd, x.to(dev), cfg).cpu()
        want = ql.apply(p, x, cfg)
        assert float((got - want).norm() / want.norm()) <= (2e-6 if cfg is ql.W8A8_PER_TOKEN
                                                            else 2e-3)
    # dequant-fp: uncalibrated (α = 1, no pow) to f32 association, calibrated
    # (t^0.15 in the row scale, where CUDA's and the CPU's pow may part by an ulp)
    for cmax, tol in ((None, 2e-6), (x.abs().amax(dim=(0, 1)), 2e-3)):
        prep = ql.prepare_int8(p, ql.W8A8_INT8, cmax=cmax)
        got = ql.apply({k: v.to(dev) for k, v in prep.items()}, x.to(dev), ql.W8A8_INT8,
                       int_exec="dequant").cpu()
        want = ql.apply(prep, x, ql.W8A8_INT8, int_exec="dequant")
        assert float((got - want).norm() / want.norm()) <= tol
    assert all(n == 0 for n in ops.LAUNCHES.values())     # no hand-written kernel ran


# ---------------------------------------------------------------- the dense zoo's shapes

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("S", [128, 200])
def test_flash_attention_d80(dev, causal, dtype, atol, S):
    """K3 at hubert-xlarge's head size 80 (its own instantiation, no padding):
    both bodies, causal and not (the encoder), kv_len S, a ragged length, 65 and
    1, 16 heads over 16 and over 4 kv heads; rows with a visible key within the
    tolerance of the plain version."""
    ops, ref = _ops()
    for H, Hkv in ((16, 16), (16, 4)):
        g = torch.Generator(device=dev).manual_seed(80 * S + H + Hkv + causal)
        q = torch.randn(4, H, S, 80, generator=g, device=dev).to(dtype)
        k = torch.randn(4, Hkv, S, 80, generator=g, device=dev).to(dtype)
        v = torch.randn(4, Hkv, S, 80, generator=g, device=dev).to(dtype)
        kv_len = torch.tensor([S, S - 37, 65, 1], device=dev, dtype=torch.int32)
        body = f"flash_attention/{'bf16_mma' if dtype == torch.bfloat16 else 'f32'}"
        before = ops.BODY_LAUNCHES[body]
        out = ops.flash_attention(q, k, v, kv_len, causal=causal)
        assert ops.BODY_LAUNCHES[body] == before + 1
        want = ref.flash_attention_ref(q, k, v, kv_len, causal=causal)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all()
        err = (out.float() - want.float()).abs()
        if causal:       # a row past kv_len has no visible key: compare the others
            err = err[:, :, :int(kv_len.min())]
        assert float(err.max()) <= atol, (H, Hkv, float(err.max()))


def _window_paged(dev, pool_dtype, kv_lens, ps=16, Hkv=8, D=256, seed=0):
    """Pools for gemma2-9b's local layers (8 kv heads, D = 256, ps 16) holding two
    slots at ``kv_lens``, an injective page table, and the table's span."""
    maxP = -(-max(kv_lens) // ps) + 2
    P = sum(-(-n // ps) for n in kv_lens) + 3
    kp, vp, ks, vs, _, _ = _paged_inputs(dev, 1, Hkv, D, P, ps, maxP, pool_dtype, seed)
    rng = np.random.default_rng(seed)
    tab = np.full((len(kv_lens), maxP), P, np.int32)
    perm, off = rng.permutation(P), 0
    for b, n in enumerate(kv_lens):
        n = -(-n // ps)
        tab[b, :n] = perm[off: off + n]
        off += n
    t = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(dev)  # noqa: E731
    return kp, vp, ks, vs, t(tab), t(kv_lens), maxP


@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_window_masks_whole_partitions(dev, pool_dtype, q_dtype):
    """K4, K5 (q_win 4) and K6 at gemma2-9b's local layers: D = 256, 16 heads over
    8, window 4096, softcap 50, kv_len 4616 and 317. The first 520 positions of the
    long slot are behind the window, so the split body's leading partitions see
    no key: they must combine with weight 0 (finite, within the tolerance of the
    plain version)."""
    from repro_torch.kernels.paged_attention import split_plan
    ops, ref = _ops()
    G, Hkv, D, W = 2, 8, 256, 4
    kp, vp, ks, vs, tab, kvl, maxP = _window_paged(dev, pool_dtype, [4616, 317])
    n_parts, part_len = split_plan(maxP, 16)
    assert n_parts > 1 and part_len < 4616 - 4096       # partition 0 lies wholly behind
    kw = dict(k_scale_pages=ks, v_scale_pages=vs, window=4096, softcap=50.0)
    tol = 2e-2 if q_dtype == torch.bfloat16 else 2e-5
    g = torch.Generator(device=dev).manual_seed(4616)
    q = torch.randn(2, 1, Hkv * G, D, generator=g, device=dev).to(q_dtype)
    out = ops.paged_decode_attention(q, kp, vp, tab, kvl, **kw)
    want = ref.paged_decode_attention_ref(q.reshape(2, Hkv, G, D), kp, vp, tab, kvl, **kw)
    qw = torch.randn(2, W, Hkv * G, D, generator=g, device=dev).to(q_dtype)
    qln = torch.tensor([4, 3], dtype=torch.int32, device=dev)
    outw = ops.paged_verify_attention(qw, kp, vp, tab, kvl, qln, **kw)
    wantw = ref.paged_verify_attention_ref(qw.reshape(2, W, Hkv, G, D).permute(0, 2, 1, 3, 4),
                                           kp, vp, tab, kvl, qln, **kw).permute(0, 2, 1, 3, 4)
    # K6: a decode row of the long slot and a 48-token chunk of the short one
    q_lens, kv_lens = [1, 48], [4616, 317]
    qs = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    qr = torch.randn(49, Hkv * G, D, generator=g, device=dev).to(q_dtype)
    kn = torch.randn(49, Hkv, D, generator=g, device=dev).to(q_dtype)
    vn = torch.randn(49, Hkv, D, generator=g, device=dev).to(q_dtype)
    qlr = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    kvr = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    outr = ops.ragged_prefill_attention(qr, kn, vn, kp, vp, tab, qs, qlr, kvr, chunk_cap=49,
                                        **kw)
    wantr = ref.ragged_prefill_attention_ref(qr.reshape(49, Hkv, G, D), kn, vn, kp, vp, tab,
                                             qs, qlr, kvr, chunk_cap=49, **kw)
    torch.cuda.synchronize()
    for o in (out, outw, outr):
        assert torch.isfinite(o.float()).all()
    assert float((out.reshape(2, Hkv, G, D).float() - want.float()).abs().max()) <= tol
    for b, n in enumerate(qln.tolist()):
        errw = (outw[b, :n].reshape(n, Hkv, G, D).float() - wantw[b, :n].float()).abs()
        assert float(errw.max()) <= tol
    assert float((outr.reshape(49, Hkv, G, D).float() - wantr.float()).abs().max()) <= tol


@pytest.mark.parametrize("M", [4, 128])
def test_qgemm_w8a8_vocab_head(dev, M):
    """K2 at nemotron-4-15b's untied head, K = 6144 and N = 256000 (2000 column
    tiles), routed (decode body at M = 4, wgmma at 128): bitwise against the plain
    version, taken in column slices to bound its float64 product."""
    from repro_torch.kernels.qgemm import qgemm_w8a8_plan
    ops, ref = _ops()
    K, N = 6144, 256000
    g = torch.Generator(device=dev).manual_seed(M)
    qx = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
    qw = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    a = torch.rand(M, 1, generator=g, device=dev) * 0.1 + 1e-3
    sw = torch.rand(N, generator=g, device=dev) * 0.1 + 1e-3
    body = qgemm_w8a8_plan(M, K, N)[0]
    before = ops.BODY_LAUNCHES[f"qgemm_w8a8/{body}"]
    out = ops.qgemm_w8a8(qx, qw, a, sw)
    assert ops.BODY_LAUNCHES[f"qgemm_w8a8/{body}"] == before + 1
    for n0 in range(0, N, 32000):
        want = ref.qgemm_w8a8_ref(qx, qw[:, n0:n0 + 32000], a, sw[n0:n0 + 32000])
        assert torch.equal(out[:, n0:n0 + 32000], want), n0


# ---- expert-batched K1 and K2 (a stacked-expert linear, one launch for all experts)

@pytest.mark.parametrize("E,C,K", [(40, 8, 1536), (16, 8, 5120), (3, 5, 100), (4, 9, 512)])
@pytest.mark.parametrize("alpha", [1.0, 0.15])
def test_act_quantize_experts(dev, E, C, K, alpha):
    """Each expert's rows with its own bcol and α, every body (the plan's E·C rows
    pick one; the split body at E·C ≤ 32 rows), eagerly: codes off by one on ≤ 1e-5
    of them and a within one ulp at α < 1 (torch's pow and powf), bitwise at α = 1."""
    ops, ref = _ops()
    from repro_torch.kernels.act_quantize import act_quantize_cuda
    g = torch.Generator(device=dev).manual_seed(E * C + K)
    x = (torch.randn(E, C, K, generator=g, device=dev) * 3).to(torch.bfloat16)
    x[0, C // 2:] = 0
    bcol = torch.rand(E, K, generator=g, device=dev) * 3 + 0.25
    alpha_t = torch.full((E,), alpha, device=dev)
    alpha_t[-1] = 1.0
    qr, ar = ref.act_quantize_experts_ref(x, bcol, 8, alpha_t)
    bodies = [("rows", 1), ("sweep", 1)] + ([("split", 2)] if -(-K // 8) >= 2 else [])
    for body, splits in bodies:
        q, a = act_quantize_cuda(x.reshape(E * C, K), bcol, alpha_t, 0.0, 8, body, splits,
                                 rows_per_expert=C)
        torch.cuda.synchronize()
        q, a = q.reshape(qr.shape), a.reshape(ar.shape)
        ulps = (a.view(torch.int32) - ar.view(torch.int32)).abs().max().item()
        assert (q.int() - qr.int()).abs().max().item() <= (0 if alpha == 1.0 else 1), body
        assert (q != qr).float().mean().item() <= 1e-5, body
        assert ulps <= (0 if alpha == 1.0 else 1), body
    q, a = ops.act_quantize_experts(x, bcol, alpha_t)
    assert q.shape == (E, C, K) and a.shape == (E, C, 1)


@pytest.mark.parametrize("E,C,K,N", [(40, 8, 1536, 512), (40, 8, 512, 1536), (16, 8, 5120, 8192),
                                     (40, 512, 1536, 512), (40, 128, 512, 1536),
                                     (5, 37, 176, 48), (3, 130, 1040, 80), (4, 3, 100, 24)])
def test_qgemm_w8a8_experts_bitwise(dev, E, C, K, N):
    """The routed body and the tile body, bitwise against the per-expert plain
    version, eagerly and under graph replay; (4, 3, 100, 24) has K off the 16-row
    grid, so the plan routes it to the tile body."""
    ops, ref = _ops()
    from repro_torch.kernels.qgemm import (
        qgemm_w8a8_cuda, qgemm_w8a8_decode_cuda, qgemm_w8a8_plan, qgemm_w8a8_wgmma_cuda)
    g = torch.Generator(device=dev).manual_seed(E * C * K + N)
    qx = torch.randint(-127, 128, (E, C, K), generator=g, device=dev, dtype=torch.int8)
    qx[1, C // 2:] = 0
    qw = torch.randint(-127, 128, (E, K, N), generator=g, device=dev, dtype=torch.int8)
    a = torch.rand(E, C, 1, generator=g, device=dev) + 0.01
    sw = torch.rand(E, N, generator=g, device=dev) + 0.01
    want = ref.qgemm_w8a8_experts_ref(qx, qw, a, sw)
    body, splits = qgemm_w8a8_plan(C, K, N, experts=E)
    before = ops.BODY_LAUNCHES[f"qgemm_w8a8/experts_{body}"]
    out = ops.qgemm_w8a8_experts(qx, qw, a, sw)
    torch.cuda.synchronize()
    assert ops.BODY_LAUNCHES[f"qgemm_w8a8/experts_{body}"] == before + 1
    assert torch.equal(out, want)
    assert torch.equal(qgemm_w8a8_cuda(qx, qw, a, sw, experts=E), want)
    fn = {"decode": qgemm_w8a8_decode_cuda, "wgmma": qgemm_w8a8_wgmma_cuda}.get(body)
    if fn is not None:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            o = fn(qx, qw, a, sw, splits, experts=E)
        o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(o, want)


# ---------------------------------------------------------------- SSM and hybrid shapes

def _graph_replayed(call):
    """``call``'s output from one launch captured in a CUDA graph, replayed over an
    output overwritten first."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    out.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("M", [1, 4, 33, 2048])
def test_qgemm_w8a8_tile_body_mamba_in_proj(dev, M):
    """mamba2-130m's in_proj, K = 768, N = 2·1536 + 2·128 + 24 = 3352: N is off the
    16-column grid, so the wrapper routes every M to the 64 x 64 tile body; bitwise
    the plain version eagerly and under graph replay. Its out_proj (K = 1536,
    N = 768) goes to the decode or the wgmma body."""
    ops, ref = _ops()
    from repro_torch.kernels.qgemm import qgemm_w8a8_cuda, qgemm_w8a8_plan
    assert qgemm_w8a8_plan(M, 768, 3352)[0] == "tile"
    qx, qw, a, sw = _w8a8_inputs(dev, M, 768, 3352, M + 3352)
    before = ops.BODY_LAUNCHES["qgemm_w8a8/tile"]
    out = ops.qgemm_w8a8(qx, qw, a, sw)
    want = ref.qgemm_w8a8_ref(qx, qw, a, sw)
    torch.cuda.synchronize()
    assert ops.BODY_LAUNCHES["qgemm_w8a8/tile"] == before + 1
    assert torch.equal(out, want)
    assert torch.equal(_graph_replayed(lambda: qgemm_w8a8_cuda(qx, qw, a, sw)), want)
    qx, qw, a, sw = _w8a8_inputs(dev, M, 1536, 768, M + 768)
    body = qgemm_w8a8_plan(M, 1536, 768)[0]
    before = ops.BODY_LAUNCHES[f"qgemm_w8a8/{body}"]
    out = ops.qgemm_w8a8(qx, qw, a, sw)
    torch.cuda.synchronize()
    assert body != "tile" and ops.BODY_LAUNCHES[f"qgemm_w8a8/{body}"] == before + 1
    assert torch.equal(out, ref.qgemm_w8a8_ref(qx, qw, a, sw))


@pytest.mark.parametrize("M", [4, 2048])
@pytest.mark.parametrize("K", [768, 1536, 2048, 4096])
def test_act_quantize_ssm_widths(dev, M, K):
    """K1 at the in/out projections' K of mamba2 (768, 1536) and zamba2 (2048,
    4096), bf16 rows with outlier channels: codes off by one on <= 1e-5 of them
    and the row scale within one ulp (torch's pow and powf), eagerly and under
    graph replay."""
    ops, ref = _ops()
    g = torch.Generator(device=dev).manual_seed(M + K)
    x = (torch.randn(M, K, generator=g, device=dev) * 2).to(torch.bfloat16)
    x[:, torch.randperm(K, generator=g, device=dev)[:8]] *= 30
    bcol = torch.rand(K, generator=g, device=dev) * 3 + 0.25
    alpha = torch.tensor(0.15, device=dev)
    qr, ar = ref.act_quantize_ref(x, bcol, 8, alpha)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.act_quantize(x, bcol, alpha)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        qg, ag = ops.act_quantize(x, bcol, alpha)
    qg.zero_()
    ag.fill_(float("nan"))
    graph.replay()
    for q, a in (ops.act_quantize(x, bcol, alpha), (qg, ag)):
        torch.cuda.synchronize()
        assert (q.int() - qr.int()).abs().max().item() <= 1
        assert (q != qr).float().mean().item() <= 1e-5
        assert (a.view(torch.int32) - ar.view(torch.int32)).abs().max().item() <= 1


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("q_dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_paged_decode_group_size_1(dev, pool_dtype, q_dtype, atol):
    """K4 at zamba2's shared attention: multi-head, H = Hkv = 32 (one query head per
    KV head), D = 64, over f32, bf16 and int8 pools; bf16 q on the split
    tensor-core body, f32 q on the CUDA-core body; eagerly and under graph
    replay (bitwise the eager launch)."""
    ops, ref = _ops()
    B, Hkv, D, P, ps, maxP = 4, 32, 64, 96, 8, 24
    kp, vp, ks, vs, tab, kvl = _paged_inputs(dev, B, Hkv, D, P, ps, maxP, pool_dtype, 32)
    q = torch.randn(B, 1, Hkv, D, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(q_dtype)
    call = lambda: ops.paged_decode_attention(q, kp, vp, tab, kvl, k_scale_pages=ks,  # noqa: E731
                                              v_scale_pages=vs)
    out = call()
    want = ref.paged_decode_attention_ref(q.reshape(B, Hkv, 1, D), kp, vp, tab, kvl,
                                          k_scale_pages=ks, v_scale_pages=vs)
    torch.cuda.synchronize()
    err = (out.reshape(B, Hkv, 1, D).float() - want.float()).abs()
    assert float(err.max()) <= atol
    assert torch.equal(_graph_replayed(call), out)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_flash_attention_group_size_1(dev, dtype, atol):
    """K3 at zamba2's shared attention: B = 4, H = Hkv = 32, D = 64, S = 512, causal,
    per-row valid lengths."""
    ops, ref = _ops()
    g = torch.Generator(device=dev).manual_seed(64)
    q, k, v = (torch.randn(4, 32, 512, 64, generator=g, device=dev).to(dtype)
               for _ in range(3))
    kv_len = torch.tensor([512, 300, 129, 1], device=dev)
    out = ops.flash_attention(q, k, v, kv_len)
    want = ref.flash_attention_ref(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert float((out.float() - want.float()).abs().max()) <= atol
