"""K2's body routing and K-split plan (``repro_torch.kernels.qgemm``), on the CPU.

The decode body splits K across a thread-block cluster; the plan that picks the
body and the splits is plain Python, checked here for every linear shape of every
registered config. CPU tensors take the plain versions and move no launch count.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import all_archs, get  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.qgemm import (  # noqa: E402
    DECODE_MAX_M, MAX_SPLITS, TILE_K, decode_splits, qgemm_w8a8_plan, split_bounds,
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
    """M ≤ T runs the decode body where K and N take 16-byte chunks; larger M, or
    shapes and addresses it does not take, run the tile body."""
    takes = K % 16 == 0 and N % 16 == 0
    for M in (1, 4, DECODE_MAX_M):
        body, splits = qgemm_w8a8_plan(M, K, N)
        assert (body, splits) == (("decode", decode_splits(K, N)) if takes else ("tile", 1))
        assert qgemm_w8a8_plan(M, K, N, aligned=False) == ("tile", 1)
    for M in (DECODE_MAX_M + 1, 128, 2048):
        assert qgemm_w8a8_plan(M, K, N) == ("tile", 1)


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
    assert not any(ops.LAUNCHES.values()) and not any(ops.BODY_LAUNCHES.values())
