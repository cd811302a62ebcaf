"""The port's sharding logic against the reference's, on the CPU, in one process.

``Plan.describe()`` for every arch × ``SHAPES`` × mesh; every leaf's placement
against ``_param_spec`` / ``cache_shardings`` on the smoke archs' raw, prepared
int8, 2:4 and cache trees (dense and paged, fp and int8 KV); ``ShapeConfig``,
``cell_supported`` and ``with_padded_heads``; ``pad_head_params`` bitwise and the
padded model's logits; ``shard_tree`` round trips; the plain K1 given-max and K2
int32-out modes against the reference's jitted ``quantize_act_int8`` and int32
``dot_general``; and a row-parallel linear composed from two shards in one
process (two threads, a barrier for each collective) against the single-device
linear, bitwise on the integer paths.
"""
import dataclasses
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import quantize as JMQ  # noqa: E402
from repro.sharding import planner as jplanner  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import quantize as TMQ  # noqa: E402
from repro_torch.sharding import planner as tplanner  # noqa: E402

torch.set_num_threads(2)

ARCHS = jbase.all_archs()
SMOKE_ARCHS = ("starcoder2-7b", "gemma2-9b", "granite-moe-3b-a800m",
               "llama4-scout-17b-a16e", "mamba2-130m", "zamba2-1.2b", "pixtral-12b",
               "nemotron-4-15b", "deepseek-coder-33b")
AXES = [dict(data=1, model=2), dict(data=1, model=4), dict(data=1, model=8),
        dict(data=1, model=16), dict(data=2, model=2, expert=2)]


class FakeMesh:
    """Just enough mesh for the planners (axis sizes)."""

    def __init__(self, **axes):
        self.shape = dict(axes)


def _rank_mesh(shape: dict, rank: int) -> Mesh:
    """The mesh of ``rank`` on a world of ``shape`` (no process groups: shard
    cutting reads coordinates only)."""
    names = tuple(shape)
    coords = tplanner._coords(shape, rank)
    return Mesh(names, dict(shape), coords, rank, {n: None for n in names})


# ======================================================================================
# configs
# ======================================================================================

def test_shapes_and_cells_match():
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for arch in ARCHS:
        for name in jbase.SHAPES:
            assert tbase.cell_supported(tget(arch), tbase.SHAPES[name]) == \
                jbase.cell_supported(jget(arch), jbase.SHAPES[name]), (arch, name)


@pytest.mark.parametrize("tp", [2, 3, 4, 16])
def test_with_padded_heads_matches(tp):
    for arch in ARCHS:
        for smoke in (False, True):
            got = tbase.with_padded_heads(tget(arch, smoke=smoke), tp)
            want = jbase.with_padded_heads(jget(arch, smoke=smoke), tp)
            assert (got.n_heads, got.n_kv_heads) == (want.n_heads, want.n_kv_heads), arch


# ======================================================================================
# plans and placements
# ======================================================================================

@pytest.mark.parametrize("arch", ARCHS)
def test_plan_describe_matches(arch):
    for axes in AXES:
        for shape in jbase.SHAPES:
            want = jplanner.make_plan(jget(arch), jbase.SHAPES[shape], FakeMesh(**axes))
            got = tplanner.make_plan(tget(arch), tbase.SHAPES[shape], FakeMesh(**axes))
            assert got.describe() == want.describe(), (arch, axes, shape)
        want = jplanner.make_serve_plan(jget(arch), FakeMesh(**axes), force_tier="tp_ffn")
        got = tplanner.make_serve_plan(tget(arch), FakeMesh(**axes), force_tier="tp_ffn")
        assert got.describe() == want.describe()


def _jax_trees(arch):
    cfg = dataclasses.replace(jget(arch, smoke=True), dtype="float32")
    raw = JM.init_params(jax.random.PRNGKey(0), cfg)
    q = JMQ.quantize_tree(raw, jql.W8A8_INT8)
    sp = JMQ.sparsify_tree(q, JMQ.SparsityPlan(nm=(2, 4)))
    return cfg, {"raw": raw, "int8": q, "2:4": sp}


def _ref_param_specs(tree, cfg, plan, mesh):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jplanner._path_str(p): tuple(jplanner._param_spec(jplanner._path_str(p),
                                                              leaf.shape, cfg, plan, mesh))
            for p, leaf in flat}


def _port_specs(placements):
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = node

    walk(placements, ())
    return out


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_param_placements_match(arch):
    cfg_j, trees = _jax_trees(arch)
    cfg_t = dataclasses.replace(tget(arch, smoke=True), dtype="float32")
    for axes in AXES:
        mesh = FakeMesh(**axes)
        for shape in ("decode_32k", "train_4k"):
            jplan = jplanner.make_plan(cfg_j, jbase.SHAPES[shape], mesh)
            tplan = tplanner.make_plan(cfg_t, tbase.SHAPES[shape], mesh)
            for kind, tree in trees.items():
                ttree = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                                  device="cpu")
                got = _port_specs(tplanner.param_placements(ttree, cfg_t, tplan, mesh))
                assert got == _ref_param_specs(tree, cfg_j, jplan, mesh), (kind, axes, shape)


class _Box:
    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_cache_placements_match(arch, monkeypatch):
    monkeypatch.setattr(jplanner, "NamedSharding", _Box)
    cfg_j = dataclasses.replace(jget(arch, smoke=True), dtype="float32")
    cfg_t = dataclasses.replace(tget(arch, smoke=True), dtype="float32")
    for axes in AXES:
        mesh = FakeMesh(**axes)
        jplan, tplan = jplanner.make_serve_plan(cfg_j, mesh), tplanner.make_serve_plan(cfg_t,
                                                                                       mesh)
        for layout in ("dense", "paged"):
            for kv_int8 in (False, True):
                kw = dict(kv_int8=kv_int8, layout=layout, page_size=8)
                jc = jax.eval_shape(lambda: JM.init_cache(cfg_j, 4, 32, jnp.float32, **kw))
                tc = TM.init_cache(cfg_t, 4, 32, torch.float32, device="cpu", **kw)
                flat = jax.tree_util.tree_flatten_with_path(
                    jplanner.cache_shardings(jc, cfg_j, jplan, mesh),
                    is_leaf=lambda x: isinstance(x, _Box))[0]
                want = {jplanner._path_str(p): b.spec for p, b in flat}
                got = _port_specs(tplanner.cache_placements(tc, cfg_t, tplan, mesh))
                assert got == want, (axes, layout, kv_int8)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "granite-moe-3b-a800m",
                                  "llama4-scout-17b-a16e"])
def test_shard_tree_round_trips(arch):
    cfg = dataclasses.replace(tget(arch, smoke=True), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    raw = TM.init_params(gen, cfg, device="cpu")
    q = TMQ.sparsify_tree(TMQ.quantize_tree(raw, tql.W8A8_INT8), TMQ.SparsityPlan(nm=(2, 4)))
    for axes in AXES[:2] + AXES[4:]:
        plan = tplanner.make_serve_plan(cfg, FakeMesh(**axes))
        for tree in (raw, q):
            pl = tplanner.param_placements(tree, cfg, plan, FakeMesh(**axes))
            n = int(np.prod(list(axes.values())))
            shards = [tplanner.shard_tree(tree, pl, _rank_mesh(axes, r)) for r in range(n)]
            back = tplanner.unshard_tree(shards, pl, axes)
            got, want = TM.leaves(back), TM.leaves(tree)
            assert len(got) == len(want)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), axes
            if axes["model"] > 1:      # something really split
                assert sum(s.numel() for s in TM.leaves(shards[0])) < \
                    sum(t.numel() for t in want)


def test_token_group_count_matches():
    from repro.sharding import hints
    from repro_torch.sharding import collectives as SC
    assert SC.token_group_count(8) == hints.token_group_count(8) == 1      # no data axes
    for dp in (1, 2, 4):
        for n in (1, 6, 8, 12):
            for groups in (True, False):
                with hints.sharding_hints(dp_axes=("data",), mesh=FakeMesh(data=dp, model=1),
                                          token_groups=groups):
                    want = hints.token_group_count(n)
                assert SC.token_group_count(n, dp, groups) == want, (dp, n, groups)


# ======================================================================================
# head padding
# ======================================================================================

def test_pad_head_params_bitwise_and_logits():
    cfg_j = dataclasses.replace(jget("starcoder2-7b", smoke=True), dtype="float32")
    cfg_t = dataclasses.replace(tget("starcoder2-7b", smoke=True), dtype="float32")
    pad_j, pad_t = jbase.with_padded_heads(cfg_j, 3), tbase.with_padded_heads(cfg_t, 3)
    assert pad_t.n_heads == 6
    params = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    want = jax.tree_util.tree_map(np.asarray, JMQ.pad_head_params(params, cfg_j, pad_j))
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                        device="cpu")
    got = TMQ.pad_head_params(tparams, cfg_t, pad_t)
    for a, b in zip(TM.leaves(got), TM.leaves(convert.params_from_numpy(want, device="cpu"))):
        assert torch.equal(a, b)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg_t.vocab, (2, 16)))
    logits, _ = TM.apply(tparams, {"tokens": toks}, cfg_t, mode="train")
    logits_pad, _ = TM.apply(got, {"tokens": toks}, pad_t, mode="train")
    assert torch.equal(logits, logits_pad)


# ======================================================================================
# the kernels' new modes (plain versions)
# ======================================================================================

@pytest.mark.parametrize("M,K,shards", [(4, 256, 2), (33, 512, 4), (7, 192, 3)])
def test_act_quantize_given_max_bitwise(M, K, shards):
    rng = np.random.default_rng(M)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[:, rng.choice(K, 4, replace=False)] *= 40.0
    x[0] = 0.0                                        # an all-zero row: the EPS floor
    bcol = (np.abs(x).max(axis=0) + 0.5).astype(np.float32) ** 0.85
    jq, ja = jax.jit(lambda x, b, a: jql.quantize_act_int8(x, b, jql.W8A8_INT8, alpha=a))(
        jnp.asarray(x), jnp.asarray(bcol), jnp.float32(1.0))
    xt, bt = torch.from_numpy(x), torch.from_numpy(bcol)
    gmax = xt.abs().amax(dim=-1)
    w = K // shards
    for alpha, q_want, a_want in ((torch.tensor(1.0), np.asarray(jq), np.asarray(ja)),
                                  (0.15, *[t.numpy() for t in ops.act_quantize(xt, bt, 0.15)])):
        for s in range(shards):
            cols = slice(s * w, (s + 1) * w)
            q, a = ops.act_quantize(xt[:, cols].contiguous(), bt[cols].contiguous(), alpha,
                                    row_max=gmax)
            np.testing.assert_array_equal(q.numpy(), q_want[:, cols])
            np.testing.assert_array_equal(a.numpy(), a_want)


@pytest.mark.parametrize("M,K,N", [(1, 64, 48), (16, 384, 64), (40, 1024, 96)])
def test_qgemm_int32_out_bitwise(M, K, N):
    rng = np.random.default_rng(K)
    qx = rng.integers(-127, 128, (M, K), dtype=np.int8)
    qw = rng.integers(-127, 128, (K, N), dtype=np.int8)
    want = np.asarray(jax.jit(lambda a, b: jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32))(qx, qw))
    got = ops.qgemm_w8a8_acc(torch.from_numpy(qx), torch.from_numpy(qw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    mask = TMQ.nm_keep_mask(torch.from_numpy(qw).abs().float(), 2, 4)
    from repro_torch.core import packing
    packed = packing.pack_mask(mask, axis=0)
    sparse_w = torch.from_numpy(qw) * mask.to(torch.int8)
    got_s = ops.qgemm_w8a8_sparse_acc(torch.from_numpy(qx), sparse_w, packed)
    want_s = torch.from_numpy(qx).int() @ sparse_w.int()
    assert torch.equal(got_s, want_s)


# ======================================================================================
# a row-parallel linear from two shards in one process
# ======================================================================================

class _ThreadCollectives:
    """Collectives between threads of one process: each call publishes this
    rank's tensor, waits for the others, and reduces in rank order."""

    def __init__(self, n):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def _reduce(self, rank, t, fn):
        self.slots[rank] = t
        self.barrier.wait()
        out = fn(self.slots)
        self.barrier.wait()
        return out

    def bind(self, rank):
        def red(fn):
            return lambda t, axis="model": self._reduce(rank, t, fn)
        return types.SimpleNamespace(
            sum_i32=red(lambda ts: sum(ts[1:], ts[0])),
            sum_f32=red(lambda ts: sum(ts[1:], ts[0])),
            max_f32=red(lambda ts: torch.stack([t.to(torch.float32) for t in ts]).amax(0)))


@pytest.mark.parametrize("int_exec,use_kernels", [("ref", False), ("kernel", True),
                                                  ("dequant", False)])
@pytest.mark.parametrize("masked", [False, True])
def test_row_parallel_linear_two_shards(int_exec, use_kernels, masked):
    rng = np.random.default_rng(3)
    K, N, tp = 256, 96, 2
    x = torch.from_numpy(rng.standard_normal((2, 5, K)).astype(np.float32))
    x[..., 7] *= 30.0
    w = torch.from_numpy((rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32))
    cmax = x.abs().amax(dim=(0, 1))
    p = tql.prepare_int8({"w": w}, tql.W8A8_INT8, cmax=cmax)
    if masked:
        p = TMQ.sparsify_tree({"down": p}, TMQ.SparsityPlan(nm=(2, 4)))["down"]
    want = tql.apply(p, x, tql.W8A8_INT8, use_kernels=use_kernels, int_exec=int_exec)
    coll = _ThreadCollectives(tp)
    outs = [None] * tp
    k = K // tp

    def run(r):
        shard = {"qw": p["qw"][r * k:(r + 1) * k].contiguous(), "sw": p["sw"],
                 "bcol": p["bcol"][r * k:(r + 1) * k].contiguous(), "qalpha": p["qalpha"]}
        if masked:
            shard["mask"] = p["mask"][r * k // 8:(r + 1) * k // 8].contiguous()
        ctx = types.SimpleNamespace(coll=coll.bind(r), tp_index=r)
        outs[r] = tql.apply_row_parallel(shard, x[..., r * k:(r + 1) * k].contiguous(),
                                         tql.W8A8_INT8, ctx, use_kernels=use_kernels,
                                         int_exec=int_exec)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(tp)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    for out in outs:
        if int_exec == "dequant":       # f32 partial sums: close, not bitwise
            torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(out, want)
