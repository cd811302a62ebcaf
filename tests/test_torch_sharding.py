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
    """The reference's raw, int8 and 2:4 smoke trees as shapes (``jax.eval_shape``:
    placements read shapes only, and the traced trees hold the eager ones' paths,
    shapes and dtypes)."""
    cfg = dataclasses.replace(jget(arch, smoke=True), dtype="float32")
    raw = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
    q = jax.eval_shape(lambda r: JMQ.quantize_tree(r, jql.W8A8_INT8), raw)
    sp = jax.eval_shape(lambda r: JMQ.sparsify_tree(r, JMQ.SparsityPlan(nm=(2, 4))), q)
    return cfg, {"raw": raw, "int8": q, "2:4": sp}


def _meta_tree(tree):
    """A port tree of meta tensors with the shapes of a reference shape tree."""
    return jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), tree)


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
                got = _port_specs(tplanner.param_placements(_meta_tree(tree), cfg_t, tplan,
                                                            mesh))
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


# ======================================================================================
# data axes, W4 scales, expert_tp, SSM state, dp_only
# ======================================================================================

#: the reference's FakeMesh shapes (tests/test_sharding.py)
REF_MESHES = [dict(data=16, model=16), dict(pod=2, data=16, model=16), dict(data=4, model=2),
              dict(data=2, model=4), dict(data=1, model=7)]
#: (arch, tree, forced tier, forced MoE mode)
PLACED = [("starcoder2-7b", "w4", None, None), ("starcoder2-7b", "int8", "dp_only", None),
           ("granite-moe-3b-a800m", "int8", None, "expert_tp"),
           ("granite-moe-3b-a800m", "raw", None, "expert_tp"),
           ("mamba2-130m", "int8", None, None), ("zamba2-1.2b", "int8", None, None)]


@pytest.mark.parametrize("axes", REF_MESHES, ids=["x".join(f"{k}{v}" for k, v in a.items())
                                                  for a in REF_MESHES])
def test_data_w4_experts_state_placements_match(axes, monkeypatch):
    """Plans, param placements (W4 group scales over the model axis where it divides
    the groups, expert_tp's d_ff_expert, dp_only's replication) and cache
    placements (slots and pages over the data axes, SSM state heads over "model",
    the conv state replicated) equal the reference's on its meshes, for trees the
    port builds (the reference's rules read only paths and shapes)."""
    monkeypatch.setattr(jplanner, "NamedSharding", _Box)
    mesh = FakeMesh(**axes)
    w4t, w4j = (dataclasses.replace(q.W4A8_G128, w_group=32) for q in (tql, jql))
    for arch, kind, tier, moe_mode in PLACED:
        cfg_t = dataclasses.replace(tget(arch, smoke=True), dtype="float32")
        cfg_j = dataclasses.replace(jget(arch, smoke=True), dtype="float32")
        tplan = tplanner.make_serve_plan(cfg_t, mesh, force_tier=tier)
        jplan = jplanner.make_serve_plan(cfg_j, mesh, force_tier=tier)
        if moe_mode:
            tplan = dataclasses.replace(tplan, moe_mode=moe_mode)
            jplan = dataclasses.replace(jplan, moe_mode=moe_mode)
        assert tplan.describe() == jplan.describe(), (arch, axes)
        raw = TM.init_params(torch.Generator().manual_seed(0), cfg_t, device="cpu")
        tree = {"raw": raw, "int8": lambda: TMQ.quantize_tree(raw, tql.W8A8_INT8),
                "w4": lambda: TMQ.quantize_tree(raw, w4t)}[kind]
        tree = tree() if callable(tree) else tree
        got = _port_specs(tplanner.param_placements(tree, cfg_t, tplan, mesh))
        shapes = {p: tuple(t.shape) for p, t in _port_specs(
            tplanner._walk(tree, lambda path, t: t)).items()}
        want = {p: tuple(jplanner._param_spec(p, s, cfg_j, jplan, mesh))
                for p, s in shapes.items()}
        assert got == want, (arch, kind, axes)
        if kind == "w4" and axes["model"] == 2:      # down's 4 groups split over 2
            assert got["blocks/0/mlp/down/sw"] == (None, "model", None)
        for layout in ("dense", "paged"):
            kw = dict(kv_int8=True, layout=layout, page_size=8)
            jc = jax.eval_shape(lambda: JM.init_cache(cfg_j, 32, 32, jnp.float32, **kw))
            tc = TM.init_cache(cfg_t, 32, 32, torch.float32, device="cpu", **kw)
            flat = jax.tree_util.tree_flatten_with_path(
                jplanner.cache_shardings(jc, cfg_j, jplan, mesh),
                is_leaf=lambda x: isinstance(x, _Box))[0]
            want_c = {jplanner._path_str(p): b.spec for p, b in flat}
            assert _port_specs(tplanner.cache_placements(tc, cfg_t, tplan, mesh)) == want_c, \
                (arch, layout, axes)


@pytest.mark.parametrize("M,K,N,group", [(4, 256, 64, 32), (33, 512, 96, 64), (7, 384, 48, 128)])
def test_qgemm_w4a8_group_acc_bitwise(M, K, N, group):
    """K8's group-acc mode (plain version): the reference's per-group int32 partials
    (``_int4_matmul_ref``'s einsum under ``jax.jit``) exactly; the group dequant in
    its order, (Σ_g f32(acc) · sw) · a, is the plain K8 bitwise; a split of the
    groups between two shards gives the whole product's partials, concatenated."""
    from repro_torch.core import packing
    rng = np.random.default_rng(K + N)
    qx = rng.integers(-127, 128, (M, K), dtype=np.int8)
    codes = rng.integers(-7, 8, (K, N), dtype=np.int8)
    qw4 = packing.pack_int4(torch.from_numpy(codes), axis=-2)
    G = K // group
    want = np.asarray(jax.jit(lambda x, w: jnp.einsum(
        "mgk,gko->mgo", x.reshape(M, G, group).astype(jnp.int32),
        w.reshape(G, group, N).astype(jnp.int32)))(qx, codes))
    got = ops.qgemm_w4a8_group_acc(torch.from_numpy(qx), qw4, group=group)
    assert got.dtype == torch.int32 and got.shape == (M, G, N)
    np.testing.assert_array_equal(got.numpy(), want)
    a = torch.from_numpy(rng.random((M, 1), dtype=np.float32) + 0.01)
    sw = torch.from_numpy(rng.random((G, N), dtype=np.float32) * 0.01 + 1e-4)
    assert torch.equal((got.float() * sw).sum(dim=-2) * a,
                       ops.qgemm_w4a8(torch.from_numpy(qx), qw4, a, sw, group=group))
    if G % 2 == 0:
        h = K // 2
        parts = [ops.qgemm_w4a8_group_acc(torch.from_numpy(qx[:, s * h:(s + 1) * h].copy()),
                                          qw4[s * h // 2:(s + 1) * h // 2].contiguous(),
                                          group=group) for s in range(2)]
        assert torch.equal(torch.cat(parts, dim=1), got)


@pytest.mark.parametrize("E,C,K,N", [(4, 8, 64, 48), (3, 5, 96, 32), (8, 16, 128, 64)])
def test_experts_given_max_and_int32_out_bitwise(E, C, K, N):
    """The expert-batched K1 in its given-max mode on each of two column shards of
    every (e, c) row: the reference's jitted ``quantize_act_int8`` on the whole rows,
    sliced, at α = 1, and the port's whole-row codes and scales at α = 0.15; the
    expert-batched K2's int32-out mode: the reference's int32 einsum exactly, and
    dequantized in K2's epilogue order the expert-batched K2 bitwise."""
    rng = np.random.default_rng(E * C + K)
    x = (rng.standard_normal((E, C, 2 * K)) * 2).astype(np.float32)
    x[:, :, rng.choice(2 * K, 3, replace=False)] *= 30.0
    x[0, C // 2:] = 0.0                                # all-zero rows: the EPS floor
    bcol = (rng.random((E, 2 * K)) * 3 + 0.25).astype(np.float32)
    jq, ja = jax.jit(lambda x, b: jql.quantize_act_int8(
        x, b, jql.W8A8_INT8, alpha=jnp.ones((E, 1, 1), jnp.float32)))(
        jnp.asarray(x), jnp.asarray(bcol[:, None, :]))
    xt, bt = torch.from_numpy(x), torch.from_numpy(bcol)
    gmax = xt.abs().amax(dim=-1)
    for alpha, q_want, a_want in (
            (torch.ones(E), np.asarray(jq), np.asarray(ja)),
            (torch.full((E,), 0.15), *[t.numpy() for t in ops.act_quantize_experts(
                xt, bt, torch.full((E,), 0.15))])):
        for s in range(2):
            cols = slice(s * K, (s + 1) * K)
            q, a = ops.act_quantize_experts(xt[..., cols].contiguous(), bt[:, cols].contiguous(),
                                            alpha, row_max=gmax)
            np.testing.assert_array_equal(q.numpy(), q_want[..., cols])
            np.testing.assert_array_equal(a.numpy(), a_want)
    qx = rng.integers(-127, 128, (E, C, K), dtype=np.int8)
    qw = rng.integers(-127, 128, (E, K, N), dtype=np.int8)
    want = np.asarray(jax.jit(lambda u, v: jnp.einsum(
        "eci,eio->eco", u.astype(jnp.int32), v.astype(jnp.int32)))(qx, qw))
    acc = ops.qgemm_w8a8_experts_acc(torch.from_numpy(qx), torch.from_numpy(qw))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)
    a = torch.from_numpy(rng.random((E, C, 1), dtype=np.float32) + 0.01)
    sw = torch.from_numpy(rng.random((E, N), dtype=np.float32) + 0.01)
    assert torch.equal((acc.float() * a) * sw[:, None],
                       ops.qgemm_w8a8_experts(torch.from_numpy(qx), torch.from_numpy(qw), a, sw))
