"""The PyTorch port's Mamba2 (SSD) block against the JAX reference (CPU).

Smoke configs in float32 (mamba2-130m: 4 layers, d_model 64, 8 heads of 16,
state 16, chunk 16; zamba2-1.2b: 5 layers, super-blocks of 2, tail 1), params
from ``repro.models.model.init_params`` carried across with ``convert``. Inputs
are numpy from a seed; the reference runs under ``jax.jit`` (its eager results
differ).

* ``_causal_conv`` and ``_conv_step`` (tap order k = 0..K-1, then the bias) and
  ``_segsum`` within rel 1e-6; ``ssd_scan`` within rel 1e-5 at divisible and
  non-divisible S, with and without a carried ``init_state``; decode steps of
  ``ssd_decode_step`` against the scan; ``softplus`` against ``jax.nn.softplus``
  above F.softplus's threshold.
* ``mamba_apply`` (fp and int8 in/out projections): a right-padded prefill with
  ``cur_len`` (output at the valid positions, final state and conv window), a
  decode step, and the paged route through a ``state_table`` with sentinel rows
  (the sentinel's clamped page reads but is never written), within rel 1e-5.
* ``init_cache``'s trees on both layouts (leaf names, shapes, dtypes, tables),
  ``init_params``' tree and the converted reference tree, ``apply`` logits on
  train/prefill/decode, and the calibration tables of zamba2's shared block and
  tail under the reference's names.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import calibration as jcal, qlinear as jql  # noqa: E402
from repro.models import model as JM, ssm as JS  # noqa: E402
from repro.models.layers import QuantContext as JQuantContext  # noqa: E402
from repro.models.quantize import quantize_tree as j_quantize_tree  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import calibration as tcal, qlinear as tql  # noqa: E402
from repro_torch.models import model as TM, ssm as TS  # noqa: E402
from repro_torch.models.layers import QuantContext  # noqa: E402

torch.set_num_threads(2)

ARCHS = ("mamba2-130m", "zamba2-1.2b")
RTOL = 1e-5


@dataclasses.dataclass
class Ssm:
    cfg_j: object
    cfg_t: object
    jtrees: dict                         # "fp" raw, "int8" quantize_tree (W8A8, c = 1)
    ttrees: dict


_SSM = {}


def _ssm(arch: str) -> Ssm:
    if arch not in _SSM:
        cfg_j = dataclasses.replace(jget(arch, smoke=True), dtype="float32")
        cfg_t = dataclasses.replace(tget(arch, smoke=True), dtype="float32")
        raw = JM.init_params(jax.random.PRNGKey(0), cfg_j)
        jtrees = {"fp": raw, "int8": j_quantize_tree(raw, jql.W8A8_INT8)}
        ttrees = {k: convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, v),
                                               device="cpu") for k, v in jtrees.items()}
        _SSM[arch] = Ssm(cfg_j, cfg_t, jtrees, ttrees)
    return _SSM[arch]


def _np(t):
    return t.detach().cpu().float().numpy()


def _close(got, want, rtol=RTOL, atol=None):
    """Within rtol of the reference, relative to its largest magnitude."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got) if isinstance(got, torch.Tensor) else got, want,
                               rtol=0, atol=atol if atol is not None else rtol * scale)


def _scan_inputs(seed, Bsz=2, S=32, H=3, P=4, N=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, S, H)) - 1)).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((Bsz, S, N)).astype(np.float32)
    Cm = rng.standard_normal((Bsz, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrs):
    return [torch.as_tensor(a) for a in arrs]


# ======================================================================================
# The pieces
# ======================================================================================

@pytest.mark.parametrize("S", [1, 3, 17])
def test_causal_conv(S):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    want = jax.jit(JS._causal_conv)(x, w, b)
    _close(TS._causal_conv(*_t(x, w, b)), want, rtol=1e-6)


def test_conv_step_rolls_the_window():
    rng = np.random.default_rng(4)
    x_t = rng.standard_normal((3, 24)).astype(np.float32)
    buf = rng.standard_normal((3, 3, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    yj, bj = jax.jit(JS._conv_step)(x_t, buf, w, b)
    yt, bt = TS._conv_step(*_t(x_t, buf, w, b))
    _close(yt, yj, rtol=1e-6)
    np.testing.assert_array_equal(_np(bt), np.asarray(bj))
    # a conv step over the last K-1 inputs is the causal conv's last position
    xs = np.concatenate([buf, x_t[:, None]], axis=1)
    _close(yt, _np(TS._causal_conv(*_t(xs, w, b)))[:, -1], rtol=1e-6)


def test_segsum():
    dA = -np.abs(np.random.default_rng(5).standard_normal((2, 16, 3))).astype(np.float32)
    want = np.asarray(jax.jit(JS._segsum)(dA))
    got = _np(TS._segsum(torch.as_tensor(dA)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], rtol=1e-6)


def test_softplus_matches_logaddexp():
    x = np.array([-30.0, -1.0, 0.0, 0.5, 19.9, 20.0, 20.5, 40.0], np.float32)
    np.testing.assert_array_equal(_np(TS._softplus(torch.as_tensor(x))),
                                  np.asarray(jax.jit(jax.nn.softplus)(x)))


@pytest.mark.parametrize("S,chunk", [(32, 8), (29, 8), (16, 16), (5, 16)])
@pytest.mark.parametrize("carried", [False, True])
def test_ssd_scan(S, chunk, carried):
    x, dt, A, Bm, Cm = _scan_inputs(S + chunk, S=S)
    init = (np.random.default_rng(9).standard_normal((2, 3, 4, 8)).astype(np.float32)
            if carried else None)
    fn = jax.jit(lambda *a: JS.ssd_scan(*a[:5], chunk, init_state=a[5] if carried else None))
    yj, sj = fn(x, dt, A, Bm, Cm, init)
    yt, st = TS.ssd_scan(*_t(x, dt, A, Bm, Cm), chunk,
                         init_state=None if init is None else torch.as_tensor(init))
    assert yt.shape == (2, S, 3, 4) and st.dtype == torch.float32
    _close(yt, yj)
    _close(st, sj)


def test_ssd_scan_continues_across_calls():
    """Two scans carrying the state equal one scan (a prefill continued)."""
    x, dt, A, Bm, Cm = _t(*_scan_inputs(11, S=32))
    y, s = TS.ssd_scan(x, dt, A, Bm, Cm, 8)
    y1, s1 = TS.ssd_scan(x[:, :13], dt[:, :13], A, Bm[:, :13], Cm[:, :13], 8)
    y2, s2 = TS.ssd_scan(x[:, 13:], dt[:, 13:], A, Bm[:, 13:], Cm[:, 13:], 8, init_state=s1)
    _close(torch.cat([y1, y2], 1), _np(y))
    _close(s2, _np(s))


def test_ssd_decode_steps_match_scan():
    x, dt, A, Bm, Cm = _scan_inputs(12, S=16)
    yj, sj = jax.jit(lambda *a: JS.ssd_scan(*a, 8))(x, dt, A, Bm, Cm)
    xt, dtt, At, Bt, Ct = _t(x, dt, A, Bm, Cm)
    state = torch.zeros(2, 3, 4, 8)
    jstate = jnp.zeros((2, 3, 4, 8))
    jstep = jax.jit(JS.ssd_decode_step)
    for i in range(16):
        state, y = TS.ssd_decode_step(state, xt[:, i], dtt[:, i], At, Bt[:, i], Ct[:, i])
        jstate, jy = jstep(jstate, x[:, i], dt[:, i], A, Bm[:, i], Cm[:, i])
        _close(y, jy)
        _close(y, np.asarray(yj)[:, i], rtol=1e-4)
    _close(state, jstate)
    _close(state, sj, rtol=1e-4)


# ======================================================================================
# mamba_apply
# ======================================================================================

def _layer(tree, i=0):
    return jax.tree_util.tree_map(lambda a: a[i], tree["blocks"][0]["ssm"])


def _tlayer(tree, i=0):
    return TM.layer_slice(tree["blocks"][0]["ssm"], i)


def _mamba_cache(cfg, rows, seed=0):
    """A (rows, ...) dense SSM cache with seeded nonzero state and window."""
    rng = np.random.default_rng(seed)
    C = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {"state": rng.standard_normal((rows, cfg.ssm_heads, cfg.ssm_head_dim,
                                          cfg.ssm_state)).astype(np.float32) * 0.3,
            "conv": rng.standard_normal((rows, cfg.ssm_conv - 1, C)).astype(np.float32)}


QUANTS = {"fp": (jql.FP, tql.FP), "int8": (jql.W8A8_INT8, tql.W8A8_INT8)}


def _mamba_pair(z, tree, x, **kw):
    """(reference outputs, port outputs, port cache after) of one mamba_apply."""
    qj, qt = QUANTS[tree]
    cache = kw.pop("cache", None)
    table = kw.pop("state_table", None)
    cur = kw.pop("cur_len", None)

    def jfn(p, xx, c, tbl, cl):
        return JS.mamba_apply(p, xx, z.cfg_j, JQuantContext(qj), cache=c, state_table=tbl,
                              cur_len=cl, **kw)

    jout, jcache = jax.jit(jfn)(_layer(z.jtrees[tree]), x, cache, table, cur)
    tcache = None if cache is None else {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
    tout, _ = TS.mamba_apply(_tlayer(z.ttrees[tree]), torch.as_tensor(x), z.cfg_t,
                             QuantContext(qt), cache=tcache,
                             state_table=None if table is None else torch.as_tensor(table),
                             cur_len=None if cur is None else torch.as_tensor(cur), **kw)
    return (np.asarray(jout), jcache), (tout, tcache)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tree", ["fp", "int8"])
def test_mamba_prefill_with_cur_len(arch, tree):
    """Right-padded prefill: the valid positions' output, the final state and the
    last K-1 valid pre-conv inputs (a row shorter than the window zero-fills)."""
    z = _ssm(arch)
    x = np.random.default_rng(20).standard_normal((3, 21, z.cfg_t.d_model)).astype(np.float32)
    cur = np.array([21, 13, 2], np.int32)
    (jo, jc), (to, tc) = _mamba_pair(z, tree, x, cache=_mamba_cache(z.cfg_t, 3),
                                     cur_len=cur)
    for b, n in enumerate(cur):
        _close(to[b, :n], jo[b, :n])
    _close(tc["state"], jc["state"])
    _close(tc["conv"], jc["conv"])
    assert float(tc["conv"][2, 0].abs().max()) == 0.0      # 2 tokens: one zero row


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tree", ["fp", "int8"])
def test_mamba_decode(arch, tree):
    z = _ssm(arch)
    x = np.random.default_rng(21).standard_normal((3, 1, z.cfg_t.d_model)).astype(np.float32)
    (jo, jc), (to, tc) = _mamba_pair(z, tree, x, cache=_mamba_cache(z.cfg_t, 3, seed=1),
                                     decode=True)
    _close(to, jo)
    _close(tc["state"], jc["state"])
    np.testing.assert_array_equal(_np(tc["conv"]), np.asarray(jc["conv"]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("decode", [False, True])
def test_mamba_paged_sentinel_rows(arch, decode):
    """The paged route: rows 0 and 2 own pages 3 and 1; row 1 holds the sentinel
    nP = 5, which gathers the clamped page 4 and writes nowhere. A paged prefill
    starts from a zero state whatever its page holds."""
    z = _ssm(arch)
    pools = _mamba_cache(z.cfg_t, 5, seed=2)
    pools = {"state_pages": pools["state"], "conv_pages": pools["conv"]}
    table = np.array([3, 5, 1], np.int32)
    S = 1 if decode else 12
    x = np.random.default_rng(22).standard_normal((3, S, z.cfg_t.d_model)).astype(np.float32)
    kw = dict(decode=True) if decode else dict(cur_len=np.array([12, 12, 7], np.int32))
    (jo, jc), (to, tc) = _mamba_pair(z, "int8", x, cache=pools, state_table=table, **kw)
    for b in (0, 2):
        _close(to[b], jo[b])
    for name in ("state_pages", "conv_pages"):
        _close(tc[name], jc[name])
        for page in (0, 2, 4):                               # unowned pages untouched
            np.testing.assert_array_equal(_np(tc[name][page]), pools[name][page])


# ======================================================================================
# Trees and the model
# ======================================================================================

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree(arch):
    """``init_params``' tree has the reference's leaves and shapes (zamba2:
    ``tail`` and ``shared_attn``), and the converted reference tree round-trips
    bitwise, the prepared in/out projections included."""
    z = _ssm(arch)
    mine = TM.init_params(torch.Generator().manual_seed(0), z.cfg_t, device="cpu")
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(convert.params_to_numpy(mine)) == shapes(z.jtrees["fp"])
    for key in ("fp", "int8"):
        back = convert.params_to_numpy(z.ttrees[key])
        flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
        flat_j = jax.tree_util.tree_leaves_with_path(z.jtrees[key])
        assert len(flat_j) == len(flat_t)
        for path, leaf in flat_j:
            np.testing.assert_array_equal(flat_t[path], np.asarray(leaf))
    assert ("tail" in mine) == ("shared_attn" in mine) == (z.cfg_t.family == "hybrid")
    ssm0 = mine["blocks"][0]["ssm"]
    assert float(ssm0["A_log"][0, -1]) == pytest.approx(np.log(16.0))
    dt = torch.logaddexp(ssm0["dt_bias"], torch.zeros(()))   # softplus undoes the bias
    assert 1e-3 <= float(dt.min()) and float(dt.max()) <= 1e-1 + 1e-6


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("kv_int8", [False, True])
def test_init_cache_trees(arch, layout, kv_int8):
    z = _ssm(arch)
    kw = dict(kv_int8=kv_int8, layout=layout, page_size=8)
    jc = JM.init_cache(z.cfg_j, 3, 32, jnp.float32, **kw)
    tc = TM.init_cache(z.cfg_t, 3, 32, torch.float32, device="cpu", **kw)
    desc = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (tuple(a.shape), np.dtype(a.dtype).name), tree)
    assert desc(convert.params_to_numpy(tc)) == desc(jc)
    for table in ("page_table", "state_table"):
        assert (table in tc) == (table in jc)
        if table in tc:
            np.testing.assert_array_equal(_np(tc[table]), np.asarray(jc[table]))
    if layout == "paged":
        assert ("page_table" in tc) == (arch == "zamba2-1.2b")   # mamba2 has no KV


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_logits(arch):
    """``apply`` on train, a right-padded prefill and two decode steps (dense
    cache), logits within rel 1e-5 of the jitted reference's."""
    z = _ssm(arch)
    rng = np.random.default_rng(30)
    toks = rng.integers(1, z.cfg_t.vocab, (2, 24))
    lens = np.array([24, 15], np.int32)
    jp, tp = z.jtrees["fp"], z.ttrees["fp"]
    jl = jax.jit(lambda p, t: JM.apply(p, {"tokens": t}, z.cfg_j, mode="train")[0])(jp, toks)
    tl, _ = TM.apply(tp, {"tokens": torch.as_tensor(toks)}, z.cfg_t, mode="train")
    _close(tl, jl)
    jcache = JM.init_cache(z.cfg_j, 2, 32, jnp.float32)
    tcache = TM.init_cache(z.cfg_t, 2, 32, torch.float32, device="cpu")
    jpre =jax.jit(lambda p, t, c, cl: JM.apply(p, {"tokens": t}, z.cfg_j, mode="prefill",
                                                caches=c, cur_len=cl))
    jdec = jax.jit(lambda p, t, c, cl: JM.apply(p, {"tokens": t}, z.cfg_j, mode="decode",
                                                caches=c, cur_len=cl))
    jl, jex = jpre(jp, toks, jcache, lens)
    tl, _ = TM.apply(tp, {"tokens": torch.as_tensor(toks)}, z.cfg_t, mode="prefill",
                     caches=tcache, cur_len=torch.as_tensor(lens))
    _close(tl, jl)
    jcache = jex["caches"]
    nxt = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None]
    for i in range(2):
        jl, jex = jdec(jp, nxt, jcache, lens + i + 1)
        tl, _ = TM.apply(tp, {"tokens": torch.as_tensor(nxt)}, z.cfg_t, mode="decode",
                         caches=tcache, cur_len=torch.as_tensor(lens + i + 1))
        _close(tl, jl)
        jcache = jex["caches"]
        nxt = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_verify_and_chunked_modes_raise(arch):
    z = _ssm(arch)
    cache = TM.init_cache(z.cfg_t, 2, 16, torch.float32, device="cpu", layout="paged",
                          page_size=8)
    toks = torch.ones((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="speculative verify"):
        TM.apply(z.ttrees["fp"], {"tokens": toks}, z.cfg_t, mode="verify", caches=cache,
                 cur_len=torch.tensor([3, 3]), q_len=torch.tensor([3, 3]))
    chunk = {k: torch.zeros(2, dtype=torch.int32) for k in ("q_start", "q_len", "kv_len")}
    with pytest.raises(ValueError, match="chunked serving"):
        TM.apply(z.ttrees["fp"], {"tokens": toks[:1]}, z.cfg_t, mode="chunked",
                 caches=cache, chunk=chunk)


def test_hybrid_calibration_tables():
    """zamba2's observer names: /L{b}/S{i}/ssm/... stack onto blocks/{i}, the tail's
    /T{i}/ssm/... onto tail/{i}, and every application of the shared block
    observes into one /shared_attn/... and one /shared_mlp/... table, under the
    top-level ctx as the reference does. The port's tables from its own pass equal
    the reference's within rel 1e-5. The pass runs the fp ctx: observers cannot
    run under ``jax.jit``, and the reference's eager int8 pass differs from its
    jitted steps, which the port follows (ROADMAP queue C)."""
    z = _ssm("zamba2-1.2b")
    toks = np.random.default_rng(31).integers(1, z.cfg_t.vocab, (2, 20))
    jobs, tobs = jcal.Observer(), tcal.Observer()
    JM.apply(z.jtrees["fp"], {"tokens": jnp.asarray(toks)}, z.cfg_j,
             ctx=JQuantContext(jql.FP, observer=jobs), mode="train", unroll=True)
    TM.apply(z.ttrees["fp"], {"tokens": torch.as_tensor(toks)}, z.cfg_t,
             ctx=QuantContext(tql.FP, observer=tobs), mode="train", unroll=True)
    assert sorted(tobs.tables()) == sorted(jobs.tables())
    assert tobs.n_obs["/shared_attn/wq"] == z.cfg_t.n_layers // z.cfg_t.attn_every
    jt, tt = jcal.stack_tables(jobs.tables()), tcal.stack_tables(tobs.tables())
    assert sorted(jt) == sorted(tt)
    assert {"blocks/0/ssm/in_proj", "tail/0/ssm/out_proj", "shared_attn/attn/wq",
            "shared_attn/mlp/down"} <= set(tt)
    assert tt["blocks/1/ssm/in_proj"].shape == (z.cfg_t.n_layers // z.cfg_t.attn_every,
                                                z.cfg_t.d_model)
    for k in jt:
        np.testing.assert_allclose(tt[k], jt[k], rtol=1e-5, atol=1e-6)
