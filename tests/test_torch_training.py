"""The PyTorch port's training half against the JAX reference (CPU).

Smoke configs in float32 unless stated; params from
``repro.models.model.init_params`` carried across with ``convert``; batches are
numpy from a seed. The reference runs under ``jax.jit`` (its eager results
differ). Tolerances, relative to the largest magnitude of the reference's tensor:

* ``schedule``, ``global_norm``: rtol 1e-6; ``apply_updates`` (params, m, v) on the
  same grads and state: 1e-6 (torch's and XLA's f32 ``pow`` in ``b1**step`` part
  by an ulp).
* ``loss_fn`` values: rtol 1e-5; gradients per leaf: 2e-5 (starcoder2-7b,
  granite-moe with its aux loss, mamba2-130m); pixtral's vision mask and
  hubert's ``labels`` branch: the loss at rtol 1e-5.
* ``make_train_step`` at ``n_micro`` 1 and 2: the loss at rtol 1e-5, the grad
  norm at 1e-5, the first Adam moment per leaf at 2e-5 (the params are not
  compared: the first AdamW update is sign-like on near-zero gradients).
* remat on against off: bitwise in the port, values and gradients.
* compression (``_held``): ``none`` bitwise; ``per_tensor`` equal codes,
  ``crossquant`` (its scale takes ``pow``) codes one step apart on at most 1e-3
  of them; g_hat within 2 ulp where the codes agree; the error state exactly
  ``g + err - g_hat`` in the port; ``gradient_kernel_fractions`` per_tensor
  equal, crossquant within 2 elements.
* a QAT step under ``W8A8_CROSSQUANT`` (gradients through the scale's ``amax``
  and ``pow``): at α = 1 (no ``pow``) the first moment at 2e-5 per leaf; at
  α = 0.15 the loss at 1e-5 and the whole first moment within relative L2 2e-2
  (an ulp of ``pow`` moves a code; the test's docstring says why that shows).
* one bf16 step (the configs' default): per-token log-likelihoods, the loss and
  the first moment within e of the reference's bf16 step, e = the reference's
  own bf16-against-f32 gap (per token; over the first moment's leaves).
* the loss falls over 15 steps of the port alone (by 0.1 in the mean of 5).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import compression as JC, optimizer as JO, trainer as JT  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.data import make_train_batches  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.training import compression as TC, optimizer as TO, trainer as TT  # noqa: E402
from repro_torch.models.model import leaves  # noqa: E402

torch.set_num_threads(2)


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jget(arch, smoke=True), dtype=dtype, **kw),
            dataclasses.replace(tget(arch, smoke=True), dtype=dtype, **kw))


_RAW = {}


def _raw(arch, cfg_j):
    if arch not in _RAW:
        _RAW[arch] = jax.tree_util.tree_map(
            np.asarray, JM.init_params(jax.random.PRNGKey(0), cfg_j))
    return _RAW[arch]


def _torch_tree(np_tree):
    """A fresh port tree (the port's step updates its params in place)."""
    return convert.params_from_numpy(np_tree, device="cpu")


def _jleaves(tree):
    """Reference leaves as numpy, in the port's ``leaves`` order (sorted keys)."""
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = float(np.abs(want).max()) + 1e-30
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err} > {tol} (scale {scale})"
    return err


def _tokens(cfg, B=2, S=32, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


def _jgrad(cfg_j, raw, batch, quant=None):
    ctx = None if quant is None else JM.QuantContext(quant)
    f = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, cfg_j, ctx=ctx, remat=True), has_aux=True))
    (loss, metrics), grads = f(raw, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), metrics, _jleaves(grads)


def _tgrad(cfg_t, raw, batch, quant=None, remat=True):
    ctx = None if quant is None else TM.QuantContext(quant)
    loss, grads = TT._value_and_grad(
        lambda p, b: TM.loss_fn(p, b, cfg_t, ctx=ctx, remat=remat), _torch_tree(raw),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    return loss, grads


# ------------------------------------------------------------------------ optimizer

def test_schedule_and_global_norm():
    for cfg in (JO.AdamWConfig(), JO.AdamWConfig(lr=3e-3, warmup_steps=7, total_steps=40),
                JO.AdamWConfig(warmup_steps=0, total_steps=1)):
        tcfg = TO.AdamWConfig(**dataclasses.asdict(cfg))
        steps = np.arange(0, 60, dtype=np.int32)
        want = np.asarray(jax.jit(jax.vmap(lambda s: JO.schedule(cfg, s)))(steps))
        got = np.array([float(TO.schedule(tcfg, torch.tensor(int(s), dtype=torch.int32)))
                        for s in steps], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "b": [rng.normal(size=(3,)).astype(np.float32), rng.normal(size=(2, 2, 4))
                  .astype(np.float32)]}
    want = float(jax.jit(JO.global_norm)(tree))
    got = float(TO.global_norm(convert.params_from_numpy(tree, device="cpu")))
    assert abs(got - want) <= 1e-6 * want


def test_apply_updates_matches_reference():
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(16, 24)).astype(np.float32),
              "n": {"scale": rng.normal(size=(24,)).astype(np.float32)},
              "l": [rng.normal(size=(3, 8, 8)).astype(np.float32)]}
    mk = lambda s: jax.tree_util.tree_map(  # noqa: E731
        lambda p: (s * rng.normal(size=p.shape)).astype(np.float32), params)
    grads, m = mk(0.5), mk(0.1)
    v = jax.tree_util.tree_map(np.abs, mk(0.01))
    cfg = JO.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=0.5)
    jstate = JO.OptState(jnp.asarray(4, jnp.int32), m, v)
    jp, js, jm = jax.jit(lambda p, g, s: JO.apply_updates(p, g, s, cfg))(params, grads, jstate)
    T = lambda t: convert.params_from_numpy(t, device="cpu")  # noqa: E731
    tstate = TO.OptState(torch.tensor(4, dtype=torch.int32), T(m), T(v))
    tp, ts, tm = TO.apply_updates(T(params), T(grads), tstate,
                                  TO.AdamWConfig(**dataclasses.asdict(cfg)))
    assert int(ts.step) == int(js.step) == 5
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6 * float(jm["grad_norm"])
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
    for name, a, b in (("params", jp, tp), ("m", js.m, ts.m), ("v", js.v, ts.v)):
        for x, y in zip(_jleaves(a), leaves(b)):
            _close(y.numpy(), x, 1e-6, name)


# ------------------------------------------------------------------------ loss

@pytest.mark.parametrize("arch", ["starcoder2-7b", "granite-moe-3b-a800m", "mamba2-130m"])
def test_loss_and_grads_match_reference(arch):
    cfg_j, cfg_t = _cfgs(arch)
    raw = _raw(arch, cfg_j)
    batch = {"tokens": _tokens(cfg_j)}
    jl, jm, jg = _jgrad(cfg_j, raw, batch)
    tl, tg = _tgrad(cfg_t, raw, batch)
    assert abs(float(tl) - jl) <= 1e-5 * abs(jl)
    if cfg_j.n_experts:
        assert float(jm["aux"]) > 0
    tg = leaves(tg)
    assert len(tg) == len(jg)
    for a, b in zip(jg, tg):
        assert b.shape == a.shape
        _close(b.numpy(), a, 2e-5, arch)


def test_loss_mask_vision_and_encoder_labels():
    """pixtral's vision stub masks its n_patches positions (patch embeddings in the
    batch); hubert (encoder-only) reads ``labels``; a ``loss_mask`` multiplies in."""
    rng = np.random.default_rng(3)
    cfg_j, cfg_t = _cfgs("pixtral-12b")
    raw = _raw("pixtral-12b", cfg_j)
    batch = {"tokens": _tokens(cfg_j, S=cfg_j.n_patches + 16),
             "patch_embeds": rng.normal(size=(2, cfg_j.n_patches, cfg_j.frontend_dim))
             .astype(np.float32),
             "loss_mask": (rng.random((2, cfg_j.n_patches + 16)) < 0.8).astype(np.float32)}
    cfg_a, cfg_b = _cfgs("hubert-xlarge")
    raw_h = _raw("hubert-xlarge", cfg_a)
    batch_h = {"frames": rng.normal(size=(2, 24, cfg_a.frontend_dim)).astype(np.float32),
               "labels": rng.integers(0, cfg_a.vocab, size=(2, 24)).astype(np.int32)}
    for cj, ct, r, b in ((cfg_j, cfg_t, raw, batch), (cfg_a, cfg_b, raw_h, batch_h)):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        want, wm = jax.jit(lambda p, x: JM.loss_fn(p, x, cj, remat=False))(r, jb)
        got, gm = TM.loss_fn(_torch_tree(r), {k: torch.as_tensor(v) for k, v in b.items()},
                             ct, remat=False)
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want)), ct.name
        assert abs(float(gm["ppl"]) - float(wm["ppl"])) <= 1e-4 * float(wm["ppl"])


def test_remat_is_bitwise_in_the_port():
    for arch in ("starcoder2-7b", "granite-moe-3b-a800m", "zamba2-1.2b"):
        cfg_j, cfg_t = _cfgs(arch)
        raw = _raw(arch, cfg_j)
        batch = {"tokens": _tokens(cfg_j, seed=4)}
        l1, g1 = _tgrad(cfg_t, raw, batch, remat=True)
        l0, g0 = _tgrad(cfg_t, raw, batch, remat=False)
        assert torch.equal(l1, l0), arch
        for a, b in zip(leaves(g1), leaves(g0)):
            assert torch.equal(a, b), arch


# ------------------------------------------------------------------------ train step

def _steps(cfg_j, cfg_t, raw, batch, n_micro=1, quant=None, opt=None):
    opt = opt or JO.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=40)
    jstep = jax.jit(JT.make_train_step(cfg_j, opt, n_micro=n_micro, quant=quant))
    jp, js, jm = jstep(raw, JO.init(raw), {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = _torch_tree(raw)
    tstep = TT.make_train_step(cfg_t, TO.AdamWConfig(**dataclasses.asdict(opt)),
                               n_micro=n_micro, quant=None if quant is None
                               else tql.QuantConfig(**dataclasses.asdict(quant)))
    tp, ts, tm = tstep(tparams, TO.init(tparams), {k: torch.as_tensor(v)
                                                   for k, v in batch.items()})
    return (jm, js), (tm, ts)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(n_micro):
    cfg_j, cfg_t = _cfgs("starcoder2-7b")
    raw = _raw("starcoder2-7b", cfg_j)
    batch = {"tokens": _tokens(cfg_j, B=4, seed=5)}
    (jm, js), (tm, ts) = _steps(cfg_j, cfg_t, raw, batch, n_micro=n_micro)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5 * float(jm["grad_norm"])
    assert int(ts.step) == 1
    for a, b in zip(_jleaves(js.m), leaves(ts.m)):
        _close(b.numpy(), a, 2e-5, "m")


@pytest.mark.parametrize("alpha", [1.0, 0.15])
def test_qat_step_under_crossquant(alpha):
    """At α = 1 the scale takes no ``pow`` (t^1 · c^0) and the step agrees at 2e-5
    per leaf. At the paper's α = 0.15 torch's and XLA's ``pow`` part by an ulp on
    a few scales, which on this batch moves an activation code by one step; the
    gradient reaches a weight only through its scale's amax element, a sum of
    code × upstream terms that the flip shifts, so the bar is on the whole first
    moment: relative L2 error ≤ 2e-2 (7.4e-3 measured), the loss at 1e-5."""
    cfg_j, cfg_t = _cfgs("starcoder2-7b")
    raw = _raw("starcoder2-7b", cfg_j)
    batch = {"tokens": _tokens(cfg_j, B=2, seed=6)}
    quant = dataclasses.replace(jql.W8A8_CROSSQUANT, alpha=alpha)
    (jm, js), (tm, ts) = _steps(cfg_j, cfg_t, raw, batch, quant=quant)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    a = np.concatenate([x.ravel() for x in _jleaves(js.m)])
    b = np.concatenate([x.numpy().ravel() for x in leaves(ts.m)])
    if alpha == 1.0:
        for x, y in zip(_jleaves(js.m), leaves(ts.m)):
            _close(y.numpy(), x, 2e-5, "qat m")
    else:
        assert np.linalg.norm(b - a) <= 2e-2 * np.linalg.norm(a)


def _token_ll(apply, params, toks, cfg):
    """Per-token log-likelihood of the next token (the loss's terms)."""
    logits = np.asarray(apply(params, toks, cfg), np.float32)
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], 1)
    logp = logits - np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1, keepdims=True)) \
        - logits.max(-1, keepdims=True)
    return np.take_along_axis(logp, labels[..., None], -1)[..., 0][:, :-1]


def test_bf16_step_within_the_references_own_gap():
    """bf16 activations (the configs' default): e is what bf16 instead of f32 moves
    the reference itself. The port's per-token log-likelihoods and its loss lie
    within e_ll (the reference's largest per-token gap) of the reference's bf16
    step, its first moment within e_m (the reference's largest per-leaf gap,
    relative to the f32 leaf's max) on every leaf."""
    cfg_j, cfg_t = _cfgs("starcoder2-7b", dtype="bfloat16")
    cfg_jf = dataclasses.replace(cfg_j, dtype="float32")
    raw = _raw("starcoder2-7b", cfg_jf)
    toks = _tokens(cfg_j, B=2, seed=7)
    japply = lambda p, t, c: jax.jit(  # noqa: E731
        lambda p, t: JM.apply(p, {"tokens": t}, c, mode="train")[0])(p, jnp.asarray(t))
    with torch.no_grad():
        tapply = lambda p, t, c: TM.apply(  # noqa: E731
            _torch_tree(p), {"tokens": torch.as_tensor(t)}, c, mode="train")[0].numpy()
        ll_t = _token_ll(tapply, raw, toks, cfg_t)
    ll_b, ll_f = _token_ll(japply, raw, toks, cfg_j), _token_ll(japply, raw, toks, cfg_jf)
    e_ll = float(np.abs(ll_b - ll_f).max())
    assert 0 < e_ll and float(np.abs(ll_t - ll_b).max()) <= e_ll
    (jm, js), (tm, ts) = _steps(cfg_j, cfg_t, raw, {"tokens": toks})
    opt = JO.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=40)
    _, js32, _ = jax.jit(JT.make_train_step(cfg_jf, opt))(
        raw, JO.init(raw), {"tokens": jnp.asarray(toks)})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= e_ll
    ms = list(zip(_jleaves(js.m), _jleaves(js32.m), leaves(ts.m)))
    scale = [float(np.abs(a32).max()) + 1e-30 for _, a32, _ in ms]
    e_m = max(float(np.abs(a - a32).max()) / s for (a, a32, _), s in zip(ms, scale))
    for (a, _, b), s in zip(ms, scale):
        assert float(np.abs(b.numpy() - a).max()) / s <= e_m


def test_loss_falls_over_15_steps():
    cfg = tget("mamba2-130m", smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = TM.init_params(gen, cfg, device="cpu")
    step = TT.make_train_step(cfg, TO.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=40))
    opt = TO.init(params)
    batch_fn = make_train_batches(cfg.vocab, 32, 8, seed=0)
    losses = []
    for s in range(15):
        params, opt, m = step(params, opt, {"tokens": torch.as_tensor(batch_fn(s)["tokens"])})
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1 and losses[-1] < losses[0], losses


# ------------------------------------------------------------------------ compression

@pytest.mark.parametrize("scheme", ["crossquant", "per_tensor", "none"])
def test_compress_leaf_and_grads(scheme):
    rng = np.random.default_rng(8)
    g = (rng.standard_t(3, size=(48, 40)) * 1e-3).astype(np.float32)
    err = (rng.normal(size=(48, 40)) * 1e-5).astype(np.float32)
    jcfg = JC.CompressionConfig(scheme=scheme)
    tcfg = TC.CompressionConfig(scheme=scheme)
    jh, je = jax.jit(lambda a, b: JC.compress_leaf(a, b, jcfg))(g, err)
    th, te = TC.compress_leaf(torch.as_tensor(g), torch.as_tensor(err), tcfg)
    jh, je, th, te = np.asarray(jh), np.asarray(je), th.numpy(), te.numpy()
    _held(th, te, jh, je, g + err, tcfg)
    tree = {"w": g, "b": g[0], "l": [g.reshape(2, 24, 40)]}
    errs = jax.tree_util.tree_map(np.asarray, JC.init_error_state(tree))
    th_tree, te_tree = TC.compress_grads(
        convert.params_from_numpy(tree, device="cpu"),
        TC.init_error_state(convert.params_from_numpy(tree, device="cpu")), tcfg)
    jh_tree, je_tree = jax.jit(lambda a, b: JC.compress_grads(a, b, jcfg))(tree, errs)
    for x, a, b, c, d in zip(leaves(tree), _jleaves(jh_tree), _jleaves(je_tree),
                             leaves(th_tree), leaves(te_tree)):
        if x.ndim < 2:                                 # passes through uncompressed
            np.testing.assert_array_equal(c.numpy(), x)
            assert d.shape == b.shape == ()
        else:
            _held(c.numpy(), d.numpy(), a, b, x, tcfg)


def _held(th, te, jh, je, gf, tcfg):
    """g_hat and the error state against the reference's. ``none``: bitwise. Else
    every value is one code times the port's scale; the codes are the
    reference's except, under ``crossquant`` (whose scale takes ``pow``), one
    step apart on at most 1e-3 of them; the values agree within 2 ulp where the
    codes agree; the error state is exactly ``g + err - g_hat`` in the port and
    within one ulp of ``g + err`` plus the g_hat difference of the reference's
    (XLA contracts the residual into an FMA)."""
    if tcfg.scheme == "none":
        np.testing.assert_array_equal(th, jh)
        np.testing.assert_array_equal(te, je)
        return
    gf = np.asarray(gf, np.float32)
    scale = TC._grad_scale(torch.as_tensor(gf).reshape(-1, gf.shape[-1]), tcfg).numpy()
    scale = np.broadcast_to(scale, (gf.size // gf.shape[-1], gf.shape[-1])).reshape(gf.shape)
    codes_t, codes_j = np.round(th / scale), np.round(jh / scale)
    moved = codes_t != codes_j
    assert moved.mean() <= (1e-3 if tcfg.scheme == "crossquant" else 0)
    assert np.all(np.abs(codes_t - codes_j) <= 1)
    same = ~moved
    assert np.all(np.abs(th - jh)[same] <= 2 * np.spacing(np.abs(jh[same]).astype(np.float32)))
    np.testing.assert_array_equal(te, gf - th)
    assert np.all(np.abs(te - je)[same] <= (np.spacing(np.abs(gf)) + np.abs(th - jh))[same])


def test_gradient_kernel_fractions():
    g = (np.random.default_rng(9).standard_t(2, size=(96, 64)) * 1e-3).astype(np.float32)
    want = jax.jit(JC.gradient_kernel_fractions)(g)
    got = TC.gradient_kernel_fractions(torch.as_tensor(g))
    assert float(got["per_tensor"]) == float(want["per_tensor"])
    assert abs(float(got["crossquant"]) - float(want["crossquant"])) <= 2 / g.size
    assert float(got["crossquant"]) < float(got["per_tensor"])


def test_compressed_step_runs_with_error_state():
    cfg_j, cfg_t = _cfgs("mamba2-130m")
    params = _torch_tree(_raw("mamba2-130m", cfg_j))
    step = TT.make_train_step(cfg_t, TO.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=40),
                              compression=TC.CompressionConfig())
    opt, err = TO.init(params), TC.init_error_state(params)
    batch_fn = make_train_batches(cfg_t.vocab, 32, 4, seed=0)
    for s in range(2):
        params, opt, err, m = step(params, opt, err,
                                   {"tokens": torch.as_tensor(batch_fn(s)["tokens"])})
        assert np.isfinite(float(m["loss"]))
    assert any(float(e.abs().max()) > 0 for e in leaves(err))


def test_pick_n_micro_divides():
    cfg = tget("deepseek-coder-33b")
    for gb, dp in [(256, 16), (256, 32), (128, 16), (96, 16)]:
        nm = TT.pick_n_micro(cfg, gb, dp)
        assert gb % nm == 0 and nm == JT.pick_n_micro(jget("deepseek-coder-33b"), gb, dp)
