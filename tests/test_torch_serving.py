"""Greedy serving through the PyTorch port's ``ServeEngine`` is token-exact against
the JAX reference ``ServeEngine`` on the same prepared tree (CPU).

fused-int8 path, dense continuous layout, fp and int8 KV: the mixed lengths and
``max_new`` of tests/test_continuous_batching.py at batch_size=2 (slots refill
mid-decode), plus one 130-token prompt at max_len=256 so the admission prefill
runs the flash-attention path on both sides. Also the plain ``ref`` integer path
(``path=None``) on the same tree, and fused-int8 on a calibrated tree, whose
``qalpha = 0.15`` puts a ``pow`` into every activation scale. The paged layout
and speculative decoding have their own files (test_torch_paged.py,
test_torch_speculative.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import calibration as jcal, qlinear as jql  # noqa: E402
from repro.data import make_train_batches  # noqa: E402
from repro.models.layers import QuantContext as JQuantContext  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.quantize import quantize_tree as j_quantize_tree  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.config import EngineConfig as JEngineConfig  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.config import EngineConfig, NotPortedError  # noqa: E402

torch.set_num_threads(2)

LENS = [4, 7, 12, 9, 5]                 # tests/test_continuous_batching.py:25-26
MAX_NEW = [5, 3, 6, 2, 4]


@pytest.fixture(scope="module")
def small():
    cfg_j = dataclasses.replace(jget("starcoder2-7b", smoke=True), dtype="float32")
    cfg_t = dataclasses.replace(tget("starcoder2-7b", smoke=True), dtype="float32")
    qparams = j_quantize_tree(JM.init_params(jax.random.PRNGKey(0), cfg_j), jql.W8A8_INT8)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams),
                                        device="cpu")
    return cfg_j, cfg_t, qparams, tparams


@pytest.fixture(scope="module")
def calibrated(small):
    """The reference's offline PTQ with one calibration batch (eager, per-layer
    observers; launch/serve.py's recipe), carried into the port as numpy."""
    cfg_j = small[0]
    params = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    obs = jcal.Observer()
    batch = make_train_batches(cfg_j.vocab, 16, 2, seed=1)(0)
    JM.apply(params, {k: jax.numpy.asarray(v) for k, v in batch.items()}, cfg_j,
             ctx=JQuantContext(jql.W8A8_INT8, observer=obs), mode="train", unroll=True)
    qparams = j_quantize_tree(params, jql.W8A8_INT8,
                              tables=jcal.stack_tables(obs.tables()))
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams),
                                        device="cpu")
    return small[0], small[1], qparams, tparams


def _serve_both(small, prompts, max_new, *, max_len, kv, path="fused-int8"):
    cfg_j, cfg_t, qparams, tparams = small
    jeng = JE.ServeEngine(cfg_j, qparams, quant=jql.W8A8_INT8,
                          config=JEngineConfig(batch_size=2, max_len=max_len,
                                               path=path, kv_cache=kv))
    jeng.submit(prompts, max_new=max_new)
    jdone = jeng.run()
    teng = TE.ServeEngine(cfg_t, tparams, quant=tql.W8A8_INT8, device="cpu",
                          config=EngineConfig(batch_size=2, max_len=max_len,
                                              path=path, kv_cache=kv))
    teng.submit(prompts, max_new=max_new)
    tdone = teng.run()
    return jeng, jdone, teng, tdone


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_mixed_workload_token_exact(small, kv):
    cfg_j = small[0]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg_j.vocab, size=n).astype(np.int32) for n in LENS]
    jeng, jdone, teng, tdone = _serve_both(small, prompts, MAX_NEW, max_len=32, kv=kv)
    assert teng.counters["mid_decode_admissions"] > 0
    for key in ("prefill_calls", "decode_steps", "active_slot_steps",
                "mid_decode_admissions", "prompt_tokens"):
        assert teng.counters[key] == jeng.counters[key], key
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for tr, jr in zip(tdone, jdone):
        assert tr.out == jr.out, (kv, tr.rid, tr.out, jr.out)
        assert tr.finish_reason.value == jr.finish_reason.value


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_flash_prefill_token_exact(small, kv):
    cfg_j = small[0]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg_j.vocab, size=n).astype(np.int32) for n in (130, 20)]
    _, jdone, _, tdone = _serve_both(small, prompts, [6, 4], max_len=256, kv=kv)
    for tr, jr in zip(tdone, jdone):
        assert tr.out == jr.out, (kv, tr.rid, tr.out, jr.out)


def test_ref_path_token_exact(small):
    """``path=None`` serves the int8 tree through the plain integer GEMM, whose
    activation scale is ``quantize_act_int8``: the reference runs it under jit
    (a multiply by 1/qmax), and so must the port to stay token-exact."""
    cfg_j = small[0]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg_j.vocab, size=n).astype(np.int32) for n in LENS]
    jeng, jdone, teng, tdone = _serve_both(small, prompts, MAX_NEW, max_len=32, kv="fp",
                                           path=None)
    assert [tr.out for tr in tdone] == [jr.out for jr in jdone]
    assert teng.counters["decode_steps"] == jeng.counters["decode_steps"]


def test_calibrated_tree_token_exact(calibrated):
    """A calibrated tree (qalpha = 0.15 < 1): every activation scale holds
    ``t**0.15``, where torch's and XLA's f32 ``pow`` differ by one ulp on a few
    percent of rows. The greedy tokens are equal all the same."""
    cfg_j, _, qparams, tparams = calibrated
    qalpha = np.asarray(qparams["blocks"][0]["attn"]["wq"]["qalpha"])
    assert (qalpha < 1.0).all()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg_j.vocab, size=n).astype(np.int32) for n in LENS]
    _, jdone, _, tdone = _serve_both(calibrated, prompts, MAX_NEW, max_len=32, kv="fp")
    for tr, jr in zip(tdone, jdone):
        assert tr.out == jr.out, (tr.rid, tr.out, jr.out)


def test_cpu_run_launches_no_kernel(small):
    """On the CPU every wrapper takes its plain version: the counters stay 0."""
    _, cfg_t, _, tparams = small
    tops.reset_launches()
    eng = TE.ServeEngine(cfg_t, tparams, quant=tql.W8A8_INT8, device="cpu",
                         config=EngineConfig(batch_size=2, max_len=32, path="fused-int8"))
    eng.submit([np.arange(1, 9, dtype=np.int32)], max_new=3)
    assert len(eng.run()[0].out) == 3
    assert all(n == 0 for n in tops.LAUNCHES.values())


def test_sampler_uses_the_callers_generator():
    """Temperature + top-k draws come from the explicit torch.Generator: a seed
    reproduces them, and every draw lies in the top-k set; top-k 1 is argmax."""
    logits = torch.randn(64, 50, generator=torch.Generator().manual_seed(0))
    top3 = torch.topk(logits, 3, dim=-1).indices
    sample = TE._make_sampler(0.7, 3)
    a = sample(logits, torch.Generator().manual_seed(11))
    b = sample(logits, torch.Generator().manual_seed(11))
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert bool((top3 == a[:, None].long()).any(dim=-1).all())
    greedy = TE._make_sampler(0.0, 0)(logits, torch.Generator())
    assert torch.equal(TE._make_sampler(0.7, 1)(logits, torch.Generator()), greedy)
    assert torch.equal(greedy, torch.argmax(logits, dim=-1).to(torch.int32))


def test_seeded_temperature_serving_is_reproducible(small):
    _, cfg_t, _, tparams = small
    outs = []
    for _ in range(2):
        eng = TE.ServeEngine(cfg_t, tparams, quant=tql.W8A8_INT8, device="cpu",
                             config=EngineConfig(batch_size=2, max_len=32, path="fused-int8",
                                                 temperature=0.9, top_k=5, seed=3))
        eng.submit([np.arange(1, 7, dtype=np.int32), np.arange(3, 12, dtype=np.int32)],
                   max_new=6)
        outs.append([r.out for r in eng.run()])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kw", [dict(scheduler="grouped"), dict(path="dequant-fp"),
                                dict(path="fake")])
def test_unported_configs_raise_typed(small, kw):
    """The three configurations this port once refused with ``NotPortedError`` now
    build and serve a request on the CPU (token parity: tests/test_torch_fake.py):
    the grouped scheduler and dequant-fp on the int8 tree, fake on the raw tree."""
    _, cfg_t, _, tparams = small
    if kw.get("path") == "fake":
        tree, quant = convert.params_from_numpy(jax.tree_util.tree_map(
            np.asarray, JM.init_params(jax.random.PRNGKey(0), small[0])),
            device="cpu"), tql.W8A8_CROSSQUANT
    else:
        tree, quant = tparams, tql.W8A8_INT8
    eng = TE.ServeEngine(cfg_t, tree, quant=quant, device="cpu",
                         config=EngineConfig(batch_size=2, max_len=32, **kw))
    eng.submit([np.arange(1, 8, dtype=np.int32)], max_new=3)
    done = eng.run()
    assert len(done) == 1 and len(done[0].out) == 3
    assert all(0 <= t < cfg_t.vocab for t in done[0].out)


def test_unported_family_raises():
    """The reference's typed rejections: on the SSM and hybrid families
    ``check_model`` raises ``SpeculativeStateError`` (speculate > 1),
    ``PrefixReuseStateError`` (paged with prefix_reuse) and ``ChunkedStateError``
    (chunked), all ``UnsupportedModelError`` and so ``ValueError``, under exactly
    the reference's conditions (the same type, or none, as the JAX config on
    every combination below). Every other family passes. The encoder-only
    hubert still raises ``NotPortedError``: a stated deviation (the reference
    admits it; here it runs through ``make_prefill_step``)."""
    from repro.serving import config as JC
    from repro_torch.serving import config as TC

    combos = [dict(), dict(speculate=4), dict(cache_layout="paged"),
              dict(cache_layout="paged", prefix_reuse=False),
              dict(cache_layout="paged", prefix_reuse=False, speculate=2),
              dict(cache_layout="paged", prefix_reuse=False, chunked=True),
              dict(cache_layout="paged", chunked=True, speculate=4),
              dict(cache_layout="paged", scheduler="continuous", chunked=True,
                   prefix_reuse=False, kv_cache="int8")]
    names = ("SpeculativeStateError", "PrefixReuseStateError", "ChunkedStateError")
    for n in names:
        assert issubclass(getattr(TC, n), TC.UnsupportedModelError)
    assert issubclass(TC.UnsupportedModelError, ValueError)
    raised = set()
    for arch in ("mamba2-130m", "zamba2-1.2b", "granite-moe-3b-a800m", "starcoder2-7b"):
        for kw in combos:
            def outcome(mod, get):
                try:
                    mod.EngineConfig(batch_size=2, max_len=32, **kw).check_model(
                        get(arch, smoke=True))
                except mod.UnsupportedModelError as e:
                    return type(e).__name__
                return None
            got = outcome(TC, tget)
            assert got == outcome(JC, jget), (arch, kw, got)
            raised.add(got)
    assert raised == {None, *names}
    with pytest.raises(NotPortedError, match="make_prefill_step"):
        EngineConfig(batch_size=2, max_len=32).check_model(tget("hubert-xlarge", smoke=True))
