"""bf16 serving through the PyTorch port's ``ServeEngine`` against the JAX
reference's, on the CPU.

The configs default to ``dtype="bfloat16"``, and the card serves bf16 activations;
the other parity tests force float32 on both packages. Here both engines serve the
starcoder2-7b smoke config in bf16 on the fused-int8 path, over one ``W8A8_INT8``
tree carried across as numpy, on the dense and on the paged layout with fp KV.

bf16 rounds at other places in the two frameworks, so the bar calibrates itself
from the reference: ``e`` is how far bf16 instead of float32 moves the JAX
engine's logits on the first decode step (same tree, same tokens). The port's bf16
logits must lie within ``e`` (a factor of 1; the run prints the gap in units of e)
of the JAX engine's bf16 logits at every step both have fed the same tokens, and
their greedy tokens must be equal wherever the reference's top-1/top-2 margin
exceeds ``2e``. A step under that margin is named and its comparison skipped; if
the tokens part there, the request's later steps run on other tokens and are not
compared. At least one step must clear the margin.

The JAX engine runs its paged kernels through their jnp oracles
(``REPRO_KERNEL_EXEC=ref``), as tests/test_torch_paged.py does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.quantize import quantize_tree as j_quantize_tree  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.config import EngineConfig as JEngineConfig  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.config import EngineConfig  # noqa: E402

torch.set_num_threads(2)

LENS = [9, 13]                 # both prompts in one admission, each in its own slot
MAX_NEW = 8
MAX_LEN = 32
SAMPLERS = {JE: JE._make_sampler, TE: TE._make_sampler}


@pytest.fixture(scope="module")
def tree():
    """One W8A8 tree of the smoke config (f32 leaves), for both packages."""
    cfg = jget("starcoder2-7b", smoke=True)
    assert cfg.dtype == "bfloat16"
    qparams = j_quantize_tree(JM.init_params(jax.random.PRNGKey(0), cfg), jql.W8A8_INT8)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams),
                                        device="cpu")
    rng = np.random.default_rng(16)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32) for n in LENS]
    return qparams, tparams, prompts


def _recorder(module, monkeypatch, host):
    """Record the logits every sampler call of ``module``'s engine sees, in order:
    the admission's rows, then one (slots, vocab) array per decode step."""
    calls = []
    make = SAMPLERS[module]

    def recording(temperature, top_k):
        sample = make(temperature, top_k)

        def wrapped(logits, key):
            host(logits, calls)
            return sample(logits, key)

        return wrapped

    monkeypatch.setattr(module, "_make_sampler", recording)
    return calls


def _jax_host(logits, calls):
    jax.debug.callback(lambda l: calls.append(np.asarray(l, np.float32)), logits, ordered=True)


def _torch_host(logits, calls):
    calls.append(logits.detach().to(torch.float32).numpy().copy())


def _serve_j(dtype, layout, tree, monkeypatch):
    qparams, _, prompts = tree
    cfg = dataclasses.replace(jget("starcoder2-7b", smoke=True), dtype=dtype)
    calls = _recorder(JE, monkeypatch, _jax_host)
    eng = JE.ServeEngine(cfg, qparams, quant=jql.W8A8_INT8,
                         config=JEngineConfig(batch_size=2, max_len=MAX_LEN, path="fused-int8",
                                              kv_cache="fp", cache_layout=layout))
    eng.submit([p.copy() for p in prompts], max_new=MAX_NEW)
    done = eng.run()
    jax.effects_barrier()
    return [r.out for r in sorted(done, key=lambda r: r.rid)], calls


def _serve_t(layout, tree, monkeypatch):
    _, tparams, prompts = tree
    cfg = tget("starcoder2-7b", smoke=True)
    calls = _recorder(TE, monkeypatch, _torch_host)
    eng = TE.ServeEngine(cfg, tparams, quant=tql.W8A8_INT8, device="cpu",
                         config=EngineConfig(batch_size=2, max_len=MAX_LEN, path="fused-int8",
                                             kv_cache="fp", cache_layout=layout))
    eng.submit([p.copy() for p in prompts], max_new=MAX_NEW)
    return [r.out for r in sorted(eng.run(), key=lambda r: r.rid)], calls


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_bf16_serving_within_the_references_bf16_gap(tree, layout, monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_EXEC", "ref")
    j32_out, j32 = _serve_j("float32", layout, tree, monkeypatch)
    j16_out, j16 = _serve_j("bfloat16", layout, tree, monkeypatch)
    t16_out, t16 = _serve_t(layout, tree, monkeypatch)
    n_calls = 1 + (MAX_NEW - 1)                  # one admission, then the decode steps
    assert len(j32) == len(j16) == len(t16) == n_calls
    assert all(a.shape == b.shape == (len(LENS), a.shape[-1]) for a, b in zip(j16, t16))

    # e: bf16 instead of f32 on the reference's first decode step, where both fed the
    # admission's tokens
    assert [o[0] for o in j16_out] == [o[0] for o in j32_out], \
        "bf16 and f32 admissions chose different first tokens: e is undefined"
    e = float(np.abs(j16[1] - j32[1]).max())
    assert e > 0

    compared, skipped = 0, []
    for r in range(len(LENS)):
        for i in range(n_calls):
            # both engines fed this request the same tokens so far: call i is comparable
            np.testing.assert_array_less(np.abs(t16[i][r] - j16[i][r]).max(), e * (1 + 1e-6),
                                         err_msg=f"{layout}: request {r} step {i} logits")
            top2 = np.sort(j16[i][r])[-2:]
            if top2[1] - top2[0] > 2 * e:
                assert t16_out[r][i] == j16_out[r][i], (layout, r, i)
                compared += 1
            else:
                skipped.append((r, i, float(top2[1] - top2[0])))
                if t16_out[r][i] != j16_out[r][i]:
                    break                      # later steps run on other tokens
    worst = max(float(np.abs(t16[i][r] - j16[i][r]).max()) for r in range(len(LENS))
                for i in range(n_calls))
    print(f"{layout}: e={e:.4g}, max|port - reference| = {worst / e:.3f} e")
    if skipped:
        print(f"{layout}: (request, step, margin) under 2e, not compared: {skipped}")
    assert compared > 0, f"{layout}: no step's margin exceeds 2e = {2 * e:.4g}"
