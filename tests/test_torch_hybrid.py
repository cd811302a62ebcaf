"""SSM and hybrid serving in the PyTorch port against the JAX engine (CPU).

mamba2-130m and zamba2-1.2b smoke configs in float32, params from
``repro.models.model.init_params`` carried across with ``convert``; the JAX
engine runs its paged kernels through their jnp oracles
(``REPRO_KERNEL_EXEC=ref``). Each case serves the same three requests through
two slots, so the third is admitted mid-decode into the slot the first one
retired from, and the greedy tokens must equal the JAX engine's:

* fused-int8 on the dense and the paged layout (``prefix_reuse=False``), each
  with fp and int8 KV (mamba2 has no KV: its paged cache is the ``state_table``
  and its state pools only);
* ``fake`` W8A8 CrossQuant and ``dequant-fp`` on dense fp KV;
* fused-int8 dense on a calibrated tree (seeded column tables with outlier
  columns under the names calibration gives the stacked blocks, zamba2's tail
  and its shared block: α = 0.15 on every in/out projection).

The paged engine takes one state page per slot from the same pool as the KV
pages and frees it with them on retirement: its page counters equal the JAX
engine's at every step. ``check_model``'s typed rejections are held in
tests/test_torch_serving.py.
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

ARCHS = ("mamba2-130m", "zamba2-1.2b")
T = 64                                        # cache length of every engine here
LENS, MAX_NEW = [6, 11, 9], [4, 3, 5]
PAGE_COUNTERS = ("peak_pages_in_use", "kv_pages_in_use", "state_pages_in_use",
                 "peak_kv_pages_in_use", "peak_state_pages_in_use")

_TREES = {}


def _trees(arch: str):
    """(cfg_j, cfg_t, {"fp", "int8", "int8c"} JAX trees, the same as torch trees)."""
    if arch not in _TREES:
        cfg_j = dataclasses.replace(jget(arch, smoke=True), dtype="float32")
        cfg_t = dataclasses.replace(tget(arch, smoke=True), dtype="float32")
        raw = JM.init_params(jax.random.PRNGKey(0), cfg_j)
        jtrees = {"fp": raw, "int8": j_quantize_tree(raw, jql.W8A8_INT8),
                  "int8c": j_quantize_tree(raw, jql.W8A8_INT8, tables=_tables(raw))}
        ttrees = {k: convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, v),
                                               device="cpu") for k, v in jtrees.items()}
        _TREES[arch] = (cfg_j, cfg_t, jtrees, ttrees)
    return _TREES[arch]


def _tables(raw, seed=1):
    """Seeded positive column-absmax tables with outlier columns, one per
    quantizable linear of ``raw`` under its parameter path (stacked (L, d_in)
    under ``blocks``, (d_in,) under ``tail`` and ``shared_attn``): what
    ``quantize_tree`` reads after a calibration pass."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, w in jax.tree_util.tree_leaves_with_path(raw):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[-1] != "w" or keys[0] in ("embed", "lm_head"):
            continue
        t = rng.random(w.shape[:-1]).astype(np.float32) * 2 + 0.05
        t[..., rng.integers(0, w.shape[-2], 3)] *= 20
        out["/".join(keys[:-1])] = t
    return out


@pytest.fixture
def jax_ref_exec(monkeypatch):
    """The JAX engine's paged kernels run their jnp oracles, not interpret mode."""
    monkeypatch.setenv("REPRO_KERNEL_EXEC", "ref")


def _prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in LENS]


PAGED = dict(cache_layout="paged", page_size=4, prefix_reuse=False)
CASES = {
    "dense-fp": ("int8", "fused-int8", {"kv_cache": "fp"}),
    "dense-int8kv": ("int8", "fused-int8", {"kv_cache": "int8"}),
    "paged-fp": ("int8", "fused-int8", {"kv_cache": "fp", **PAGED}),
    "paged-int8kv": ("int8", "fused-int8", {"kv_cache": "int8", **PAGED}),
    "fake": ("fp", "fake", {}),
    "dequant-fp": ("int8", "dequant-fp", {}),
    "dense-calibrated": ("int8c", "fused-int8", {"kv_cache": "fp"}),
}
QUANTS = {"fake": (jql.W8A8_CROSSQUANT, tql.W8A8_CROSSQUANT)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_serving_token_exact(jax_ref_exec, arch, case):
    cfg_j, cfg_t, jtrees, ttrees = _trees(arch)
    tree, path, kw = CASES[case]
    qj, qt = QUANTS.get(path, (jql.W8A8_INT8, tql.W8A8_INT8))
    prompts = _prompts(cfg_t.vocab, seed=ARCHS.index(arch) * 10 + len(case))
    jeng = JE.ServeEngine(cfg_j, jtrees[tree], quant=qj,
                          config=JEngineConfig(batch_size=2, max_len=T, path=path, **kw))
    teng = TE.ServeEngine(cfg_t, ttrees[tree], quant=qt, device="cpu",
                          config=EngineConfig(batch_size=2, max_len=T, path=path, **kw))
    if tree != "fp":
        # the served in_proj (N = 296, off the 16-column grid) keeps its shape and
        # values at a row pitch of 304, the view K2's decode and wgmma bodies take
        proj = teng.params["blocks"][0]["ssm"]["in_proj"]["qw"]
        raw = ttrees[tree]["blocks"][0]["ssm"]["in_proj"]["qw"]
        assert proj.shape[-1] == 296 and proj.stride()[-2:] == (304, 1)
        assert torch.equal(proj, raw)
    for eng in (jeng, teng):
        eng.submit([p.copy() for p in prompts], max_new=MAX_NEW)
    jdone, tdone = [], []
    jgo = tgo = True
    while jgo or tgo:                 # lock-step, so the page counters compare each step
        jgo = jeng.step(jdone) if jgo else False
        tgo = teng.step(tdone) if tgo else False
        if teng.paged:
            assert {k: teng.counters[k] for k in PAGE_COUNTERS} == \
                {k: jeng.counters[k] for k in PAGE_COUNTERS}
    jdone, tdone = sorted(jdone, key=lambda r: r.rid), sorted(tdone, key=lambda r: r.rid)
    assert [r.rid for r in tdone] == [r.rid for r in jdone] == [0, 1, 2]
    for tr, jr in zip(tdone, jdone):
        assert tr.out == jr.out, (tr.rid, tr.out, jr.out)
    assert teng.counters["mid_decode_admissions"] == jeng.counters["mid_decode_admissions"] > 0
    if teng.paged:
        c = teng.counters
        assert teng.radix is None and ("page_table" in teng.caches) == (arch != "mamba2-130m")
        # one state page per live slot, all freed with the KV pages at retirement
        assert c["peak_state_pages_in_use"] == 2 and c["state_pages_in_use"] == 0
        assert teng.pool.used_count == 0 and c["kv_pages_in_use"] == 0
        assert (teng._state_table == teng.n_pages).all()
