"""Serving engine: admission/decode/verify step builders and the slot-table
continuous batcher (port of ``repro/serving/engine.py``, dense and paged layouts,
with speculative decoding), and the grouped baseline scheduler.

``ServeEngine`` keeps a fixed slot table of ``batch_size`` sequences with per-slot
lengths. Requests are admitted into free slots mid-decode through length-bucketed
padded prefill (power-of-two length buckets from 8, power-of-two row buckets,
sentinel slot ``B`` on padding rows); finished requests retire and free their
slot at once. Decode advances every slot in lock-step and samples on the device,
so the host loop moves only int token ids. PyTorch runs eagerly, so the steps
are plain functions and the one live cache is updated in place (the reference
jit-compiles them and donates the cache).

``cache_layout="paged"`` swaps the dense per-slot rows for a physical page pool
addressed through a page table, with a host-side ref-counted allocator and a
radix index over prompt chunks (:mod:`repro_torch.serving.paging`). Previously
prefilled prefixes map into new requests copy-free (int8 codes and scales are
deterministic, so int8 pages share bit-exactly), partial tail pages copy on
write, only the suffix prefills, and unreferenced cached prefixes evict LRU
under pool pressure. ``speculate=k`` turns each decode step into a k-token
verify step over drafts from :mod:`repro_torch.serving.drafter`, token-exact
against ``speculate=1`` by greedy acceptance.

``chunked=True`` (paged only) serves each step as one packed ragged token row of
at most ``token_budget`` tokens: every generating slot's decode row (or draft
window) first, then prefill chunks of admitted prompts, FIFO, ending on page
boundaries where they can, so an admission never stalls the decodes behind a
whole-prompt prefill. ``sparsity="2:4"|"4:8"`` prunes the served tree to N:M at
engine build. ``scheduler="grouped"`` is the legacy baseline: whole-batch groups
of one exact prompt length, drained before the next group is admitted.

Under fake quantization an activation's dynamic statistics (CrossQuant's column
max, SmoothQuant's and AWQ's columns, the remove-kernel quantile) reduce over
every token row of a step, padding rows and idle slots included, so each step
hands the model the rows the reference's engine does, padded the same way. The
same holds under ``mode="int8"`` for a linear whose fp weights are prepared on the
fly (an untied ``lm_head``, or any unprepared leaf): its column max is this
step's. In a mixture of experts the rows are coupled under every path: the
experts' capacity and the set of dropped (token, k) pairs depend on the step's
row count.

:func:`make_prefill_step` and :func:`make_decode_step` are the reference's raw
step builders; for an encoder-only model the prefill step is the serving entry
(its logits, no cache).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import qlinear as ql
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models import quantize as MQ
from repro_torch.models import state as state_lib
from repro_torch.models.layers import QuantContext
from repro_torch.serving import drafter, paging
from repro_torch.serving.api import FinishReason
from repro_torch.serving.config import CACHE_DTYPES, SERVE_PATHS, EngineConfig, EngineStats
from repro_torch.sharding.collectives import exchange_pages


def _make_ctx(cfg: ModelConfig, quant: Optional[ql.QuantConfig],
              path: Optional[str], shard=None) -> QuantContext:
    if path not in SERVE_PATHS:
        raise ValueError(f"unknown serving path {path!r}; "
                         f"pick one of {sorted(k for k in SERVE_PATHS if k)}")
    return QuantContext(quant or cfg.quant, shard=shard, **SERVE_PATHS[path])


def _make_sampler(temperature: float, top_k: int):
    """On-device sampler: greedy at temperature 0 (argmax; ties to the first
    index, as jnp.argmax), else temperature + top-k drawn with the caller's
    ``torch.Generator``. Padded vocab ids carry -1e9 logits and are never drawn."""

    def sample(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        scaled = logits / temperature
        if top_k and top_k > 0:
            kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
            scaled = torch.where(scaled < kth, torch.full_like(scaled, float("-inf")), scaled)
        probs = torch.softmax(scaled, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[..., 0].to(torch.int32)

    return sample


def _sampler(temperature: float, top_k: int, shard=None):
    """:func:`_make_sampler`'s sampler; sharded (``shard``), every rank holds the
    same gathered logits, so greedy tokens agree, and a random draw is rank 0's,
    broadcast to the others."""
    sample = _make_sampler(temperature, top_k)
    if shard is None or temperature <= 0.0:
        return sample

    def sample_rank0(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        return shard.coll.broadcast(sample(logits, gen), shard.coll.mesh.axis_names)

    return sample_rank0


def make_prefill_step(cfg: ModelConfig, quant: Optional[ql.QuantConfig] = None, *,
                      path: Optional[str] = None):
    ctx = _make_ctx(cfg, quant, path)

    def prefill_step(params, batch, caches):
        """batch["tokens"] (B, S) right-padded prompts (or ``frames`` (B, S,
        frontend_dim) for an audio model) → (last-valid-position logits (B, 1, V),
        filled caches). An optional batch["lens"] (B,) gives per-slot prompt
        lengths (absent: every slot is S long). An encoder-only model runs
        ``mode="train"`` and returns its last-position logits with ``caches``
        unchanged."""
        S = batch["frames"].shape[1] if "frames" in batch else batch["tokens"].shape[1]
        if not cfg.causal:
            logits, _ = M.apply(params, batch, cfg, ctx=ctx, mode="train")
            return logits[:, -1:], caches
        lens = batch.get("lens")
        logits, ex = M.apply(params, batch, cfg, ctx=ctx, mode="prefill", caches=caches,
                             cur_len=S if lens is None else lens)
        return logits, ex["caches"]

    return prefill_step


def make_decode_step(cfg: ModelConfig, quant: Optional[ql.QuantConfig] = None, *,
                     path: Optional[str] = None):
    ctx = _make_ctx(cfg, quant, path)

    def decode_step(params, tokens, caches, cur_len):
        """tokens (B, 1) + caches + cur_len (scalar or (B,) per-slot post-append
        lengths) → (logits (B, 1, V), caches updated in place)."""
        logits, ex = M.apply(params, {"tokens": tokens}, cfg, ctx=ctx, mode="decode",
                             caches=caches, cur_len=cur_len)
        return logits, ex["caches"]

    return decode_step


def _rows_coupled(params, quant: ql.QuantConfig, cfg: Optional[ModelConfig] = None) -> bool:
    """Whether a step's token rows share a dynamic statistic: every MoE step (its
    capacity and drop set count the step's rows, padding and idle slots
    included), every linear under fake quantization, and under ``mode="int8"``
    any linear (``lm_head`` or a quantizable parent) still holding fp weights
    without a static ``cmax``, which is prepared on the fly with the column max
    of the step's rows."""
    if (cfg is not None and cfg.family == "moe") or quant.mode == "fake":
        return True
    if quant.mode != "int8":
        return False

    def dynamic(node, name: str) -> bool:
        if isinstance(node, dict):
            if (name in MQ.QUANTIZABLE_PARENTS or name == "lm_head") and "w" in node:
                return "cmax" not in node
            return any(dynamic(v, k) for k, v in node.items())
        if isinstance(node, list):
            return any(dynamic(v, name) for v in node)
        return False

    return dynamic(params, "")


def _head_rows(shard, take: Optional[torch.Tensor]):
    """An admission's ``head_rows``: None, or under data-parallel slots (``take``)
    every data rank's last hidden rows, gathered in rank order and taken in the
    whole admission batch's row order."""
    if take is None:
        return None
    return lambda x: shard.coll.gather_slots(x, shard.plan.dp_axes)[take]


def _rows_of(a: np.ndarray, mine: np.ndarray, R: int, fill) -> np.ndarray:
    """``a``'s rows ``mine``, padded with ``fill`` to ``R`` rows."""
    return np.concatenate([a[mine], np.full((R - len(mine),) + a.shape[1:], fill, a.dtype)])


def _slot_groups(caches: dict):
    """(slot axis, leaf dicts) of a cache: the stacked ``blocks`` and a hybrid's
    ``shared`` attention hold (n_blocks, B, ...) leaves, slot axis 1; a hybrid's
    unstacked ``tail`` holds (B, ...) leaves, slot axis 0."""
    yield from ((1, leaves) for leaves in caches["blocks"])
    yield from ((0, leaves) for leaves in caches.get("tail", []))
    if "shared" in caches:
        yield 1, caches["shared"]


def _slot_scatter(live: dict, new: dict, slots: torch.Tensor) -> dict:
    """Write the Bp-batched rows of ``new`` into the live slot table at ``slots``
    (Bp,), along each leaf's slot axis. Sentinel indices ≥ B (padding rows of the
    admission batch) are dropped; every other slot's rows are untouched. In place;
    returns live."""
    route = None
    for (axis, live_leaves), (_, new_leaves) in zip(_slot_groups(live), _slot_groups(new)):
        if route is None:
            B = next(iter(live_leaves.values())).shape[axis]
            keep = slots < B
            route = torch.nonzero(keep).reshape(-1), slots[keep].to(torch.int64)
        src, dst = route
        for name, leaf in live_leaves.items():
            if axis:
                leaf[:, dst] = new_leaves[name][:, src]
            else:
                leaf[dst] = new_leaves[name][src]
    return live


def make_admit_step(cfg: ModelConfig, quant: Optional[ql.QuantConfig] = None, *,
                    path: Optional[str] = None, temperature: float = 0.0, top_k: int = 0,
                    shard=None):
    """Padded prefill of newly admitted requests into a live slot table: the
    (Bp, S_bucket) admission batch prefills against a fresh zero cache, whose rows
    then scatter into the live table at the admitted slots. Mid-decode slots are
    never touched."""
    ctx = _make_ctx(cfg, quant, path, shard)
    sample = _sampler(temperature, top_k, shard)

    def admit_step(params, tokens, lens, slots, caches, gen, take=None):
        """tokens (Bp, S) right-padded; lens (Bp,) prompt lengths; slots (Bp,)
        target slot per row (≥ B ⇒ padding row). Returns (first sampled token
        (Bp,) int32, caches with the admitted slots' rows replaced). Data-parallel
        slots (``take``): the rows are this data rank's share of the admission
        batch; the last-position logits are gathered over the data axes and
        ``take`` orders them back into the whole batch's rows before the head."""
        Bp = tokens.shape[0]

        def zeros(leaves, axis):
            return {k: torch.zeros(x.shape[:axis] + (Bp,) + x.shape[axis + 1:],
                                   dtype=x.dtype, device=x.device) for k, x in leaves.items()}

        fresh = {"blocks": [zeros(leaves, 1) for leaves in caches["blocks"]]}
        if "tail" in caches:
            fresh["tail"] = [zeros(leaves, 0) for leaves in caches["tail"]]
        if "shared" in caches:
            fresh["shared"] = zeros(caches["shared"], 1)
        logits, ex = M.apply(params, {"tokens": tokens}, cfg, ctx=ctx, mode="prefill",
                             caches=fresh, cur_len=lens, head_rows=_head_rows(shard, take))
        merged = _slot_scatter(caches, ex["caches"], slots)
        return sample(logits[:, -1], gen), merged

    return admit_step


def make_paged_admit_step(cfg: ModelConfig, quant: Optional[ql.QuantConfig] = None, *,
                          path: Optional[str] = None, temperature: float = 0.0,
                          top_k: int = 0, warm: bool = False, shard=None):
    """Admission prefill straight into the live page pool: each admitted row
    writes K/V through its own page table into pages the allocator handed it
    exclusively, so no scatter-merge is needed. ``warm=False`` is the cold path
    (plain right-padded prefill attention, the dense layout's numerics);
    ``warm=True`` the shared-prefix path, whose rows are prompt suffixes after
    ``prefix`` tokens already in the mapped pages."""
    ctx = _make_ctx(cfg, quant, path, shard)
    sample = _sampler(temperature, top_k, shard)

    def admit_step(params, tokens, lens, prefix, row_tables, row_states, caches, gen,
                   take=None):
        """tokens (Bp, S) right-padded suffixes; lens (Bp,) suffix lengths; prefix
        (Bp,) shared-prefix lengths (unused when cold); row_tables (Bp, maxP) the
        admitted rows' page tables and row_states (Bp,) their state-page ids
        (sentinel-filled padding rows write nowhere; each is used only where the
        cache carries its routing table). Returns (first sampled token (Bp,)
        int32, caches with the live tables). ``take``: as the dense admission's."""
        c = dict(caches)
        if "page_table" in c:
            c["page_table"] = row_tables
        if "state_table" in c:
            c["state_table"] = row_states
        logits, _ = M.apply(params, {"tokens": tokens}, cfg, ctx=ctx, mode="prefill",
                            caches=c, cur_len=lens, prefix_len=prefix if warm else None,
                            head_rows=_head_rows(shard, take))
        exchange_pages(shard)
        return sample(logits[:, -1], gen), caches

    return admit_step


def _page_copy(caches: dict, src: int, dst: int, n_tok: int) -> dict:
    """Copy-on-write of a partially shared tail page: the first ``n_tok`` token rows
    of physical page ``src`` go into the freshly allocated ``dst`` in every layer's
    pools (codes and int8 scale pages alike); rows ≥ n_tok stay zero, as a cold
    prefill leaves them before writing the suffix. In place; returns caches."""
    for leaves in caches["blocks"]:
        for leaf in leaves.values():                # (n_blocks, P, ps, Hkv, D|1)
            leaf[:, dst] = 0
            leaf[:, dst, :n_tok] = leaf[:, src, :n_tok]
    return caches


def make_serve_decode_step(cfg: ModelConfig, quant: Optional[ql.QuantConfig] = None, *,
                           path: Optional[str] = None, temperature: float = 0.0,
                           top_k: int = 0, shard=None):
    """One decode step: model forward + on-device sampling → token ids only."""
    ctx = _make_ctx(cfg, quant, path, shard)
    sample = _sampler(temperature, top_k, shard)

    def decode_step(params, tokens, caches, cur_len, gen):
        """tokens (B,) int pending inputs; cur_len (B,) post-append lengths →
        (next token (B,) int32, caches updated in place). Data-parallel slots: the
        inputs and caches are this data rank's slots, the final hidden rows are
        gathered in slot order and every slot's logits computed and sampled."""
        rows = None
        if shard is not None and shard.dp > 1:
            rows = lambda x: shard.coll.gather_slots(x, shard.plan.dp_axes)  # noqa: E731
        logits, ex = M.apply(params, {"tokens": tokens[:, None]}, cfg, ctx=ctx,
                             mode="decode", caches=caches, cur_len=cur_len, head_rows=rows)
        exchange_pages(shard)
        return sample(logits[:, -1], gen), ex["caches"]

    return decode_step


def make_serve_verify_step(cfg: ModelConfig, quant: Optional[ql.QuantConfig] = None, *,
                           path: Optional[str] = None, shard=None):
    """One speculative verify step: score a (B, W) draft window (column 0 each
    slot's pending token, the rest its drafted continuation) in one forward pass
    and argmax every window position on the device. Greedy only: the acceptance
    rule is token-exact only under deterministic sampling."""
    ctx = _make_ctx(cfg, quant, path, shard)

    def verify_step(params, tokens, caches, cur_len, q_len):
        """tokens (B, W) draft windows; cur_len (B,) total post-scatter lengths;
        q_len (B,) valid window rows (shorter windows right-pad; their tail rows
        write nowhere) → (greedy samples (B, W) int32, where position i samples
        the token after window token i; caches updated in place)."""
        logits, ex = M.apply(params, {"tokens": tokens}, cfg, ctx=ctx, mode="verify",
                             caches=caches, cur_len=cur_len, q_len=q_len)
        return torch.argmax(logits, dim=-1).to(torch.int32), ex["caches"]

    return verify_step


def make_chunked_step(cfg: ModelConfig, quant: Optional[ql.QuantConfig] = None, *,
                      path: Optional[str] = None, temperature: float = 0.0, top_k: int = 0,
                      shard=None):
    """One mixed-budget step: a packed ragged token row (decode tokens, draft
    windows and prefill chunks of many slots side by side) in one
    ``mode="chunked"`` forward pass. Returns each slot's sampled token (from its
    last valid packed row) and every row's greedy argmax (the speculative
    acceptance stream)."""
    ctx = _make_ctx(cfg, quant, path, shard)
    sample = _sampler(temperature, top_k, shard)

    def chunked_step(params, tokens, q_start, q_len, kv_len, positions, slot_ids, caches,
                     gen):
        """tokens (1, Nt) packed row; q_start/q_len/kv_len (B,) per-slot chunk
        extents (q_len == 0: the slot is idle this step); positions/slot_ids
        (Nt,) per-token routing (slot_ids == B: padding row, scatters nowhere)
        → (sampled next token (B,) int32, per-row argmax (Nt,) int32, caches
        updated in place)."""
        chunk = {"q_start": q_start, "q_len": q_len, "kv_len": kv_len,
                 "positions": positions, "slot_ids": slot_ids}
        logits, ex = M.apply(params, {"tokens": tokens}, cfg, ctx=ctx, mode="chunked",
                             caches=caches, chunk=chunk)
        last = torch.clamp(q_start + torch.clamp_min(q_len, 1) - 1, 0,
                           logits.shape[1] - 1).to(torch.int64)
        tok = sample(logits[0, last], gen)
        rowmax = torch.argmax(logits[0], dim=-1).to(torch.int32)
        return tok, rowmax, ex["caches"]

    return chunked_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (len,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[FinishReason] = None
    prefix_reused: int = 0        # radix hit length (prompt tokens)


def default_buckets(max_len: int, lo: int = 8) -> List[int]:
    """Power-of-two padded-prefill lengths up to the cache size: [8, 16, ..., T]."""
    out, b = [], lo
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


def _first_float_dtype(tree) -> Optional[torch.dtype]:
    """dtype of the first floating leaf in the reference's pytree order (dict keys
    sorted, lists in order) — the reference engine's fp KV-cache dtype rule."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            dt = _first_float_dtype(tree[k])
            if dt is not None:
                return dt
        return None
    if isinstance(tree, list):
        for v in tree:
            dt = _first_float_dtype(v)
            if dt is not None:
                return dt
        return None
    return tree.dtype if tree.is_floating_point() else None


def _first_tensor(tree) -> torch.Tensor:
    if isinstance(tree, dict):
        return _first_tensor(next(iter(tree.values())))
    if isinstance(tree, list):
        return _first_tensor(tree[0])
    return tree


class ServeEngine:
    """Continuous batcher over a fixed-size slot table.

    ``device`` is where the params live and the engine runs ("cuda" by
    default; "cpu" runs every kernel's plain version). ``eos_id=None`` disables
    EOS termination (token 0 is the pad token). The fp KV cache takes
    ``config.cache_dtype``, or else the dtype of the params tree's first floating
    leaf, as the reference does.

    ``cache_layout="paged"``: a ref-counted page pool of ``n_pages`` pages of
    ``page_size`` tokens (default: the dense-equivalent ``batch_size · max_len /
    page_size``), a page table per slot and, with ``prefix_reuse``, a radix index
    that maps cached prompt prefixes into new requests copy-free. Each admission
    reserves its worst-case page count up front, so decode never allocates.

    ``speculate=k``: each decode step verifies a window of the pending token plus
    up to k-1 drafted tokens in one pass and keeps the longest prefix the model
    agrees with, so the output equals ``speculate=1`` token for token.

    ``chunked=True``: admission plans pages as the paged layout does but runs no
    prefill; the admitted slot's prompt is served chunk by chunk from each step's
    leftover token budget, and its pages join the radix index at the final chunk.
    A packed step launches only its live rows (at most ``token_budget``; all of
    them where the rows are coupled, as the reference does: in a mixture of
    experts, under fake quantization, or a linear prepared on the fly). A step
    with no prefill work, fp KV and ``speculate == 1`` runs the lean decode step
    (K4) instead of the packed launch (K6); their q_len == 1 numerics are the
    same, so tokens do not depend on the branch. int8 KV and speculative chunked
    serving stay on the packed launch, as in the reference.

    ``sparsity``: the quantizable linears of the tree are pruned to N:M at build
    (``sparsify_tree``): those ``sparsity_plan`` lists
    (``models.quantize.make_sparsity_plan``), or every one without a plan.
    Prepared int8 leaves gain a packed ``mask`` the fused path's sparse GEMM
    reads, and leaves that already carry one pass through.
    Every masked leaf's tile occupancy is derived at build
    (``with_tile_occupancy``): masks with empty tiles run K7, the rest K2.

    ``mesh=`` (a ``launch.mesh.Mesh``; ``plan=`` defaults to
    ``sharding.planner.make_serve_plan``) serves tensor- and expert-parallel, one
    process per rank (SPMD): every rank builds this engine from the same full
    ``params`` and the same config, keeps its shard of the tree (its
    ``sharding.planner.param_placements``; the masks' occupancy rebuilt per
    shard) and caches of its kv heads, and runs the same deterministic host
    scheduling, so the ranks take the same decisions. The model runs the
    rank's shard with the collectives of ``sharding.collectives`` (``self.shard``);
    every rank holds the gathered logits, and a random draw is rank 0's,
    broadcast. Greedy fused-int8 serving gives the single-device engine's logits
    bitwise on the CPU, and on a card wherever kernels carry the attention (the
    dense layout's decode attention is plain torch, whose cuBLAS products may
    round a rank's fewer heads differently); fake and dequant-fp sum f32
    partials and are token-exact. W4A8 row-parallel linears gather K8's per-group
    partials (bitwise the single device's plain product on the CPU); expert-internal
    TP (``expert_tp``) splits each expert's d_ff_expert; SSM and hybrid families
    split their state heads (``models.ssm``).

    A data axis (the plan's ``dp_axes``, of ``dp`` ranks) splits the slot table
    into ``dp`` contiguous groups where B divides dp: each data rank runs the model
    on its own slots' rows (decode, and its share of each admission batch) and
    keeps their dense cache rows, and the final hidden rows are gathered over the
    data axes in slot order before the head, so every rank computes and samples
    the whole batch's logits as one device does (the head's product over all B
    rows, the single device's rounding). The paged layout keeps one allocator and
    radix index, the single device's (every rank runs the same host scheduler),
    and a whole page pool on every rank: each rank writes its own rows' K/V, and
    after each model call the rows every data rank wrote are exchanged in one
    gather and written into the others' pools (``sharding.collectives``), so a
    prefix one data group wrote serves another's request, and the prefix hits,
    pages and tokens are the single device's. The slots replicate over the data axes instead
    (every data rank serves the whole batch, as the reference does where B does not
    divide) where the rows share a statistic (``_rows_coupled``: an MoE, fake
    quantization, a linear prepared on the fly), for speculative and chunked steps,
    and where B does not divide. Refused with the typed errors of
    ``sharding.planner``: a W4A8 linear whose groups do not split with it, a W4
    expert stack under ``expert_tp``, a forced ``expert_tp`` whose d_ff_expert the
    model axis does not divide.
    """

    def __init__(self, cfg: ModelConfig, params, *, config: EngineConfig,
                 quant: Optional[ql.QuantConfig] = None, device="cuda",
                 sparsity_plan: Optional[MQ.SparsityPlan] = None, mesh=None, plan=None):
        config.check_model(cfg)
        self.config = config
        self.device = resolve_device(device)
        if _first_tensor(params).device != self.device:
            raise ValueError(f"params live on {_first_tensor(params).device}, "
                             f"engine device is {self.device}")
        self.sparsity_plan = sparsity_plan
        if config.sparsity != "none":
            if sparsity_plan is None:
                self.sparsity_plan = MQ.SparsityPlan(nm=MQ.parse_nm(config.sparsity))
            params = MQ.sparsify_tree(params, self.sparsity_plan)
        # dynamic statistics couple the token rows of a step (module docstring)
        self._rows_coupled = _rows_coupled(params, quant or cfg.quant, cfg)
        self.mesh, self.plan, self.shard = mesh, None, None
        if mesh is not None:
            params = self._take_shard(cfg, params, mesh, plan)
        params = MQ.with_tile_occupancy(params)
        self.cfg, self.params = cfg, params
        self.B, self.T = config.batch_size, config.max_len
        self.eos = config.eos_id
        self.kv_int8 = config.kv_cache == "int8"
        self.paged = config.cache_layout == "paged"
        self.chunked = config.chunked
        self.token_budget = config.token_budget
        self.spec = config.speculate
        # which state kinds the cache carries: token-paged attention KV (page need
        # grows with length) and fixed-size SSM checkpoints (one page per slot)
        self.has_kv, self.has_state = state_lib.family_flags(M.block_spec(cfg))
        if self.spec > 1:
            self.drafter = drafter.NGramDrafter(max_ngram=config.drafter_ngram)
        self.buckets = sorted(b for b in (config.prefill_buckets
                                          or default_buckets(config.max_len))
                              if b <= config.max_len)
        self.cache_dtype = (CACHE_DTYPES[config.cache_dtype] if config.cache_dtype
                            else _first_float_dtype(params) or torch.float32)
        step_kw = dict(path=config.path, temperature=config.temperature, top_k=config.top_k,
                       shard=self.shard)
        # a rank's caches hold the kv heads it attends, its SSM heads and, under
        # data-parallel slots, its data group's slots (dp groups of Bl)
        cache_cfg = cfg if self.shard is None else dataclasses.replace(
            cfg, n_heads=self.shard.q_heads, n_kv_heads=self.shard.kv_heads)
        cache_kw = {} if self.shard is None or not self.shard.state_heads else {
            "state_heads": self.shard.state_heads}
        self.dp = 1 if self.shard is None else self.shard.dp
        self.Bl = self.B // self.dp
        self._dpi = 0 if self.shard is None else self.shard.dp_index
        self.lo = self._dpi * self.Bl
        if self.paged:
            self.ps = config.page_size
            self.maxP = self.T // self.ps
            self.n_pages = config.n_pages or self.B * self.maxP
            self.pool = paging.PagePool(self.n_pages)
            # radix reuse restarts a prompt mid-way, which a state checkpoint cannot
            # (check_model rejects prefix_reuse on stateful families; this is the
            # backstop)
            self.radix = (paging.RadixIndex(self.ps)
                          if config.prefix_reuse and not self.has_state else None)
            if self.has_kv:
                self._table = np.full((self.B, self.maxP), self.n_pages, np.int32)
            if self.has_state:
                self._state_table = np.full(self.B, self.n_pages, np.int32)
            self._state_pages_held = 0
            self._table_dirty = False
            self._seq_pages: List[List[int]] = [[] for _ in range(self.B)]
            self.caches = M.init_cache(cache_cfg, self.Bl, self.T, dtype=self.cache_dtype,
                                       kv_int8=self.kv_int8, layout="paged",
                                       page_size=self.ps, n_pages=self.n_pages,
                                       device=self.device, **cache_kw)
            self._admit_cold = make_paged_admit_step(cfg, quant, warm=False, **step_kw)
            self._admit_warm = make_paged_admit_step(cfg, quant, warm=True, **step_kw)
        else:
            self.caches = M.init_cache(cache_cfg, self.Bl, self.T, dtype=self.cache_dtype,
                                       kv_int8=self.kv_int8, device=self.device, **cache_kw)
            self._admit_step = make_admit_step(cfg, quant, **step_kw)
        self._decode_step = make_serve_decode_step(cfg, quant, **step_kw)
        if self.spec > 1:
            self._verify_step = make_serve_verify_step(cfg, quant, path=config.path,
                                                       shard=self.shard)
        if self.chunked:
            self._chunk_step = make_chunked_step(cfg, quant, **step_kw)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed)
        self.queue: List[Request] = []
        self._slots: List[Optional[Request]] = [None] * self.B
        self._pos = np.zeros(self.B, np.int32)       # tokens in cache per slot
        self._pending = np.zeros(self.B, np.int32)   # next input token per slot
        # chunked prefill progress: while a slot is mid-prefill, _prefill_target
        # holds its prompt length (0: generating) and _prefill_off the tokens
        # already in its pages (radix prefix + scattered chunks)
        self._prefill_off = np.zeros(self.B, np.int32)
        self._prefill_target = np.zeros(self.B, np.int32)
        self._next_rid = 0
        #: optional per-token hook, called as ``on_token(request, token)`` after
        #: every emitted token (the request is already retired when
        #: ``request.done``); the async server streams through it
        self.on_token: Optional[Callable[[Request, int], None]] = None
        self.counters = {
            "prefill_calls": 0, "decode_steps": 0, "active_slot_steps": 0,
            "mid_decode_admissions": 0, "prompt_tokens": 0, "prefill_tokens": 0,
            # paged layout; zero on dense engines
            "prefix_hits": 0, "prefix_tokens_reused": 0, "cow_copies": 0,
            "pages_evicted": 0, "peak_pages_in_use": 0,
            # the pool's pages holding attention KV tokens and SSM state
            # checkpoints, and their peaks; zero on dense engines
            "kv_pages_in_use": 0, "state_pages_in_use": 0,
            "peak_kv_pages_in_use": 0, "peak_state_pages_in_use": 0,
            # speculative decoding; zero when speculate == 1
            "spec_steps": 0, "spec_slot_steps": 0, "spec_drafted": 0,
            "spec_accepted": 0, "spec_emitted": 0,
            # chunked serving; zero when chunked is off
            "chunk_steps": 0, "chunk_prefill_rows": 0, "chunk_decode_rows": 0,
            # steps with no prefill work served by the decode step (fp KV)
            "chunk_decode_only_steps": 0}

    # ------------------------------------------------------------------ sharding

    def _take_shard(self, cfg: ModelConfig, params, mesh, plan):
        """Plan, refuse what is not served sharded, decide whether the slots split
        over the data axes, build this rank's ``ShardContext`` and cut its shard of
        the full ``params`` tree."""
        from repro_torch.sharding import collectives as SC
        from repro_torch.sharding import planner as SP

        self.plan = plan or SP.make_serve_plan(cfg, mesh)
        tp = self.plan.tp if self.plan.tier != "dp_only" else 1
        if self.plan.moe_mode == "expert_tp" and (cfg.d_ff_expert or cfg.d_ff) % tp:
            raise SP.ExpertTPError(
                f"{cfg.name}: expert_tp splits d_ff_expert "
                f"({cfg.d_ff_expert or cfg.d_ff}) over a model axis of {tp}")
        c = self.config
        split = (self.plan.dp > 1 and c.batch_size % self.plan.dp == 0
                 and not self._rows_coupled and c.speculate == 1 and not c.chunked)
        coll = SC.Collectives(mesh)
        self.shard = SC.make_shard_context(cfg, params, self.plan, mesh, coll,
                                           split_slots=split)

        def check_w4(node, path=()):
            if isinstance(node, dict):
                name = path[-1] if path else ""
                experts = "moe" in path and "shared" not in path
                if "qw4" in node and experts and self.shard.expert_tp:
                    raise SP.ShardedW4A8Error(
                        f"W4A8 expert stack {name!r} under expert_tp: K8 has no "
                        f"expert-batched group-acc mode")
                if "qw4" in node and not experts and self.shard.role(name) == "row" \
                        and node["sw"].shape[-2] % tp:
                    raise SP.ShardedW4A8Error(
                        f"W4A8 linear {name!r}: {node['sw'].shape[-2]} groups do not "
                        f"split over a model axis of {tp}")
                for k, v in node.items():
                    check_w4(v, path + (k,))
            elif isinstance(node, list):
                for v in node:
                    check_w4(v, path)

        check_w4(params)
        placements = SP.param_placements(params, cfg, self.plan, mesh)
        return SP.shard_tree(params, placements, mesh)

    # ---------------------------------------------------------------- submission

    def submit(self, prompts: List[np.ndarray],
               max_new: Union[int, Sequence[int]] = 16) -> List[Request]:
        if isinstance(max_new, int):
            max_new = [max_new] * len(prompts)
        reqs = []
        for p, mn in zip(prompts, max_new):
            p = np.asarray(p, np.int32)
            if not 0 < len(p) <= self.T:
                raise ValueError(f"prompt length {len(p)} not in (0, {self.T}]")
            reqs.append(Request(self._next_rid, p, mn))
            self._next_rid += 1
        self.queue.extend(reqs)
        return reqs

    # ---------------------------------------------------------------- scheduling

    def _bucket(self, plen: int) -> int:
        for b in self.buckets:
            if b >= plen:
                return b
        return self.T

    def stats(self) -> EngineStats:
        return EngineStats.from_counters(self.counters, self.B)

    def occupancy(self) -> float:
        return self.stats().occupancy

    def prefix_hit_rate(self) -> float:
        """Fraction of submitted prompt tokens served from shared prefix pages
        instead of being prefilled (paged layout; 0.0 on dense)."""
        return self.stats().prefix_hit_rate

    def accept_rate(self) -> float:
        """Fraction of drafted tokens the verify step accepted (0.0 when nothing
        was drafted)."""
        return self.stats().accept_rate

    def tokens_per_step(self) -> float:
        """Mean emitted tokens per slot per speculative verify step (0.0 before
        any speculative step ran)."""
        return self.stats().tokens_per_step

    def _emit(self, slot: int, tok: int, finished: List[Request]) -> None:
        """Record one sampled token for a slot; retire the request when done (a
        prompt of length max_len fills its row and retires at its first token).
        A paged slot drops its page references at retirement and its table row
        turns sentinel before the next step. Every emission site ends here, so
        ``on_token`` sees the tokens of prefill, decode, verify and chunked steps."""
        r = self._slots[slot]
        r.out.append(tok)
        if self.eos is not None and tok == self.eos:
            reason = FinishReason.EOS
        elif len(r.out) >= r.max_new:
            reason = FinishReason.LENGTH
        elif self._pos[slot] >= self.T:
            reason = FinishReason.CACHE_FULL
        else:
            reason = None
        if reason is not None:
            r.done = True
            r.finish_reason = reason
            finished.append(r)
            self._slots[slot] = None
            self._pos[slot] = 0
            self._pending[slot] = 0
            self._prefill_off[slot] = 0
            self._prefill_target[slot] = 0
            if self.paged:
                # pages the radix index retains as cached prefixes survive (the
                # index holds its own reference); the rest, the slot's state page
                # included, return to the free list
                self.pool.decref(self._seq_pages[slot])
                self._seq_pages[slot] = []
                if self.has_kv:
                    self._table[slot, :] = self.n_pages
                if self.has_state:
                    # the freed checkpoint may go to the next admission, whose
                    # prefill starts from a zero state instead of reading it
                    self._state_table[slot] = self.n_pages
                    self._state_pages_held -= 1
                self._table_dirty = True
                self._note_pool()
        else:
            self._pending[slot] = tok
        if self.on_token is not None:
            self.on_token(r, tok)

    # ------------------------------------------------------------ paged planning

    def _match_prefix(self, prompt: np.ndarray):
        """Radix walk plus the usability caps shared by planning and bucketing: a
        request keeps ≥ 1 suffix token (its first sampled token comes from the
        suffix prefill), so the full-page match is clamped to ``(plen-1)//ps``
        pages, and a clamped match drops the partial tail hit (it hangs off the
        unclamped depth). Returns (shared_pages, matched_tokens, cow_src_or_None, j)."""
        plen, ps = len(prompt), self.ps
        if self.radix is None:
            return [], 0, None, 0
        pages, _, partial = self.radix.match(prompt)
        n_full = min(len(pages), (plen - 1) // ps)
        if n_full < len(pages):
            partial = None
        j = min(partial.length, plen - 1 - n_full * ps) if partial else 0
        return pages[:n_full], n_full * ps, partial.page if j > 0 else None, j

    def _plan_paged(self, r: Request) -> Optional[dict]:
        """Page plan for one request: the shared prefix from the radix index, then
        this sequence's worst-case page count (prompt plus decode budget, capped
        at the cache length), evicting LRU cached prefixes under pressure; None
        when the pool cannot cover it. The shared pages and the COW source are
        incref'd before evict/alloc, so a matched prefix held only by the index
        cannot be evicted and handed back as a writable page of this very plan."""
        plen, ps = len(r.prompt), self.ps
        shared, matched, cow_src, j = self._match_prefix(r.prompt)
        self.pool.incref(shared)
        if cow_src is not None:
            self.pool.incref([cow_src])
        prefix = matched + j
        # the final sampled token retires the request unscattered: max_new - 1;
        # a state checkpoint is one more page whatever the length
        need = -(-min(plen + max(r.max_new - 1, 0), self.T) // ps) if self.has_kv else 0
        own_n = need - len(shared) + (1 if self.has_state else 0)
        own = self.pool.alloc(own_n)
        if own is None and self.radix is not None:
            self.counters["pages_evicted"] += self.radix.evict(self.pool, own_n)
            own = self.pool.alloc(own_n)
        if cow_src is not None:                # the copy is issued before any write
            self.pool.decref([cow_src])
        if own is None:
            self.pool.decref(shared)
            return None
        cow = (cow_src, own[0], j) if cow_src is not None else None
        kv_own = own[:-1] if self.has_state else own
        return {"prefix": prefix, "suffix": plen - prefix, "pages": shared + kv_own,
                "cow": cow, "state_page": own[-1] if self.has_state else None}

    def _suffix_estimate(self, r: Request) -> int:
        """Prefill-window estimate for bucketing: the prompt minus its currently
        cached shared prefix (the dense layout prefills the whole prompt)."""
        if not self.paged:
            return len(r.prompt)
        _, matched, _, j = self._match_prefix(r.prompt)
        return len(r.prompt) - matched - j

    def _split_rows(self, row_slots: np.ndarray):
        """Data-parallel slots: an admission batch's rows (their slots; -1 marks a
        padding row) → (this data group's rows, the rows R every group prefills,
        padded to a power of two, and ``take``, each row's index in the gathered
        (dp·R) hidden rows)."""
        grp = np.where(row_slots >= 0, row_slots // self.Bl, -1)
        n = max(int((grp == d).sum()) for d in range(self.dp))
        R = 1 << (n - 1).bit_length() if n > 1 else 1
        take = np.zeros(len(row_slots), np.int64)
        for d in range(self.dp):
            idx = np.nonzero(grp == d)[0]
            take[idx] = d * R + np.arange(len(idx))
        return np.nonzero(grp == self._dpi)[0], R, take

    def _admit_paged_batch(self, batch: List[Request], bucket: int, free: List[int],
                           finished: List[Request]) -> int:
        """Admit up to ``len(free)`` paged requests in one suffix-prefill call.
        Returns the number admitted; the rest rejoin the queue head."""
        plans, deferred = [], []
        for r in batch:
            plan = self._plan_paged(r)
            if plan is None or plan["suffix"] > bucket:
                if plan is not None:       # un-reserve: replanned next round
                    self.pool.decref(plan["pages"] + ([plan["state_page"]]
                                                      if self.has_state else []))
                deferred.append(r)
            else:
                plans.append((r, plan))
        if deferred:
            self.queue = deferred + self.queue
        if not plans:
            return 0
        rows = 1 << (len(plans) - 1).bit_length() if len(plans) > 1 else 1
        tokens = np.zeros((rows, bucket), np.int32)
        lens = np.ones(rows, np.int32)
        prefixes = np.zeros(rows, np.int32)
        row_tables = np.full((rows, self.maxP), self.n_pages, np.int32)
        row_states = np.full(rows, self.n_pages, np.int32)
        mid_decode = any(s is not None for s in self._slots)
        warm = False
        row_slots = np.full(rows, -1, np.int64)
        for j, (slot, (r, plan)) in enumerate(zip(free, plans)):
            suffix = r.prompt[plan["prefix"]:]
            tokens[j, : len(suffix)] = suffix
            lens[j] = len(suffix)
            prefixes[j] = plan["prefix"]
            row_slots[j] = slot
            row_tables[j, : len(plan["pages"])] = plan["pages"]
            if plan["cow"] is not None:
                self.caches = _page_copy(self.caches, *plan["cow"])
                self.counters["cow_copies"] += 1
            self._slots[slot] = r
            # retirement drops the KV pages and the state page together
            self._seq_pages[slot] = plan["pages"] + (
                [plan["state_page"]] if self.has_state else [])
            if self.has_kv:
                self._table[slot, :] = self.n_pages
                self._table[slot, : len(plan["pages"])] = plan["pages"]
            if self.has_state:
                row_states[j] = plan["state_page"]
                self._state_table[slot] = plan["state_page"]
                self._state_pages_held += 1
            warm = warm or plan["prefix"] > 0
            r.prefix_reused = plan["prefix"]
            self.counters["prompt_tokens"] += len(r.prompt)
            self.counters["prefill_tokens"] += plan["suffix"]
            self.counters["prefix_tokens_reused"] += plan["prefix"]
            self.counters["prefix_hits"] += 1 if plan["prefix"] > 0 else 0
        self._table_dirty = True
        dev = self.device
        step = self._admit_warm if warm else self._admit_cold
        kw = {}
        if self.dp > 1:                   # this data group's rows
            mine, R, take = self._split_rows(row_slots)
            tokens, lens, prefixes, row_tables, row_states = (
                _rows_of(a, mine, R, fill) for a, fill in (
                    (tokens, 0), (lens, 1), (prefixes, 0), (row_tables, self.n_pages),
                    (row_states, self.n_pages)))
            kw["take"] = torch.as_tensor(take, device=dev)
        tok, self.caches = step(
            self.params, torch.as_tensor(tokens, dtype=torch.int64, device=dev),
            torch.as_tensor(lens, device=dev), torch.as_tensor(prefixes, device=dev),
            torch.as_tensor(row_tables, device=dev), torch.as_tensor(row_states, device=dev),
            self.caches, self._gen, **kw)
        tok = tok.cpu().numpy()
        self.counters["prefill_calls"] += 1
        if mid_decode:
            self.counters["mid_decode_admissions"] += 1
        self._note_pool()
        for j, (slot, (r, plan)) in enumerate(zip(free, plans)):
            if self.radix is not None:
                # the full prompt pages become a cached prefix (on the device now)
                self.radix.insert(r.prompt, plan["pages"][: len(r.prompt) // self.ps],
                                  self.pool)
            self._pos[slot] = len(r.prompt)
            self._emit(slot, int(tok[j]), finished)
        return len(plans)

    def _admit_dense_batch(self, batch: List[Request], bucket: int, free: List[int],
                           finished: List[Request]) -> int:
        # rows padded to a power-of-two bucket; sentinel slot B marks padding rows
        rows = 1 << (len(batch) - 1).bit_length() if len(batch) > 1 else 1
        tokens = np.zeros((rows, bucket), np.int32)
        lens = np.ones(rows, np.int32)
        slot_ids = np.full(rows, self.B, np.int32)
        mid_decode = any(s is not None for s in self._slots)
        for j, (slot, r) in enumerate(zip(free, batch)):
            tokens[j, : len(r.prompt)] = r.prompt
            lens[j] = len(r.prompt)
            slot_ids[j] = slot
            self._slots[slot] = r
            self.counters["prompt_tokens"] += len(r.prompt)
            self.counters["prefill_tokens"] += len(r.prompt)
        dev = self.device
        kw = {}
        if self.dp > 1:                   # this data group's rows, its local slots
            mine, R, take = self._split_rows(np.where(slot_ids < self.B, slot_ids, -1))
            tokens, lens = _rows_of(tokens, mine, R, 0), _rows_of(lens, mine, R, 1)
            slot_ids = _rows_of(slot_ids - self.lo, mine, R, self.Bl)
            kw["take"] = torch.as_tensor(take, device=dev)
        tok, self.caches = self._admit_step(
            self.params, torch.as_tensor(tokens, dtype=torch.int64, device=dev),
            torch.as_tensor(lens, device=dev), torch.as_tensor(slot_ids, device=dev),
            self.caches, self._gen, **kw)
        tok = tok.cpu().numpy()
        self.counters["prefill_calls"] += 1
        if mid_decode:
            self.counters["mid_decode_admissions"] += 1
        for j, (slot, r) in enumerate(zip(free, batch)):
            self._pos[slot] = len(r.prompt)
            self._emit(slot, int(tok[j]), finished)
        return len(batch)

    def _admit(self, finished: List[Request]) -> None:
        """Admit while slots are free: each round takes the largest admittable
        same-bucket group over the whole queue (ties to the bucket whose first
        request arrived earliest), so one odd-length head-of-line request does
        not split the majority bucket behind it. Paged requests bucket by their
        suffix after the cached prefix. The grouped scheduler admits only into
        an empty table: the queue head's exact length, unpadded, and every
        queued request of that length that fits."""
        while self.queue:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                return
            if self.config.scheduler == "grouped":
                # whole-batch groups of one exact length, drained to completion
                # before the next group starts
                if len(free) < self.B:
                    return
                length = len(self.queue[0].prompt)
                batch, rest = [], []
                for r in self.queue:
                    (batch if len(batch) < len(free) and len(r.prompt) == length
                     else rest).append(r)
                self.queue = rest
                self._admit_dense_batch(batch, length, free, finished)
                return
            groups: dict = {}
            first: dict = {}
            for i, r in enumerate(self.queue):
                b = self._bucket(self._suffix_estimate(r))
                groups.setdefault(b, []).append(r)
                first.setdefault(b, i)
            bucket = max(groups, key=lambda b: (min(len(groups[b]), len(free)), -first[b]))
            batch = groups[bucket][: len(free)]
            taken = {id(r) for r in batch}
            self.queue = [r for r in self.queue if id(r) not in taken]
            if self.paged:
                admitted = self._admit_paged_batch(batch, bucket, free, finished)
            else:
                admitted = self._admit_dense_batch(batch, bucket, free, finished)
            if admitted == 0:
                return                     # pool exhausted: wait for retirements

    # ---------------------------------------------------------------- main loop

    def _push_table(self) -> None:
        """Sync the host routing tables (the page table, and the (B,) state table
        of a model with SSM state) to the device cache. Retired slots' rows are
        sentinel before the next step: a free slot still decodes in lock-step,
        and its garbage token must write nowhere (a stale row would corrupt a
        page the allocator may have handed to another sequence or the index)."""
        rows = slice(self.lo, self.lo + self.Bl)        # this data group's slots
        if self.has_kv:
            self.caches["page_table"] = torch.as_tensor(self._table[rows],
                                                        device=self.device)
        if self.has_state:
            self.caches["state_table"] = torch.as_tensor(self._state_table[rows],
                                                         device=self.device)
        self._table_dirty = False

    def _note_pool(self) -> None:
        """Pool occupancy after an alloc or decref: the one pool backs both page
        kinds, so the KV pages are what the slots' state checkpoints are not
        (radix-held cached prefixes count as KV)."""
        held, c = self._state_pages_held, self.counters
        kv = self.pool.used_count - held
        c["state_pages_in_use"], c["kv_pages_in_use"] = held, kv
        c["peak_state_pages_in_use"] = max(c["peak_state_pages_in_use"], held)
        c["peak_kv_pages_in_use"] = max(c["peak_kv_pages_in_use"], kv)
        c["peak_pages_in_use"] = max(c["peak_pages_in_use"], self.pool.used_count)

    def _unmapped(self, slot: int) -> bool:
        """A retired paged slot holds no page and its table rows are sentinel."""
        return (not self._seq_pages[slot]
                and not (self.has_kv and (self._table[slot] != self.n_pages).any())
                and not (self.has_state and self._state_table[slot] != self.n_pages))

    def _spec_step(self, active: List[int], finished: List[Request]) -> None:
        """One speculative verify step: draft ≤ spec-1 tokens per active slot from
        its own prompt+output history, score the whole window in one pass, then
        accept the longest prefix whose drafts match the model's own greedy
        samples. Every accepted token advances ``_pos`` as a plain decode step
        would, and a request retiring mid-window drops the rest of its window
        with its page mappings torn down before any later step."""
        W = self.spec
        toks = np.zeros((self.B, W), np.int32)
        toks[:, 0] = self._pending
        wl = np.ones(self.B, np.int32)
        for i in active:
            r = self._slots[i]
            # window budget: room left in the cache row (the pending token lands at
            # _pos) and tokens left before max_new retires the request
            n_d = min(W - 1, self.T - self._pos[i] - 1, r.max_new - len(r.out) - 1)
            if n_d > 0:
                d = self.drafter.draft(np.concatenate([r.prompt, np.asarray(r.out, np.int32)]),
                                       n_d)
                wl[i] = 1 + len(d)
                toks[i, 1:1 + len(d)] = d
        dev = self.device
        out, self.caches = self._verify_step(
            self.params, torch.as_tensor(toks, dtype=torch.int64, device=dev), self.caches,
            torch.as_tensor(self._pos + wl, device=dev), torch.as_tensor(wl, device=dev))
        out = out.cpu().numpy()                        # (B, W) greedy samples
        self.counters["decode_steps"] += 1
        self.counters["spec_steps"] += 1
        self.counters["spec_slot_steps"] += len(active)
        self.counters["active_slot_steps"] += len(active)
        for i in active:
            n = 1                                      # the pending token always lands
            while n < wl[i] and toks[i, n] == out[i, n - 1]:
                n += 1
            self.counters["spec_drafted"] += int(wl[i]) - 1
            self.counters["spec_accepted"] += n - 1
            r = self._slots[i]
            for j in range(n):
                # retire conditions fire at exactly the token sequential decode would
                self._pos[i] += 1
                self._emit(i, int(out[i, j]), finished)
                self.counters["spec_emitted"] += 1
                if self._slots[i] is not r:
                    if self.paged:
                        assert self._unmapped(i), \
                            "mid-window retirement left stale page mappings"
                    break

    # ------------------------------------------------------------- chunked mode

    def _admit_chunked(self) -> None:
        """FIFO admission into free slots: page planning, copy-on-write and radix
        matching as ``_admit_paged_batch`` does them, but no prefill runs; the
        slot enters the mid-prefill state and its prompt is served chunk by chunk
        out of each step's leftover budget."""
        while self.queue:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                return
            r = self.queue[0]
            plan = self._plan_paged(r)
            if plan is None:
                return                     # pool pressure: wait for retirements
            self.queue.pop(0)
            slot = free[0]
            if plan["cow"] is not None:
                self.caches = _page_copy(self.caches, *plan["cow"])
                self.counters["cow_copies"] += 1
            self._slots[slot] = r
            self._seq_pages[slot] = plan["pages"]
            self._table[slot, :] = self.n_pages
            self._table[slot, : len(plan["pages"])] = plan["pages"]
            self._table_dirty = True
            self._prefill_off[slot] = plan["prefix"]
            self._prefill_target[slot] = len(r.prompt)
            r.prefix_reused = plan["prefix"]
            self.counters["prompt_tokens"] += len(r.prompt)
            self.counters["prefill_tokens"] += plan["suffix"]
            self.counters["prefix_tokens_reused"] += plan["prefix"]
            self.counters["prefix_hits"] += 1 if plan["prefix"] > 0 else 0
            self._note_pool()

    def _decode_all(self, active: List[int], finished: List[Request]) -> None:
        """One plain decode step over every slot (this data group's, under
        data-parallel slots); the active ones emit."""
        dev = self.device
        rows = slice(self.lo, self.lo + self.Bl)
        cur = torch.as_tensor(self._pos[rows] + 1, device=dev)   # post-append lengths
        tok, self.caches = self._decode_step(
            self.params, torch.as_tensor(self._pending[rows], dtype=torch.int64, device=dev),
            self.caches, cur, self._gen)
        tok = tok.cpu().numpy()
        self._pos[active] += 1
        self.counters["decode_steps"] += 1
        self.counters["active_slot_steps"] += len(active)
        for i in active:
            self._emit(i, int(tok[i]), finished)

    def _chunked_step(self, finished: List[Request]) -> None:
        """One mixed-budget step: admit, pack decode rows (draft windows under
        ``speculate``) of every generating slot first, fill the rest of the token
        budget with prefill chunks (ends on page boundaries where a whole page
        fits; a chunk may start mid-page after a partial radix hit), launch once,
        then emit and advance on the host."""
        self._admit_chunked()
        gen = [i for i, s in enumerate(self._slots)
               if s is not None and self._prefill_target[i] == 0]
        pre = [i for i, s in enumerate(self._slots)
               if s is not None and self._prefill_target[i] > 0]
        if not gen and not pre:
            if self.queue:
                raise RuntimeError(
                    f"page pool too small: {self.n_pages} pages of {self.ps} cannot "
                    f"hold request {self.queue[0].rid} (prompt "
                    f"{len(self.queue[0].prompt)} + budget {self.queue[0].max_new})")
            return
        if self._table_dirty:
            self._push_table()
        if not pre and self.spec == 1 and not self.kv_int8:
            # pure decode with fp KV: the decode step (K4) skips the packed step's
            # scatter and row gathers; its rows are the packed launch's q_len == 1
            # rows, so the tokens are the same
            self._decode_all(gen, finished)
            self.counters["chunk_decode_only_steps"] += 1
            return
        # packed rows up to the budget; only the `off` live ones are launched
        Nt = self.token_budget
        toks = np.zeros(Nt, np.int32)
        positions = np.zeros(Nt, np.int32)
        slot_ids = np.full(Nt, self.B, np.int32)
        q_start = np.zeros(self.B, np.int32)
        q_len = np.zeros(self.B, np.int32)
        kv_len = np.zeros(self.B, np.int32)
        wl = np.ones(self.B, np.int32)
        off = 0
        for i in gen:                     # decode rows first: the budget floor fits them
            r = self._slots[i]
            window = [int(self._pending[i])]
            if self.spec > 1:
                n_d = min(self.spec - 1, self.T - self._pos[i] - 1, r.max_new - len(r.out) - 1)
                if n_d > 0:
                    hist = np.concatenate([r.prompt, np.asarray(r.out, np.int32)])
                    window += list(self.drafter.draft(hist, n_d))
            W = len(window)
            toks[off: off + W] = window
            positions[off: off + W] = self._pos[i] + np.arange(W)
            slot_ids[off: off + W] = i
            q_start[i], q_len[i], kv_len[i] = off, W, self._pos[i] + W
            wl[i] = W
            off += W
        for i in pre:                     # leftover budget: prefill chunks, FIFO
            room = Nt - off
            if room <= 0:
                break
            start = int(self._prefill_off[i])
            plen = int(self._prefill_target[i])
            end = min(plen, start + room)
            if end < plen:
                # a page-aligned end where a whole page fits; else the raw budget
                # cut, so progress never stalls
                aligned = (end // self.ps) * self.ps
                if aligned > start:
                    end = aligned
            toks[off: off + end - start] = self._slots[i].prompt[start:end]
            positions[off: off + end - start] = np.arange(start, end)
            slot_ids[off: off + end - start] = i
            q_start[i], q_len[i], kv_len[i] = off, end - start, end
            off += end - start
        # the live rows only, unless the rows are coupled: then all Nt, as the
        # reference launches them
        n = Nt if self._rows_coupled else off
        dev = self.device
        as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        tok, rowmax, self.caches = self._chunk_step(
            self.params, torch.as_tensor(toks[None, :n], dtype=torch.int64, device=dev),
            as_dev(q_start), as_dev(q_len), as_dev(kv_len), as_dev(positions[:n]),
            as_dev(slot_ids[:n]), self.caches, self._gen)
        tok, rowmax = tok.cpu().numpy(), rowmax.cpu().numpy()
        self.counters["chunk_steps"] += 1
        self.counters["chunk_decode_rows"] += int(sum(wl[i] for i in gen))
        if gen:
            self.counters["decode_steps"] += 1
            self.counters["active_slot_steps"] += len(gen)
        served_pre = [i for i in pre if q_len[i] > 0]
        if served_pre:
            self.counters["prefill_calls"] += 1
            self.counters["chunk_prefill_rows"] += int(sum(q_len[i] for i in served_pre))
            if gen:
                self.counters["mid_decode_admissions"] += 1
        if self.spec > 1 and gen:
            self.counters["spec_steps"] += 1
            self.counters["spec_slot_steps"] += len(gen)
        for i in gen:
            if self.spec == 1:
                self._pos[i] += 1
                self._emit(i, int(tok[i]), finished)
                continue
            r = self._slots[i]
            out_w = rowmax[q_start[i]: q_start[i] + wl[i]]
            n = 1                                      # the pending token always lands
            while n < wl[i] and toks[q_start[i] + n] == out_w[n - 1]:
                n += 1
            self.counters["spec_drafted"] += int(wl[i]) - 1
            self.counters["spec_accepted"] += n - 1
            for j in range(n):
                self._pos[i] += 1
                self._emit(i, int(out_w[j]), finished)
                self.counters["spec_emitted"] += 1
                if self._slots[i] is not r:
                    assert self._unmapped(i), "mid-window retirement left stale page mappings"
                    break
        for i in served_pre:              # the final chunk emits the first token
            end = int(kv_len[i])
            self._prefill_off[i] = end
            if end == self._prefill_target[i]:
                r = self._slots[i]
                self._prefill_target[i] = 0
                self._pos[i] = len(r.prompt)
                if self.radix is not None:
                    # the whole prompt is on the device now: a cached prefix
                    self.radix.insert(r.prompt, self._seq_pages[i][: len(r.prompt) // self.ps],
                                      self.pool)
                self._emit(i, int(tok[i]), finished)

    @torch.no_grad()
    def step(self, finished: List[Request]) -> bool:
        """One engine iteration: admissions plus at most one model launch (decode,
        verify or, when chunked, one packed step). Appends retired requests to
        ``finished``; returns False once idle."""
        if not (self.queue or any(s is not None for s in self._slots)):
            return False
        if self.chunked:
            self._chunked_step(finished)
            return True
        self._admit(finished)
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            if self.queue and self.paged:
                # nothing in flight, yet the queue head could not be admitted: no
                # retirement will ever free enough pages
                raise RuntimeError(
                    f"page pool too small: {self.n_pages} pages of {self.ps} cannot "
                    f"hold request {self.queue[0].rid} (prompt "
                    f"{len(self.queue[0].prompt)} + budget {self.queue[0].max_new})")
            assert not self.queue, "scheduler stalled with queued requests"
            return True   # everything admitted retired at its first token
        if self.paged and self._table_dirty:
            self._push_table()
        if self.spec > 1:
            self._spec_step(active, finished)
            return True
        self._decode_all(active, finished)
        return True

    def run(self) -> List[Request]:
        finished: List[Request] = []
        while self.step(finished):
            pass
        return sorted(finished, key=lambda r: r.rid)
