"""Serving engine: admission/decode step builders and the slot-table continuous
batcher (port of ``repro/serving/engine.py``, dense layout).

``ServeEngine`` keeps a fixed slot table of ``batch_size`` sequences with per-slot
lengths. Requests are admitted into free slots mid-decode through length-bucketed
padded prefill (power-of-two length buckets from 8, power-of-two row buckets,
sentinel slot ``B`` on padding rows); finished requests retire and free their
slot at once. Decode advances every slot in lock-step and samples on the device,
so the host loop moves only int token ids. PyTorch runs eagerly, so the steps
are plain functions and the one live cache is updated in place (the reference
jit-compiles them and donates the cache).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import qlinear as ql
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.layers import QuantContext
from repro_torch.serving.api import FinishReason
from repro_torch.serving.config import SERVE_PATHS, EngineConfig, EngineStats


def _make_ctx(cfg: ModelConfig, quant: Optional[ql.QuantConfig],
              path: Optional[str]) -> QuantContext:
    if path not in SERVE_PATHS:
        raise ValueError(f"unknown serving path {path!r}; "
                         f"pick one of {sorted(k for k in SERVE_PATHS if k)}")
    return QuantContext(quant or cfg.quant, **SERVE_PATHS[path])


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


def _slot_scatter(live: dict, new: dict, slots: torch.Tensor) -> dict:
    """Write the (n_blocks, Bp, ...) rows of ``new`` into the live slot table at
    ``slots`` (Bp,). Sentinel indices ≥ B (padding rows of the admission batch)
    are dropped; every other slot's rows are untouched. In place; returns live."""
    for live_leaves, new_leaves in zip(live["blocks"], new["blocks"]):
        B = next(iter(live_leaves.values())).shape[1]
        keep = slots < B
        src = torch.nonzero(keep).reshape(-1)
        dst = slots[keep].to(torch.int64)
        for name, leaf in live_leaves.items():
            leaf[:, dst] = new_leaves[name][:, src]
    return live


def make_admit_step(cfg: ModelConfig, quant: Optional[ql.QuantConfig] = None, *,
                    path: Optional[str] = None, temperature: float = 0.0, top_k: int = 0):
    """Padded prefill of newly admitted requests into a live slot table: the
    (Bp, S_bucket) admission batch prefills against a fresh zero cache, whose rows
    then scatter into the live table at the admitted slots. Mid-decode slots are
    never touched."""
    ctx = _make_ctx(cfg, quant, path)
    sample = _make_sampler(temperature, top_k)

    def admit_step(params, tokens, lens, slots, caches, gen):
        """tokens (Bp, S) right-padded; lens (Bp,) prompt lengths; slots (Bp,)
        target slot per row (≥ B ⇒ padding row). Returns (first sampled token
        (Bp,) int32, caches with the admitted slots' rows replaced)."""
        Bp = tokens.shape[0]
        fresh = {"blocks": [
            {k: torch.zeros((x.shape[0], Bp) + x.shape[2:], dtype=x.dtype, device=x.device)
             for k, x in leaves.items()} for leaves in caches["blocks"]]}
        logits, ex = M.apply(params, {"tokens": tokens}, cfg, ctx=ctx, mode="prefill",
                             caches=fresh, cur_len=lens)
        merged = _slot_scatter(caches, ex["caches"], slots)
        return sample(logits[:, -1], gen), merged

    return admit_step


def make_serve_decode_step(cfg: ModelConfig, quant: Optional[ql.QuantConfig] = None, *,
                           path: Optional[str] = None, temperature: float = 0.0,
                           top_k: int = 0):
    """One decode step: model forward + on-device sampling → token ids only."""
    ctx = _make_ctx(cfg, quant, path)
    sample = _make_sampler(temperature, top_k)

    def decode_step(params, tokens, caches, cur_len, gen):
        """tokens (B,) int pending inputs; cur_len (B,) post-append lengths →
        (next token (B,) int32, caches updated in place)."""
        logits, ex = M.apply(params, {"tokens": tokens[:, None]}, cfg, ctx=ctx,
                             mode="decode", caches=caches, cur_len=cur_len)
        return sample(logits[:, -1], gen), ex["caches"]

    return decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (len,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[FinishReason] = None


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
    """Continuous batcher over a fixed-size slot table (dense layout).

    ``device`` is where the params live and the engine runs ("cuda" by
    default; "cpu" runs every kernel's plain version). ``eos_id=None`` disables
    EOS termination (token 0 is the pad token). The fp KV cache takes the dtype
    of the params tree's first floating leaf, as the reference does.
    """

    def __init__(self, cfg: ModelConfig, params, *, config: EngineConfig,
                 quant: Optional[ql.QuantConfig] = None, device="cuda"):
        config.check_model(cfg)
        self.config = config
        self.device = resolve_device(device)
        if _first_tensor(params).device != self.device:
            raise ValueError(f"params live on {_first_tensor(params).device}, "
                             f"engine device is {self.device}")
        self.cfg, self.params = cfg, params
        self.B, self.T = config.batch_size, config.max_len
        self.eos = config.eos_id
        self.kv_int8 = config.kv_cache == "int8"
        self.buckets = sorted(b for b in (config.prefill_buckets
                                          or default_buckets(config.max_len))
                              if b <= config.max_len)
        self.cache_dtype = _first_float_dtype(params) or torch.float32
        self.caches = M.init_cache(cfg, self.B, self.T, dtype=self.cache_dtype,
                                   kv_int8=self.kv_int8, device=self.device)
        self._admit_step = make_admit_step(cfg, quant, path=config.path,
                                           temperature=config.temperature,
                                           top_k=config.top_k)
        self._decode_step = make_serve_decode_step(cfg, quant, path=config.path,
                                                   temperature=config.temperature,
                                                   top_k=config.top_k)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed)
        self.queue: List[Request] = []
        self._slots: List[Optional[Request]] = [None] * self.B
        self._pos = np.zeros(self.B, np.int32)       # tokens in cache per slot
        self._pending = np.zeros(self.B, np.int32)   # next input token per slot
        self._next_rid = 0
        self.counters = {"prefill_calls": 0, "decode_steps": 0, "active_slot_steps": 0,
                         "mid_decode_admissions": 0, "prompt_tokens": 0,
                         "prefill_tokens": 0}

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

    def _emit(self, slot: int, tok: int, finished: List[Request]) -> None:
        """Record one sampled token for a slot; retire the request when done (a
        prompt of length max_len fills its row and retires at its first token)."""
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
        else:
            self._pending[slot] = tok

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
        tok, self.caches = self._admit_step(
            self.params, torch.as_tensor(tokens, dtype=torch.int64, device=dev),
            torch.as_tensor(lens, device=dev), torch.as_tensor(slot_ids, device=dev),
            self.caches, self._gen)
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
        not split the majority bucket behind it."""
        while self.queue:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                return
            groups: dict = {}
            first: dict = {}
            for i, r in enumerate(self.queue):
                b = self._bucket(len(r.prompt))
                groups.setdefault(b, []).append(r)
                first.setdefault(b, i)
            bucket = max(groups, key=lambda b: (min(len(groups[b]), len(free)), -first[b]))
            batch = groups[bucket][: len(free)]
            taken = {id(r) for r in batch}
            self.queue = [r for r in self.queue if id(r) not in taken]
            self._admit_dense_batch(batch, bucket, free, finished)

    # ---------------------------------------------------------------- main loop

    @torch.no_grad()
    def step(self, finished: List[Request]) -> bool:
        """One engine iteration: admissions plus at most one decode launch.
        Appends retired requests to ``finished``; returns False once idle."""
        if not (self.queue or any(s is not None for s in self._slots)):
            return False
        self._admit(finished)
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            assert not self.queue, "scheduler stalled with queued requests"
            return True   # everything admitted retired at its first token
        dev = self.device
        cur = torch.as_tensor(self._pos + 1, device=dev)   # post-append lengths
        tok, self.caches = self._decode_step(
            self.params, torch.as_tensor(self._pending, dtype=torch.int64, device=dev),
            self.caches, cur, self._gen)
        tok = tok.cpu().numpy()
        self._pos[active] += 1
        self.counters["decode_steps"] += 1
        self.counters["active_slot_steps"] += len(active)
        for i in active:
            self._emit(i, int(tok[i]), finished)
        return True

    def run(self) -> List[Request]:
        finished: List[Request] = []
        while self.step(finished):
            pass
        return sorted(finished, key=lambda r: r.rid)
