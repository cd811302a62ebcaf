"""Validated serving configuration + engine statistics (port of
``repro/serving/config.py``: ``SERVE_PATHS``, ``EngineConfig`` with its JSON and
CLI surface, ``EngineStats``).

``EngineConfig`` keeps the reference's fields and cross-field validation: the
``fp``, ``fake``, ``dequant-fp`` and ``fused-int8`` paths, the continuous and
grouped schedulers, the dense and paged layouts, speculative decoding, chunked
prefill and N:M sparsity are served. :meth:`EngineConfig.check_model` does the
model-dependent checks: SSM and hybrid families serve like the others, and only
the combinations their recurrent state cannot support are rejected, each with
the reference's :class:`UnsupportedModelError` subclass. Encoder-only models
have no decode step and are refused with :class:`NotPortedError` (the reference
admits them; here they run through ``serving.engine.make_prefill_step``).

A config round-trips through JSON (``to_json`` / ``from_json``, the same string
as the reference's for the same field values), and :func:`add_config_args`
derives one CLI flag per field, which :func:`config_from_args` layers over a
JSON base and the calling script's defaults.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import torch

#: serving path → QuantContext wiring. ``None`` serves whatever the params tree +
#: quant config imply on the plain ``ref`` integer backend.
SERVE_PATHS: Dict[Optional[str], Dict[str, Any]] = {
    None: {},
    "fp": {},
    "fake": {},
    "dequant-fp": {"int_exec": "dequant"},
    "fused-int8": {"int_exec": "kernel", "use_kernels": True},
}
#: fp KV-cache dtypes by canonical name (``cache_dtype`` is stored as a name):
#: the ones the paged kernel reads
CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: N:M sparsity specs an engine applies at build
SPARSITY_CHOICES = ("none", "2:4", "4:8")


class NotPortedError(NotImplementedError):
    """A model the slot-table engine does not serve: an encoder-only model (no
    decode step)."""


# ==========================================================================
# Typed model-compatibility rejections (DESIGN.md §3.13)
# ==========================================================================

class UnsupportedModelError(ValueError):
    """An :class:`EngineConfig` combination this model family cannot serve.

    Subclasses carry the *reason*; all are ``ValueError`` so pre-§3.13
    callers that caught that keep working."""


class SpeculativeStateError(UnsupportedModelError):
    """``speculate > 1`` on an SSM/hybrid family: the recurrence advances
    destructively per scattered token, so rejected draft tokens cannot be
    rewound (DESIGN.md §3.9)."""


class PrefixReuseStateError(UnsupportedModelError):
    """``prefix_reuse`` on a paged SSM/hybrid family: radix reuse restarts a
    prompt from a mid-sequence page boundary, which position-indexed KV pages
    support but a single end-of-prefix state checkpoint does not (DESIGN.md
    §3.8/§3.13)."""


class ChunkedStateError(UnsupportedModelError):
    """``chunked=True`` on an SSM/hybrid family: the packed ragged step
    scatters interleaved chunks of many slots, which needs position-indexed
    cache writes the recurrent state does not have (DESIGN.md §3.10)."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen serving configuration: the reference's fields that this port
    serves, with the reference's defaults. ``cache_dtype`` is stored
    as a canonical dtype name (``"bfloat16"``); ``None`` follows the params."""

    batch_size: int
    max_len: int
    eos_id: Optional[int] = None
    path: Optional[str] = None
    kv_cache: str = "fp"
    cache_layout: str = "dense"
    page_size: int = 8
    n_pages: Optional[int] = None
    prefix_reuse: bool = True
    cache_dtype: Optional[str] = None
    scheduler: str = "continuous"
    prefill_buckets: Optional[Tuple[int, ...]] = None
    chunked: bool = False
    token_budget: int = 64
    speculate: int = 1
    drafter_ngram: int = 3
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    sparsity: str = "none"

    def __post_init__(self):
        if self.prefill_buckets is not None:
            object.__setattr__(self, "prefill_buckets",
                               tuple(int(b) for b in self.prefill_buckets))
        if self.cache_dtype is not None:
            name = (str(self.cache_dtype).removeprefix("torch.")
                    if isinstance(self.cache_dtype, torch.dtype) else str(self.cache_dtype))
            if name not in CACHE_DTYPES:
                raise ValueError(f"cache_dtype must be one of {sorted(CACHE_DTYPES)}, "
                                 f"got {self.cache_dtype!r}")
            object.__setattr__(self, "cache_dtype", name)
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.path not in SERVE_PATHS:
            raise ValueError(f"unknown serving path {self.path!r}; "
                             f"pick one of {sorted(k for k in SERVE_PATHS if k)}")
        if self.kv_cache not in ("fp", "int8"):
            raise ValueError(f"kv_cache must be 'fp' or 'int8', got {self.kv_cache!r}")
        if self.cache_layout not in ("dense", "paged"):
            raise ValueError(f"cache_layout must be 'dense' or 'paged', got "
                             f"{self.cache_layout!r}")
        if self.scheduler not in ("continuous", "grouped"):
            raise ValueError(f"scheduler must be 'continuous' or 'grouped', "
                             f"got {self.scheduler!r}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.cache_layout == "paged" and self.scheduler != "continuous":
            raise ValueError("the paged layout serves through the continuous "
                             "scheduler (the grouped baseline stays dense)")
        if self.speculate < 1:
            raise ValueError(f"speculate must be >= 1, got {self.speculate}")
        if self.chunked:
            if self.cache_layout != "paged":
                raise ValueError("chunked=True needs cache_layout='paged' "
                                 "(chunks scatter through the page table)")
            if self.token_budget < self.batch_size * self.speculate:
                raise ValueError(
                    f"token_budget {self.token_budget} < batch_size*speculate "
                    f"{self.batch_size * self.speculate}: every generating "
                    f"slot's decode row (or draft window) must fit each step")
        if self.sparsity != "none":
            from repro_torch.models.quantize import parse_nm
            parse_nm(self.sparsity)          # raises on malformed N:M
            if self.sparsity not in SPARSITY_CHOICES:
                raise ValueError(f"sparsity must be one of {SPARSITY_CHOICES}, "
                                 f"got {self.sparsity!r}")
        if self.speculate > 1:
            if self.temperature > 0.0:
                raise ValueError("speculate > 1 requires greedy sampling "
                                 "(temperature <= 0): acceptance is token-"
                                 "exact only under deterministic sampling")
            if self.scheduler != "continuous":
                raise ValueError("speculate > 1 requires the continuous "
                                 "scheduler (per-slot draft windows)")

    def check_model(self, cfg) -> None:
        """Model-dependent validation. SSM and hybrid families serve continuous,
        paged and grouped like attention families; the combinations their
        recurrent state cannot support raise the reference's typed
        :class:`UnsupportedModelError` subclasses, under the reference's
        conditions. An encoder-only model has no decode step and raises
        :class:`NotPortedError` (a deviation: the reference admits it; here it
        runs through ``serving.engine.make_prefill_step``)."""
        if cfg.family in ("ssm", "hybrid"):
            if self.speculate > 1:
                raise SpeculativeStateError(
                    f"speculate > 1 cannot serve family {cfg.family!r}: the SSM "
                    f"recurrence cannot rewind rejected draft tokens (§3.9)")
            if self.cache_layout == "paged" and self.prefix_reuse:
                raise PrefixReuseStateError(
                    f"radix prefix reuse cannot serve family {cfg.family!r}: a "
                    f"state checkpoint cannot restart a prompt from a mid-"
                    f"sequence page boundary — pass prefix_reuse=False (§3.13)")
            if self.chunked:
                raise ChunkedStateError(
                    f"chunked serving cannot serve family {cfg.family!r}: packed "
                    f"ragged chunks need position-indexed cache writes, which "
                    f"the recurrent state does not have (§3.10)")
            return
        if not cfg.causal or cfg.frontend == "audio_stub":
            raise NotPortedError(
                f"{cfg.name} takes frames and has no decode step (causal={cfg.causal}): "
                f"the slot-table engine serves decoders from token prompts; run it with "
                f"serving.engine.make_prefill_step on a frames batch")


    # ------------------------------------------------------------------- JSON

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d["prefill_buckets"] is not None:
            d["prefill_buckets"] = list(d["prefill_buckets"])
        return d

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "EngineConfig":
        return cls.from_kwargs(**d)

    @classmethod
    def from_json(cls, blob) -> "EngineConfig":
        """Build from a JSON string / parsed dict. Round-trip lossless:
        ``EngineConfig.from_json(cfg.to_json()) == cfg``."""
        if isinstance(blob, str):
            blob = json.loads(blob)
        return cls.from_dict(blob)

    @classmethod
    def from_kwargs(cls, **kw) -> "EngineConfig":
        """Build from keyword fields, rejecting unknown keys with a TypeError."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(kw) - fields)
        if unknown:
            raise TypeError(f"unknown engine config field(s): {unknown}; "
                            f"valid fields: {sorted(fields)}")
        return cls(**kw)


# ==========================================================================
# CLI derivation: flags come from the dataclass fields, not hand-kept lists
# ==========================================================================

#: fields whose argparse help benefits from a one-liner; anything not listed
#: still gets a flag (new config fields appear in every CLI automatically)
_FIELD_HELP = {
    "batch_size": "slot-table width (concurrent sequences)",
    "max_len": "per-slot KV cache length",
    "eos_id": "EOS token id; default: no EOS (token 0 is PAD)",
    "path": "integer execution backend (DESIGN.md §3.3)",
    "kv_cache": "decode K/V storage: fp or int8 codes + per-token scales",
    "cache_layout": "dense slot table (§3.6) or paged pool + radix reuse (§3.8)",
    "page_size": "tokens per KV page (paged layout)",
    "n_pages": "page-pool capacity; default batch_size*max_len/page_size",
    "prefix_reuse": "radix prefix reuse on the paged layout",
    "cache_dtype": "fp KV-cache dtype name; default: params dtype",
    "scheduler": "continuous (slot refill mid-decode) or grouped baseline",
    "prefill_buckets": "comma-separated padded-prefill lengths",
    "chunked": "chunked prefill + prefill-decode interleaving (§3.10)",
    "token_budget": "per-step token budget for chunked serving",
    "speculate": "draft-window size K for speculative decoding (§3.9)",
    "drafter_ngram": "max n-gram length of the prompt-lookup drafter",
    "temperature": "sampling temperature; 0 = greedy",
    "top_k": "top-k sampling cutoff; 0 = disabled",
    "seed": "sampling PRNG seed",
    "sparsity": "N:M structured weight sparsity applied at engine build (§3.12)",
}

_FIELD_CHOICES = {
    "path": [p for p in SERVE_PATHS if p],
    "kv_cache": ["fp", "int8"],
    "cache_layout": ["dense", "paged"],
    "scheduler": ["continuous", "grouped"],
    "sparsity": list(SPARSITY_CHOICES),
}


def _base_type(f: dataclasses.Field):
    """A field's flag type from its annotation (a string under postponed
    evaluation): int, float, bool or str."""
    s = str(f.type)
    for name, py in (("int", int), ("float", float), ("bool", bool),
                     ("str", str)):
        if name in s:
            return py
    return str


def add_config_args(parser: argparse.ArgumentParser,
                    prefix: str = "") -> None:
    """Add one ``--<field>`` flag per :class:`EngineConfig` field (underscores
    become dashes). Every flag defaults to *unset* so layering works:
    ``--config file.json`` values win unless the flag is given explicitly
    (:func:`config_from_args`). Bools get ``--x/--no-x`` pairs."""
    group = parser.add_argument_group("engine config (serving/config.py)")
    for f in dataclasses.fields(EngineConfig):
        flag = f"--{prefix}{f.name.replace('_', '-')}"
        helptext = _FIELD_HELP.get(f.name, f.name)
        ftype = _base_type(f)
        if ftype is bool:
            group.add_argument(flag, default=None, help=helptext,
                               action=argparse.BooleanOptionalAction)
        elif f.name == "prefill_buckets":
            group.add_argument(flag, default=None, metavar="B1,B2,...",
                               type=lambda s: tuple(int(x) for x in s.split(",")),
                               help=helptext)
        else:
            group.add_argument(flag, default=None, type=ftype,
                               choices=_FIELD_CHOICES.get(f.name),
                               help=helptext)


def config_from_args(args: argparse.Namespace,
                     base: Optional[EngineConfig] = None,
                     **defaults) -> EngineConfig:
    """Layer CLI flags over ``base`` (usually ``--config file.json``) over
    ``defaults`` (the calling script's choices) to build the final config.
    Only flags the user actually passed override the layers below."""
    merged: Dict[str, Any] = dict(defaults)
    if base is not None:
        merged.update(base.to_dict())
    for f in dataclasses.fields(EngineConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            merged[f.name] = v
    return EngineConfig.from_kwargs(**merged)


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """One snapshot of a ``ServeEngine``'s derived rates + raw counters."""

    occupancy: float
    prefix_hit_rate: float
    accept_rate: float
    tokens_per_step: float
    counters: Dict[str, int]

    def to_dict(self) -> dict:
        return {"occupancy": self.occupancy,
                "prefix_hit_rate": self.prefix_hit_rate,
                "accept_rate": self.accept_rate,
                "tokens_per_step": self.tokens_per_step,
                **self.counters}

    @classmethod
    def from_counters(cls, counters: Dict[str, int], batch_size: int) -> "EngineStats":
        c = dict(counters)
        steps = c.get("decode_steps", 0)
        occ = c.get("active_slot_steps", 0) / (steps * batch_size) if steps else 0.0
        prompt = c.get("prompt_tokens", 0)
        hit = c.get("prefix_tokens_reused", 0) / prompt if prompt else 0.0
        drafted = c.get("spec_drafted", 0)
        acc = c.get("spec_accepted", 0) / drafted if drafted else 0.0
        sss = c.get("spec_slot_steps", 0)
        tps = c.get("spec_emitted", 0) / sss if sss else 0.0
        return cls(occupancy=occ, prefix_hit_rate=hit, accept_rate=acc,
                   tokens_per_step=tps, counters=c)
