"""Typed request/streaming objects for the serving API (DESIGN.md §3.11).

A verbatim copy of ``repro/serving/api.py``, which is framework-free.

The async front end (``serving/server.py``) and the engine share this small
vocabulary: a user-facing :class:`Request`, per-token :class:`StreamEvent`
frames, a :class:`FinishReason` enum (also stamped by the engine on its
internal request records), per-request :class:`RequestMetrics`, and the typed
:class:`AdmissionError` the bounded admission queue raises when backpressure
holds past the deadline. Kept dependency-free (no jax import) so the engine
can import it without cycles.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


class FinishReason(enum.Enum):
    """Why a sequence stopped emitting."""

    LENGTH = "length"          # hit max_new
    EOS = "eos"                # sampled the EOS token
    CACHE_FULL = "cache_full"  # per-slot KV cache exhausted (pos hit max_len)

    def __str__(self) -> str:  # json/csv friendly
        return self.value


class AdmissionError(RuntimeError):
    """Raised by ``AsyncServer.submit`` when admission backpressure holds past
    the deadline: the request is *rejected*, not queued — see DESIGN.md §3.11
    (rejecting beats LRU-thrashing the radix cache).

    ``reason`` types the rejection: ``"queue_full"`` (in-flight count at the
    bound) or ``"pool_pressure"`` (paged layouts: no alive replica's page pool
    can cover the request's worst-case page reservation — including requests
    whose reservation exceeds the pool outright, which no amount of waiting
    could ever serve)."""

    def __init__(self, msg: str, queue_wait_s: float = 0.0,
                 reason: str = "queue_full"):
        super().__init__(msg)
        self.queue_wait_s = queue_wait_s
        self.reason = reason


@dataclasses.dataclass
class Request:
    """One user-facing generation request for :class:`AsyncServer.submit`.

    ``prompt`` is a list of token ids (the repo serves token-level; tokenizers
    live outside). ``rid`` is optional — the server assigns a unique one when
    unset. ``replica_hint`` pins routing for tests/debugging; normal traffic
    leaves it ``None`` and lets the prefix-affinity router place the request.
    """

    prompt: List[int]
    max_new: int
    rid: Optional[str] = None
    replica_hint: Optional[int] = None

    def __post_init__(self):
        if len(self.prompt) == 0:
            raise ValueError("empty prompt")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")


@dataclasses.dataclass(frozen=True)
class RequestMetrics:
    """Per-request serving metrics, attached to the final ``finished`` event.

    ``ttft_s`` counts from admission to first token, ``tpot_s`` is the mean
    inter-token gap after the first, ``queue_wait_s`` is time spent in the
    admission queue before a replica picked the request up. ``prefix_reused``
    is the §3.8 radix hit length (prompt tokens served from cache), and
    ``kernel_proportion`` is the paper's §4.1 quantization-kernel proportion
    |S⊥|/|S| measured over this request's served activations (``None`` unless
    the server runs with ``kernel_stats=True``). ``requeues`` counts replica-
    failure migrations this request survived (0 on the happy path).
    """

    queue_wait_s: float = 0.0
    ttft_s: float = 0.0
    tpot_s: float = 0.0
    n_tokens: int = 0
    prefix_reused: int = 0
    replica: int = -1
    requeues: int = 0
    kernel_proportion: Optional[float] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return d


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One frame of the ``submit()`` async stream.

    ``kind`` is ``"token"`` (carries ``token``), ``"finished"`` (carries
    ``finish_reason`` + ``metrics``; terminal), or ``"error"`` (carries
    ``error``; terminal — only emitted when no survivor replica could finish
    the request)."""

    kind: str
    rid: str
    token: Optional[int] = None
    finish_reason: Optional[FinishReason] = None
    metrics: Optional[RequestMetrics] = None
    error: Optional[str] = None

    @property
    def terminal(self) -> bool:
        return self.kind in ("finished", "error")
