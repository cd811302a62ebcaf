"""Asyncio serving front end over data-parallel ``ServeEngine`` replicas (port of
``repro/serving/server.py``, DESIGN.md §3.11).

``AsyncServer`` owns ``replicas`` independent :class:`ServeEngine` instances,
each driven on its own thread, and exposes one async streaming call::

    async with AsyncServer(cfg, params, config=EngineConfig(...)) as srv:
        async for ev in srv.submit(Request(prompt=[...], max_new=16)):
            ...  # StreamEvent: per-token frames, then one terminal frame

Three policies hold the SLO story together, as in the reference:

* **Bounded admission with backpressure** — at most ``max_queue`` requests are
  in flight server-wide, and on paged layouts a request must also fit some
  alive replica's page pool (worst-case reservation vs free + reclaimable
  pages); a submit past either bound waits up to ``admission_timeout`` seconds
  for capacity, then fails with a typed :class:`AdmissionError` whose
  ``reason`` says which bound held (``queue_full`` / ``pool_pressure``).
* **Prefix-affinity routing** — the router hashes the leading page-aligned
  prompt chunks and places each request on the replica whose radix index
  already holds the longest matching prefix (falling back to least-loaded).
  Its hashing and LRU are the reference's, so the same sequence of prompts
  routes the same way.
* **Replica health** — a replica whose engine thread throws is *drained* (its
  in-flight requests are requeued onto survivors as prompt+emitted
  continuations, token-exact under greedy decoding) and then restarted, with
  the restart budget accounted by :class:`~repro_torch.runtime.supervisor.
  RestartTracker`. A replica that exhausts its budget is marked dead and
  routes no more. Nothing falls back: an engine or kernel build that fails on
  the card takes this same path, never the plain versions or the CPU.

What is particular to PyTorch and one card:

* ``device`` ("cuda" by default, resolved by
  :func:`repro_torch.device.resolve_device`, which raises when no card is
  visible) is where the params live and every replica serves. ``devices="auto"``
  pins replica *i* to ``cuda:i`` only when ``torch.cuda.device_count() >=
  replicas``; otherwise every replica shares ``device`` (one H100). A replica
  pinned to another card than the params' copies the params once to its card,
  since torch moves no tensor implicitly; no test reaches that branch (it needs
  several cards).
* Each replica thread launches on a CUDA stream of its own, made to wait on
  the stream that made the params, so one replica's host syncs do not wait for
  the other's queued work; the stream survives restarts, so a rebuilt engine
  reuses the freed cache blocks. Grad mode is per thread: the whole thread body,
  engine build and kernel-stats replay included, runs under ``torch.no_grad()``.
* Replicas that share a device take FIFO turns at whole engine steps. An eager
  step is thousands of torch ops and kernel launches, each of which drops the
  GIL; two threads stepping at once hand the GIL to each other at every one of
  them, which made two replicas on one H100 serve about half one replica's
  tok/s (PERF.md). Taking turns costs only the overlap of one replica's host
  work with the other's device time (the step is host-bound). Replicas pinned
  to different cards step freely.
* A failing replica drops every reference to its engine (traceback frames
  included) before the event loop restarts it, so a restart never holds two
  engines' caches at once.

Per-request metrics (TTFT, TPOT, queue wait, prefix hit, requeues — and with
``kernel_stats=True`` the paper's §4.1 quantization-kernel proportion measured
on exactly the tokens this request served) ride on the terminal StreamEvent;
fleet-level aggregates come from :meth:`AsyncServer.metrics`.
"""
from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import logging
import threading
import time
from typing import AsyncIterator, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kernel_analysis as KA
from repro_torch.core import qlinear as ql
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.layers import QuantContext
from repro_torch.runtime.supervisor import (FailureInjector, ReplicaHealth,
                                            RestartTracker)
from repro_torch.serving.api import (AdmissionError, FinishReason, Request,
                                     RequestMetrics, StreamEvent)
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import Request as EngineRequest
from repro_torch.serving.engine import ServeEngine, _first_tensor

log = logging.getLogger("repro_torch.server")


@dataclasses.dataclass
class _Record:
    """Server-side state of one in-flight request. Owned by the replica thread
    once dispatched; the event loop touches it again only after that thread
    has died (failure requeue)."""

    req: Request
    rid: str
    queue: "asyncio.Queue[StreamEvent]"
    submit_t: float
    admit_t: Optional[float] = None
    first_t: Optional[float] = None
    last_t: Optional[float] = None
    emitted: List[int] = dataclasses.field(default_factory=list)
    replica: int = -1
    requeues: int = 0
    prefix_reused: int = 0


class _KernelProportionObserver:
    """calibration.Observer protocol shim: the §4.1 CrossQuant kernel proportion
    of every quantized linear's activation rows."""

    def __init__(self, bits: int, alpha: float):
        self.bits, self.alpha = bits, alpha
        self.fracs: List[float] = []

    def observe(self, name, x):
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        self.fracs.append(float(KA.crossquant_kernel_fraction(
            x2, self.bits, self.alpha)))


class PrefixRouter:
    """Prefix-affinity placement across replicas (DESIGN.md §3.11).

    Keeps one LRU-capped set of page-aligned prompt-prefix hashes per replica
    — the host-visible mirror of what each replica's radix index plausibly
    still caches. ``route`` walks a prompt's prefix hashes longest-first and
    places it on the alive replica with the deepest match; no match (or
    ``policy`` = ``"least-loaded"``) falls back to the least-loaded replica,
    ``policy="random"`` is the seeded baseline.
    """

    def __init__(self, n_replicas: int, page_size: int, *,
                 policy: str = "affinity", seed: int = 0,
                 max_entries: int = 4096):
        if policy not in ("affinity", "least-loaded", "random"):
            raise ValueError(f"unknown router policy {policy!r}")
        self.policy = policy
        self.ps = page_size
        self.max_entries = max_entries
        # insertion-ordered dict as an LRU set per replica
        self._index: List[Dict[int, None]] = [dict() for _ in range(n_replicas)]
        self._rng = np.random.default_rng(seed)
        self.affinity_hits = 0

    def _hashes(self, prompt: np.ndarray) -> List[int]:
        return [hash(prompt[: (k + 1) * self.ps].tobytes())
                for k in range(len(prompt) // self.ps)]

    def route(self, prompt: np.ndarray, alive: Sequence[int],
              load: Dict[int, int]) -> int:
        if self.policy == "random":
            return int(self._rng.choice(np.asarray(alive)))
        if self.policy == "affinity":
            hashes = self._hashes(prompt)
            best, best_depth = None, 0
            for r in alive:
                idx = self._index[r]
                depth = 0
                for k, h in enumerate(hashes):
                    if h in idx:
                        depth = k + 1
                    else:
                        break
                if depth > best_depth or (depth == best_depth and best is not None
                                          and depth > 0
                                          and load[r] < load[best]):
                    best, best_depth = r, depth
            if best is not None and best_depth > 0:
                self.affinity_hits += 1
                return best
        return min(alive, key=lambda r: (load[r], r))

    def note(self, prompt: np.ndarray, replica: int) -> None:
        """Record that ``replica`` now caches this prompt's page-aligned
        prefixes (the engine inserts the full prompt into its radix index at
        admission, so every page-aligned prefix becomes reusable there)."""
        idx = self._index[replica]
        for h in self._hashes(prompt):
            idx.pop(h, None)
            idx[h] = None
        while len(idx) > self.max_entries:
            idx.pop(next(iter(idx)))

    def forget(self, replica: int) -> None:
        """Drop a replica's affinity state (its engine — and radix cache —
        was just torn down by a restart)."""
        self._index[replica].clear()


def _tree_to(tree, device: torch.device):
    """A params tree (nested dicts/lists of tensors) copied to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _detach_frames(err: BaseException) -> BaseException:
    """Drop the tracebacks of ``err`` and its chained exceptions: their frames
    hold the failed engine (its caches) alive."""
    seen = set()
    e: Optional[BaseException] = err
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        e.__traceback__ = None
        e = e.__cause__ or e.__context__
    return err


class _Turns:
    """FIFO turns (a ticket lock) for the replica threads of one device: a
    thread holds its turn for one engine step, and a waiting thread sleeps on
    the condition, not on the GIL."""

    def __init__(self):
        self._cond = threading.Condition()
        self._issued = 0
        self._serving = 0

    @contextlib.contextmanager
    def turn(self):
        with self._cond:
            ticket = self._issued
            self._issued += 1
            while ticket != self._serving:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._serving += 1
                self._cond.notify_all()


class _Replica:
    """One engine replica: a worker thread that builds its ``ServeEngine`` on
    the replica's device and stream, drains the inbox into the engine, steps
    it, and streams tokens back to the event loop. All engine state lives on
    this thread; the server communicates only through the locked inbox + wake
    event (in) and ``loop.call_soon_threadsafe`` (out)."""

    def __init__(self, server: "AsyncServer", idx: int,
                 device: Optional[torch.device] = None,
                 injector: Optional[FailureInjector] = None):
        self.server = server
        self.idx = idx
        self.device = device if device is not None else server.device
        self.injector = injector
        self.inbox: collections.deque = collections.deque()
        self.lock = threading.Lock()
        self.wake = threading.Event()
        self.pause_flag = threading.Event()
        self.stop_flag = threading.Event()
        self.ready = threading.Event()
        self.tracked: Dict[int, _Record] = {}      # engine rid -> record
        self.health = ReplicaHealth()
        self.tracker = RestartTracker(max_restarts=server.max_restarts)
        self.total_steps = 0                       # survives restarts
        self.params = None                         # this replica's params (its device)
        self.stream: Optional["torch.cuda.Stream"] = None   # survives restarts
        self.engine: Optional[ServeEngine] = None
        self.thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ loop-side

    def start(self) -> None:
        self.ready.clear()
        self.thread = threading.Thread(target=self._main, daemon=True,
                                       name=f"replica-{self.idx}")
        self.thread.start()

    def post(self, rec: _Record) -> None:
        with self.lock:
            self.inbox.append(rec)
        self.wake.set()

    @property
    def load(self) -> int:
        with self.lock:
            return len(self.inbox) + len(self.tracked)

    @property
    def alive(self) -> bool:
        return self.health.state == "live"

    # ---------------------------------------------------------- thread-side

    @contextlib.contextmanager
    def _on_device(self):
        """The replica's device and CUDA stream (a no-op on the CPU); the
        stream first waits for the work that made the params."""
        if self.device.type != "cuda":
            yield
            return
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(self.server._param_stream)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield

    def _main(self) -> None:
        try:
            with torch.no_grad(), self._on_device():
                if self.params is None:
                    self.params = (self.server.params if self.device == self.server.device
                                   else _tree_to(self.server.params, self.device))
                engine = ServeEngine(self.server.cfg, self.params,
                                     config=self.server.config,
                                     quant=self.server.quant, device=self.device)
                engine.on_token = self._on_token
                self.engine = engine
                self.health.state = "live"
                self.ready.set()
                del engine
                self._loop()
        except Exception as e:      # WorkerFailure or anything else: drain
            log.warning("replica %d failed", self.idx, exc_info=e)
            err = _detach_frames(e)
        else:
            return
        self.ready.set()
        self._fail(err)

    def _loop(self) -> None:
        finished: List[EngineRequest] = []
        while not self.stop_flag.is_set():
            if self.pause_flag.is_set():
                time.sleep(0.002)
                continue
            self._drain(self.engine)
            busy = bool(self.engine.queue) or any(s is not None
                                                  for s in self.engine._slots)
            if not busy:
                self.wake.wait(timeout=0.02)
                self.wake.clear()
                continue
            if self.injector is not None:
                self.injector.check(self.total_steps)  # raises WorkerFailure
            self.total_steps += 1
            self.health.steps += 1
            finished.clear()
            with self.server._turns[self.device].turn():
                self.engine.step(finished)

    def _drain(self, engine: ServeEngine) -> None:
        while True:
            with self.lock:
                if not self.inbox:
                    return
                rec = self.inbox.popleft()
            now = time.monotonic()
            if rec.admit_t is None:
                rec.admit_t = now
            prompt = np.concatenate(
                [np.asarray(rec.req.prompt, np.int32),
                 np.asarray(rec.emitted, np.int32)]) \
                if rec.emitted else np.asarray(rec.req.prompt, np.int32)
            max_new = rec.req.max_new - len(rec.emitted)
            try:
                ereq = engine.submit([prompt], max_new=max_new)[0]
            except ValueError as e:     # e.g. prompt longer than the cache
                # count before posting: a consumer that saw the terminal frame
                # must find the counters already settled
                self.server._note_done(rec, completed=False)
                self._post(rec, StreamEvent(kind="error", rid=rec.rid,
                                            error=str(e)))
                continue
            with self.lock:
                self.tracked[ereq.rid] = rec

    def _on_token(self, r: EngineRequest, tok: int) -> None:
        rec = self.tracked.get(r.rid)
        if rec is None:
            return
        now = time.monotonic()
        if rec.first_t is None:
            rec.first_t = now
        rec.last_t = now
        rec.emitted.append(int(tok))
        rec.prefix_reused = max(rec.prefix_reused, r.prefix_reused)
        self._post(rec, StreamEvent(kind="token", rid=rec.rid, token=int(tok)))
        if r.done:
            with self.lock:
                del self.tracked[r.rid]
            self._finish(rec, r.finish_reason)

    def _finish(self, rec: _Record, reason: FinishReason) -> None:
        n = len(rec.emitted)
        kp = None
        if self.server.kernel_stats:
            kp = self.server._kernel_proportion(
                np.concatenate([np.asarray(rec.req.prompt, np.int32),
                                np.asarray(rec.emitted, np.int32)]),
                params=self.params)
        m = RequestMetrics(
            queue_wait_s=(rec.admit_t or rec.submit_t) - rec.submit_t,
            ttft_s=(rec.first_t - rec.submit_t) if rec.first_t else 0.0,
            tpot_s=((rec.last_t - rec.first_t) / (n - 1)
                    if n > 1 and rec.first_t else 0.0),
            n_tokens=n, prefix_reused=rec.prefix_reused,
            replica=self.idx, requeues=rec.requeues, kernel_proportion=kp)
        # count before posting the terminal frame: a consumer that saw it must
        # find the counters already settled
        self.server._note_done(rec, completed=True, metrics=m)
        self._post(rec, StreamEvent(kind="finished", rid=rec.rid,
                                    finish_reason=reason, metrics=m))

    def _post(self, rec: _Record, ev: StreamEvent) -> None:
        self.server._loop.call_soon_threadsafe(rec.queue.put_nowait, ev)

    def _fail(self, err: BaseException) -> None:
        """Terminal path of a dying replica thread: snapshot every request this
        replica still owed tokens to, drop the engine, then hand the requests
        to the event loop."""
        self.health.state = "restarting"
        self.health.last_error = f"{type(err).__name__}: {err}"
        with self.lock:
            queued = list(self.inbox)
            self.inbox.clear()
            interrupted = list(self.tracked.values()) + queued
            self.tracked.clear()
        self.engine = None
        log.warning("replica %d failed (%s); draining %d in-flight request(s)",
                    self.idx, err, len(interrupted))
        self.server._loop.call_soon_threadsafe(
            self.server._handle_replica_failure, self, interrupted, err)


class AsyncServer:
    """Async front end over ``replicas`` ServeEngine replicas (DESIGN.md §3.11).

    ``config`` is the shared :class:`EngineConfig` every replica serves;
    ``router`` picks the placement policy (``"affinity"`` / ``"least-loaded"``
    / ``"random"``); ``max_queue`` bounds server-wide in-flight requests
    (default ``2 × replicas × batch_size``) with ``admission_timeout`` seconds
    of grace before an :class:`AdmissionError`; ``injectors`` maps replica
    index → :class:`FailureInjector` for fault-injection tests.
    ``device`` ("cuda" by default; "cpu" runs the plain versions) is where
    ``params`` must live; ``devices="auto"`` pins replica *i* to ``cuda:i`` when
    the process sees at least ``replicas`` cards (a single card is shared), or
    pass a list of devices. ``kernel_stats=True`` replays each finished request
    eagerly to report the paper's §4.1 kernel proportion in its metrics. Use as
    an async context manager, or call :meth:`start` / :meth:`aclose`
    explicitly.
    """

    def __init__(self, cfg: ModelConfig, params, *, config: EngineConfig,
                 replicas: int = 2, quant: Optional[ql.QuantConfig] = None,
                 router: str = "affinity", max_queue: Optional[int] = None,
                 admission_timeout: float = 1.0, max_restarts: int = 2,
                 injectors: Optional[Dict[int, FailureInjector]] = None,
                 devices="auto", kernel_stats: bool = False,
                 router_seed: int = 0, device="cuda"):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.device = resolve_device(device)
        if _first_tensor(params).device != self.device:
            raise ValueError(f"params live on {_first_tensor(params).device}, "
                             f"server device is {self.device}")
        self.cfg, self.params = cfg, params
        self.config = config
        self.quant = quant
        self.max_restarts = max_restarts
        self.kernel_stats = kernel_stats
        self.max_queue = max_queue or 2 * replicas * config.batch_size
        self.admission_timeout = admission_timeout
        self.router = PrefixRouter(replicas, config.page_size, policy=router,
                                   seed=router_seed)
        # the stream that made the params: every replica stream waits on it
        self._param_stream = (torch.cuda.current_stream(self.device)
                              if self.device.type == "cuda" else None)
        if devices == "auto":
            devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                    if self.device.type == "cuda" else [])
        else:
            devs = [resolve_device(d) for d in devices or []]
        pin = len(devs) >= replicas
        inj = injectors or {}
        self.replicas = [_Replica(self, i, device=devs[i] if pin else None,
                                  injector=inj.get(i))
                         for i in range(replicas)]
        self._turns = {r.device: _Turns() for r in self.replicas}
        self.counters = {"submitted": 0, "completed": 0, "rejected": 0,
                         "errors": 0, "requeued": 0, "restarts": 0,
                         "routed": 0}
        self._ttfts: List[float] = []
        self._tpots: List[float] = []
        self._stats_lock = threading.Lock()   # counters vs replica threads
        self._inflight = 0
        self._next_rid = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._cond: Optional[asyncio.Condition] = None
        self._started = False

    # -------------------------------------------------------------- lifecycle

    async def start(self) -> "AsyncServer":
        if self._started:
            return self
        self._loop = asyncio.get_running_loop()
        self._cond = asyncio.Condition()
        for r in self.replicas:
            r.start()
        for r in self.replicas:
            await self._loop.run_in_executor(None, r.ready.wait)
        self._started = True
        return self

    async def aclose(self) -> None:
        for r in self.replicas:
            r.stop_flag.set()
            r.wake.set()
        for r in self.replicas:
            if r.thread is not None:
                await self._loop.run_in_executor(None, r.thread.join)
            r.engine = None         # free the caches now, not when the cycle is collected
        self._started = False

    async def __aenter__(self) -> "AsyncServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    def pause(self) -> None:
        """Freeze every replica's engine loop (deterministic backpressure /
        routing tests); in-flight state is kept, nothing is dropped."""
        for r in self.replicas:
            r.pause_flag.set()

    def resume(self) -> None:
        for r in self.replicas:
            r.pause_flag.clear()
            r.wake.set()

    # -------------------------------------------------------------- admission

    def _worst_case_pages(self, request: Request) -> int:
        """The page reservation ``engine._plan_paged`` will commit for this
        request: every prompt token plus all-but-one generated token, capped at
        ``max_len``, rounded up to whole pages."""
        cfg = self.config
        toks = min(len(request.prompt) + max(request.max_new - 1, 0), cfg.max_len)
        return -(-toks // cfg.page_size)

    def _pool_blocked(self, request: Request) -> bool:
        """Paged layouts: True when no alive replica could cover the request's
        worst-case page reservation right now — counting free pages plus the
        radix-retained pages the engine's LRU eviction could reclaim (pages
        whose only reference is the cache itself; anything a live sequence
        holds is not reclaimable by waiting)."""
        if self.config.cache_layout != "paged":
            return False
        need = self._worst_case_pages(request)
        seen = False
        for r in self.replicas:
            eng = r.engine
            if not r.alive or eng is None or getattr(eng, "pool", None) is None:
                continue
            seen = True
            avail = eng.pool.free_count
            if eng.radix is not None:
                avail += sum(1 for p in eng.radix.held_pages()
                             if eng.pool.refs[p] == 1)
            if avail >= need:
                return False
        return seen

    async def submit(self, request: Request) -> AsyncIterator[StreamEvent]:
        """Stream one request: yields per-token ``StreamEvent`` frames and
        terminates after the ``finished`` (or ``error``) frame. Raises
        :class:`AdmissionError` when admission backpressure — ``max_queue``
        in-flight requests, or (paged layouts) no replica page pool able to
        cover the request's worst-case reservation — holds past
        ``admission_timeout`` seconds; ``AdmissionError.reason`` says which."""
        if not self._started:
            raise RuntimeError("call start() / use 'async with' first")
        rid = request.rid or f"req-{self._next_rid}"
        self._next_rid += 1
        t0 = time.monotonic()
        deadline = t0 + self.admission_timeout
        async with self._cond:
            while True:
                queue_ok = self._inflight < self.max_queue
                if queue_ok and not self._pool_blocked(request):
                    break
                reason = "queue_full" if not queue_ok else "pool_pressure"
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    with self._stats_lock:
                        self.counters["rejected"] += 1
                    what = (f"admission queue full ({self.max_queue} in flight)"
                            if reason == "queue_full" else
                            f"page-pool pressure ({self._worst_case_pages(request)}"
                            f" pages needed, no alive replica can cover it)")
                    raise AdmissionError(
                        f"{what} past {self.admission_timeout:.3g}s deadline",
                        queue_wait_s=time.monotonic() - t0, reason=reason)
                try:
                    # In-flight count changes notify this condition; page-pool
                    # occupancy changes on the replica threads, which do not —
                    # so wait on a short tick and re-poll the pools.
                    await asyncio.wait_for(self._cond.wait(),
                                           timeout=min(remaining, 0.05))
                except asyncio.TimeoutError:
                    pass
            self._inflight += 1
        with self._stats_lock:
            self.counters["submitted"] += 1
        rec = _Record(req=request, rid=rid, queue=asyncio.Queue(),
                      submit_t=t0)
        try:
            self._dispatch(rec)
            while True:
                ev = await rec.queue.get()
                yield ev
                if ev.terminal:
                    break
        finally:
            async with self._cond:
                self._inflight -= 1
                self._cond.notify_all()

    def _dispatch(self, rec: _Record,
                  exclude: Optional[int] = None) -> None:
        """Place a record on a replica (router policy or ``replica_hint``),
        or emit a terminal error when no replica is alive."""
        alive = [r.idx for r in self.replicas
                 if r.alive and r.idx != exclude]
        if not alive:
            with self._stats_lock:
                self.counters["errors"] += 1
            rec.queue.put_nowait(StreamEvent(
                kind="error", rid=rec.rid, error="no live replica"))
            return
        hint = rec.req.replica_hint
        if hint is not None and hint in alive:
            target = hint
        else:
            prompt = np.asarray(rec.req.prompt, np.int32)
            load = {r.idx: r.load for r in self.replicas}
            target = self.router.route(prompt, alive, load)
            self.router.note(prompt, target)
        with self._stats_lock:
            self.counters["routed"] += 1
        rec.replica = target
        self.replicas[target].post(rec)

    # ---------------------------------------------------------------- failure

    def _handle_replica_failure(self, replica: _Replica,
                                interrupted: List[_Record],
                                err: BaseException) -> None:
        """Event-loop side of a replica death: requeue every interrupted
        request onto a survivor as a prompt+emitted continuation (token-exact
        under greedy decoding — already-streamed tokens stand, the survivor
        re-prefills and continues), then restart the replica unless its
        budget is exhausted. The failed thread dropped its engine before
        posting this, so the restart builds into freed memory."""
        with self._stats_lock:
            self.counters["restarts"] += 1
        self.router.forget(replica.idx)
        for rec in interrupted:
            rec.requeues += 1
            with self._stats_lock:
                self.counters["requeued"] += 1
            if rec.req.max_new - len(rec.emitted) <= 0:
                # the failing step emitted the last token but died before the
                # finished frame went out: close the stream as LENGTH
                rec.queue.put_nowait(StreamEvent(
                    kind="finished", rid=rec.rid,
                    finish_reason=FinishReason.LENGTH,
                    metrics=RequestMetrics(n_tokens=len(rec.emitted),
                                           replica=replica.idx,
                                           requeues=rec.requeues)))
                continue
            self._dispatch(rec, exclude=replica.idx)
        try:
            replica.tracker.record(err, what=f"replica {replica.idx}")
        except RuntimeError:
            replica.health.state = "dead"
            log.error("replica %d is dead (restart budget exhausted)",
                      replica.idx)
            return
        replica.health.restarts += 1
        replica.start()     # fresh thread + fresh engine; state goes live
                            # once the engine is rebuilt (ready event)

    # ---------------------------------------------------------------- metrics

    def _note_done(self, rec: _Record, *, completed: bool,
                   metrics: Optional[RequestMetrics] = None) -> None:
        # called from replica threads: dict-entry += is not atomic across
        # threads, so all counter mutation goes through one lock
        with self._stats_lock:
            self.counters["completed" if completed else "errors"] += 1
            if metrics is not None:
                self._ttfts.append(metrics.ttft_s)
                if metrics.n_tokens > 1:
                    self._tpots.append(metrics.tpot_s)

    def _kernel_proportion(self, tokens: np.ndarray, params=None) -> float:
        """Paper §4.1 per-request quantization-kernel proportion: replay the
        request's served tokens eagerly (on ``params``, the calling replica's
        copy; default the server's) with an activation observer and return the
        mean CrossQuant kernel fraction across quantized linears."""
        params = self.params if params is None else params
        quant = self.quant or self.cfg.quant
        bits = getattr(quant, "a_bits", 8) or 8
        alpha = getattr(quant, "alpha", 0.15)
        obs = _KernelProportionObserver(bits, alpha)
        dev = _first_tensor(params).device
        M.apply(params, {"tokens": torch.as_tensor(tokens[None], dtype=torch.int64,
                                                   device=dev)},
                self.cfg, ctx=QuantContext(quant, observer=obs), mode="train",
                unroll=True)
        return float(np.mean(obs.fracs)) if obs.fracs else 0.0

    def metrics(self) -> dict:
        """Fleet metrics snapshot: server counters, request-latency aggregates
        and per-replica health + engine stats (the stable ``EngineStats``
        ``to_dict()`` schema)."""
        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else 0.0
        with self._stats_lock:
            ttfts, tpots = list(self._ttfts), list(self._tpots)
            counters = dict(self.counters)
        reps = []
        for r in self.replicas:
            d = r.health.to_dict()
            d["load"] = r.load
            eng = r.engine
            d["engine"] = eng.stats().to_dict() if eng is not None else None
            reps.append(d)
        return {
            "server": {**counters,
                       "affinity_hits": self.router.affinity_hits,
                       "inflight": self._inflight,
                       "max_queue": self.max_queue},
            "latency": {"ttft_p50_s": pct(ttfts, 50),
                        "ttft_p95_s": pct(ttfts, 95),
                        "tpot_p50_s": pct(tpots, 50),
                        "tpot_p95_s": pct(tpots, 95)},
            "replicas": reps,
        }
