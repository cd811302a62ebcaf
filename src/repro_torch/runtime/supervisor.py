"""Supervised training loop and failure accounting (port of
``repro/runtime/supervisor.py``): failure detection → restore → (possibly elastic)
rebuild → continue.

  1. the train loop body is a *worker function* the supervisor calls per step;
  2. a :class:`FailureInjector` raises :class:`WorkerFailure` at configured steps,
     the stand-in for a real node loss or preemption;
  3. on failure the supervisor (a) waits for outstanding async checkpoint writes,
     (b) restores the last committed step, (c) hands the restored state to its
     ``rebuild`` callback, and (d) resumes from the restored step;
  4. a bounded restart budget (:class:`RestartTracker`) prevents crash loops.

A run with injected failures ends with the same params as an uninterrupted run,
because (seed, step) reproduces the batches and the checkpoint restores the exact
optimizer state. The async server (:mod:`repro_torch.serving.server`) uses
:class:`FailureInjector`, :class:`RestartTracker` and :class:`ReplicaHealth` for
its replicas.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.supervisor")


class WorkerFailure(RuntimeError):
    """A worker (host/device) failed — node loss, preemption, link error."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministically raise WorkerFailure at the given steps (test/chaos hook)."""
    fail_at_steps: Sequence[int] = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise WorkerFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class RestartTracker:
    """Bounded-restart accounting shared by the training supervisor and the
    serving front end's replica manager: ``record(err)`` counts one failure and raises once the budget is exhausted —
    real controllers page a human at that point instead of crash-looping."""

    max_restarts: int = 8
    restarts: int = 0

    def record(self, err: BaseException, what: str = "worker") -> None:
        self.restarts += 1
        log.warning("%s failure (%s); restart %d/%d", what, err,
                    self.restarts, self.max_restarts)
        if self.restarts > self.max_restarts:
            raise RuntimeError(
                f"restart budget exhausted ({self.max_restarts})") from err

    @property
    def exhausted(self) -> bool:
        return self.restarts > self.max_restarts


@dataclasses.dataclass
class ReplicaHealth:
    """One serving replica's health record (serving/server.py): lifecycle
    ``state`` (``"live"`` / ``"restarting"`` / ``"dead"``), restart count,
    engine steps driven since the last restart, and the last failure seen."""

    state: str = "live"
    restarts: int = 0
    steps: int = 0
    last_error: Optional[str] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RunResult:
    state: Any
    step: int
    restarts: int
    metrics_history: List[Dict[str, float]]


class Supervisor:
    """Drives ``step_fn`` from ``start_step`` to ``total_steps`` with fault tolerance.

    step_fn(state, step) -> (state, metrics)        one training step + data fetch
    rebuild(state) -> state                          restore-time re-layout hook;
                                                     receives the restored tree.
    """

    def __init__(self, ckpt: CheckpointManager, *, ckpt_every: int = 10,
                 max_restarts: int = 8):
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts

    def run(
        self,
        state: Any,
        step_fn: Callable[[Any, int], Tuple[Any, Dict[str, float]]],
        total_steps: int,
        *,
        start_step: int = 0,
        injector: Optional[FailureInjector] = None,
        rebuild: Optional[Callable[[Any], Any]] = None,
        save_initial: bool = True,
    ) -> RunResult:
        tracker = RestartTracker(max_restarts=self.max_restarts)
        step = start_step
        history: List[Dict[str, float]] = []
        if save_initial:
            self.ckpt.save(step, state, blocking=True)

        while step < total_steps:
            try:
                if injector is not None:
                    injector.check(step)
                state, metrics = step_fn(state, step)
                history.append({"step": step, **{k: float(v) for k, v in metrics.items()}})
                step += 1
                if step % self.ckpt_every == 0 or step == total_steps:
                    self.ckpt.save(step, state)
            except WorkerFailure as e:
                tracker.record(e, what=f"worker at step {step}")
                # join outstanding async writes, then restore the last commit
                self.ckpt.wait()
                state, step = self.ckpt.restore(state)
                if rebuild is not None:
                    state = rebuild(state)
                # drop the history past the restore point: those steps run again
                history = [h for h in history if h["step"] < step]
        self.ckpt.wait()
        return RunResult(state=state, step=step, restarts=tracker.restarts,
                         metrics_history=history)
