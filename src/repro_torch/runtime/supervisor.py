"""Failure injection, restart accounting and replica health (port of the serving
half of ``repro/runtime/supervisor.py``: ``WorkerFailure``, ``FailureInjector``,
``RestartTracker``, ``ReplicaHealth``).

These classes are framework-free and copied rather than imported: the reference
module imports ``repro.checkpoint`` for its training ``Supervisor``, which the
port does not have yet. The async server (:mod:`repro_torch.serving.server`)
uses them to inject replica failures, bound restarts and report each replica's
lifecycle.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

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
    """Bounded-restart accounting for the serving front end's replica manager:
    ``record(err)`` counts one failure and raises once the budget is exhausted —
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
