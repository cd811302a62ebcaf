"""Straggler mitigation: per-step host heartbeats + a p-quantile deadline barrier
(copy of ``repro/runtime/straggler.py``; numpy only).

At pod scale, a single slow host (thermal throttling, a bad HBM stack, a noisy
neighbour on shared NICs) serializes every synchronous collective. The deployable
mechanism:

  * every host reports a per-step heartbeat duration;
  * the barrier computes a deadline = quantile(history, p) × slack;
  * hosts exceeding the deadline are marked *suspect*; ``k`` consecutive misses
    escalates to the supervisor, which triggers a reconfiguration that excludes
    the host (``Supervisor.run``'s ``rebuild`` hook).

The single-process edition drives it with simulated per-host durations (injected
delays in tests); the accounting, thresholds and escalation logic are the deployable
part — on a real cluster the durations come from the coordinator's RPC layer.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class HeartbeatTracker:
    """Sliding window of per-host step durations."""
    n_hosts: int
    window: int = 64

    def __post_init__(self):
        self._hist: List[collections.deque] = [
            collections.deque(maxlen=self.window) for _ in range(self.n_hosts)]

    def report(self, host: int, duration: float) -> None:
        self._hist[host].append(duration)

    def all_durations(self) -> np.ndarray:
        flat = [d for h in self._hist for d in h]
        return np.asarray(flat if flat else [0.0])


class DeadlineBarrier:
    """p99-style deadline barrier with consecutive-miss escalation.

    ``step(durations)`` ingests one step's per-host durations and returns the set of
    hosts to evict (those with ≥ ``evict_after`` consecutive deadline misses).
    """

    def __init__(self, n_hosts: int, *, quantile: float = 0.99, slack: float = 1.5,
                 evict_after: int = 3, min_history: int = 8):
        self.tracker = HeartbeatTracker(n_hosts)
        self.quantile = quantile
        self.slack = slack
        self.evict_after = evict_after
        self.min_history = min_history
        self.misses = np.zeros(n_hosts, np.int32)
        self.suspect: set = set()

    def deadline(self) -> Optional[float]:
        hist = self.tracker.all_durations()
        if hist.size < self.min_history:
            return None                       # not enough signal yet
        return float(np.quantile(hist, self.quantile) * self.slack)

    def step(self, durations: Sequence[float]) -> Dict[str, object]:
        dl = self.deadline()
        evict: List[int] = []
        for host, dur in enumerate(durations):
            late = dl is not None and dur > dl
            if late:
                self.misses[host] += 1
                self.suspect.add(host)
            else:
                self.misses[host] = 0
                self.suspect.discard(host)
            if self.misses[host] >= self.evict_after:
                evict.append(host)
            # Late hosts' durations poison the quantile if recorded raw; record the
            # deadline instead (standard winsorization).
            self.tracker.report(host, min(dur, dl) if dl is not None else dur)
        return {"deadline": dl, "suspect": set(self.suspect), "evict": evict}
