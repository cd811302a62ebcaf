"""Deterministic host batches and a bounded background prefetcher (copy of
``repro/data/pipeline.py``; numpy only).

Each host loads only its shard of the global batch (``host_id / num_hosts``);
determinism comes from (seed, step), so a restart resumes at the exact batch
without replaying the stream, and a daemon thread keeps a bounded queue of ready
batches ahead of the training loop.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np

from repro_torch.data.synthetic import markov_corpus


def make_train_batches(vocab: int, seq_len: int, global_batch: int, *,
                       host_id: int = 0, num_hosts: int = 1, seed: int = 0,
                       ) -> Callable[[int], Dict[str, np.ndarray]]:
    """Returns ``batch_fn(step) -> {"tokens": (local_batch, seq_len) int32}``,
    deterministic in (seed, step, host_id)."""
    if global_batch % num_hosts:
        raise ValueError(f"global_batch {global_batch} not divisible by {num_hosts} hosts")
    local = global_batch // num_hosts

    def batch_fn(step: int) -> Dict[str, np.ndarray]:
        s = seed + 1_000_003 * step + 7919 * host_id
        return {"tokens": markov_corpus(vocab, seq_len, local, seed=s)}

    return batch_fn


class HostDataLoader:
    """Bounded background prefetcher around a ``batch_fn(step)``.

    ``depth`` batches are produced ahead of consumption on a daemon thread; it
    yields ``(step, batch)``. ``stop()`` is idempotent; the loader is also a context
    manager. On a worker failure the supervisor recreates the loader at the
    restored step: there is no stream state to rescue.
    """

    def __init__(self, batch_fn: Callable[[int], dict], start_step: int = 0,
                 depth: int = 2):
        self._fn = batch_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self._fn(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple]:
        return self

    def __next__(self) -> tuple:
        if self._stop.is_set():
            raise StopIteration
        return self._q.get()

    def stop(self) -> None:
        self._stop.set()
        try:                                # drain so the worker unblocks
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __enter__(self) -> "HostDataLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
