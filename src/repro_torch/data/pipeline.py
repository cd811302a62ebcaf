"""Deterministic host batches (copy of ``make_train_batches`` from
``repro/data/pipeline.py``; numpy only)."""
from __future__ import annotations

from typing import Callable, Dict

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
