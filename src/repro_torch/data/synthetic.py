"""Deterministic synthetic token corpus (copy of the Markov-chain part of
``repro/data/synthetic.py``; numpy only)."""
from __future__ import annotations

import numpy as np


def _chain(vocab: int, branching: int, seed: int) -> np.ndarray:
    """Sparse transition table: each token can be followed by `branching` tokens."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab, branching))


def markov_corpus(vocab: int, seq_len: int, n_seqs: int, *, branching: int = 4,
                  seed: int = 0, skew: float = 0.0, chain_seed: int = 0) -> np.ndarray:
    """(n_seqs, seq_len) int32 token array, deterministic in ``seed``; the
    transition table depends only on ``chain_seed``."""
    nxt = _chain(vocab, branching, chain_seed)
    rng = np.random.default_rng(seed + 1)
    out = np.empty((n_seqs, seq_len), np.int32)
    tok = rng.integers(0, vocab, size=n_seqs)
    for t in range(seq_len):
        out[:, t] = tok
        if skew > 0:
            take_mode = rng.random(n_seqs) < skew
            pick = np.where(take_mode, 0, rng.integers(0, branching, size=n_seqs))
        else:
            pick = rng.integers(0, branching, size=n_seqs)
        tok = nxt[tok, pick]
    return out
