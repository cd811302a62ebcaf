"""Deterministic synthetic data (copy of ``repro/data/synthetic.py``; numpy only).

1. **Markov corpus**: token sequences from a fixed sparse first-order Markov chain,
   which small models learn quickly.
2. **Outlier-planted activation ensembles**: activation matrices X (T × I) with the
   outlier statistics the paper builds on (App. A): a small fraction of channels
   carries values many times the typical magnitude. The OPT-like regime plants
   stronger and more outliers than the LLaMA-like one.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

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


@dataclasses.dataclass(frozen=True)
class OutlierSpec:
    """Statistics of the planted outlier channels.

    ``frac_channels``: fraction of channels that are outlier channels (paper: ~0.1 %).
    ``magnitude``: outlier scale relative to the base std (paper: ≥20×).
    ``row_frac``: fraction of rows (tokens) in which an outlier channel fires.
    """
    frac_channels: float = 0.001
    magnitude: float = 40.0
    row_frac: float = 0.7
    base_std: float = 1.0


# the paper's two model families (Fig. 4): OPT's activations carry many and strong
# outliers, LLaMA's milder ones
OPT_LIKE = OutlierSpec(frac_channels=0.004, magnitude=80.0, row_frac=0.9)
LLAMA_LIKE = OutlierSpec(frac_channels=0.001, magnitude=20.0, row_frac=0.3)


def outlier_activations(n_tokens: int, n_channels: int, spec: OutlierSpec = OPT_LIKE,
                        *, seed: int = 0, laplace: bool = True) -> np.ndarray:
    """(T, I) float32 activation matrix with planted outlier channels: Laplace (or
    normal) base values; outlier channels get ``magnitude``× values on ``row_frac``
    of rows."""
    rng = np.random.default_rng(seed)
    if laplace:
        x = rng.laplace(0.0, spec.base_std / np.sqrt(2), size=(n_tokens, n_channels))
    else:
        x = rng.normal(0.0, spec.base_std, size=(n_tokens, n_channels))
    n_out = max(1, int(round(spec.frac_channels * n_channels)))
    out_ch = rng.choice(n_channels, size=n_out, replace=False)
    fire = rng.random((n_tokens, n_out)) < spec.row_frac
    boost = rng.normal(0.0, spec.base_std * spec.magnitude, size=(n_tokens, n_out))
    x[:, out_ch] = np.where(fire, boost, x[:, out_ch])
    return x.astype(np.float32)


def calibration_set(n_batches: int, n_tokens: int, n_channels: int,
                    spec: OutlierSpec = OPT_LIKE, *, seed: int = 0
                    ) -> Iterator[np.ndarray]:
    for b in range(n_batches):
        yield outlier_activations(n_tokens, n_channels, spec, seed=seed + 17 * b)
