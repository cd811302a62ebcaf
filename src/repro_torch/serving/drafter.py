"""Self-drafting prompt-lookup (n-gram) drafter for speculative decoding.

A verbatim copy of ``repro/serving/drafter.py``, which is framework-free.

DESIGN.md §3.9: the draft model *is* the request's own token history. To
propose a continuation the drafter takes the longest n-gram ending at the
history's tail (the pending token is always history[-1] — it was sampled but
not yet fed through the model), finds that n-gram's most recent *earlier*
occurrence, and proposes the tokens that followed it. No second model, no
extra device state: draft quality comes entirely from repetition in the
prompt + generated stream, which is exactly the regime (templated prompts,
code, retrieval-stuffed contexts) where speculative decoding pays.

The proposal is free to be wrong — the verify step scores the whole window
and the engine's greedy acceptance rule keeps output token-exact vs
non-speculative decode (tests/test_speculative.py) — so the drafter never
needs probabilities, only cheap host-side token matching.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_EMPTY = np.zeros((0,), np.int32)


@dataclasses.dataclass
class NGramDrafter:
    """Prompt-lookup drafter: longest-suffix n-gram match over the history.

    ``max_ngram`` bounds the suffix pattern length tried (longest first — a
    longer match is a stronger continuation signal); ``draft`` returns at most
    ``n`` tokens and degrades to an empty proposal on a miss, so the engine
    falls back to plain single-token decode for that slot.
    """
    max_ngram: int = 3

    def draft(self, history: np.ndarray, n: int) -> np.ndarray:
        """Propose ≤ n tokens continuing ``history`` (1-D int array; the last
        element is the pending token). Empty on a miss or degenerate input."""
        history = np.asarray(history)
        L = len(history)
        if n <= 0 or L < 2:
            return _EMPTY
        for size in range(min(self.max_ngram, L - 1), 0, -1):
            # all earlier occurrences of the tail n-gram at once (the drafter
            # runs on the host once per slot per verify step — a python scan
            # over starts costs as much as the step itself on small models)
            windows = np.lib.stride_tricks.sliding_window_view(history, size)
            pat = history[L - size:]
            starts = np.flatnonzero((windows[:L - size] == pat).all(axis=1))
            if starts.size == 0:
                continue
            # most recent occurrence *with a full n-token continuation*;
            # occurrences near the tail have their continuation truncated by
            # the end of the history — on a loop of period p < n the nearest
            # match is only p back and would cap every draft at p tokens,
            # while an occurrence one period earlier proposes the same loop at
            # full window length. Falls back to the most recent occurrence
            # (start + size ≤ L - 1, so at least one continuation token
            # always follows) when no full one exists.
            full = starts[starts + size + n <= L]
            best = int(full[-1] if full.size else starts[-1])
            return np.asarray(history[best + size: best + size + n], np.int32)
        return _EMPTY
