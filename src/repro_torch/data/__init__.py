"""Data substrate: deterministic synthetic corpora and host batches (numpy only)."""
from repro_torch.data.pipeline import make_train_batches  # noqa: F401
from repro_torch.data.synthetic import markov_corpus  # noqa: F401
