"""Data substrate: deterministic synthetic corpora, outlier-planted activation
ensembles (the paper's App. A statistics), and a host loader with prefetch
(numpy only)."""
from repro_torch.data.synthetic import (  # noqa: F401
    markov_corpus, outlier_activations, OutlierSpec,
)
from repro_torch.data.pipeline import HostDataLoader, make_train_batches  # noqa: F401
