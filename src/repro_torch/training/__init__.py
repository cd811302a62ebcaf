"""Training: AdamW, gradient compression and the train step (port of
``repro/training``)."""
from repro_torch.training.optimizer import (  # noqa: F401
    AdamWConfig, OptState, apply_updates, init as opt_init)
