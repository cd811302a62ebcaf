"""Checkpoints with atomic commits, integrity checks and async writes."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
