"""repro_torch.core (port of repro.core)."""
