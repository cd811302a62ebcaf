"""repro_torch.models (port of repro.models)."""
