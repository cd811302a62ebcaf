"""repro_torch.launch (port of repro.launch)."""
