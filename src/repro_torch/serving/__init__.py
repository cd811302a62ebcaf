"""repro_torch.serving (port of repro.serving)."""
