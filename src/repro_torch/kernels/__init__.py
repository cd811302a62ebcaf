"""repro_torch.kernels (port of repro.kernels)."""
