"""repro_torch.launch — the port's entry points (purification, serving)."""
