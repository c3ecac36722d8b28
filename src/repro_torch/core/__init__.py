"""repro_torch.core — block-sparse matrix format and the single-device
filtered multiply, sign iteration and density matrix."""
