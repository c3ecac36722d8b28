"""repro_torch.core — block-sparse matrix format, the filtered multiply on
one device and the paper's distributed engines over a mesh of ranks, the
sign iteration and density matrix."""
