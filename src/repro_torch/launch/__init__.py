"""repro_torch.launch — the port's entry points (purification, serving)
and the meshes of ranks the SpGEMM engines run on."""
