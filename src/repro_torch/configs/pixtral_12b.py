"""pixtral-12b [vlm] — Pixtral ViT frontend (stub) + Mistral-Nemo-style
decoder.  [hf:mistralai/Pixtral-12B-2409; unverified]"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    mlp="swiglu",
    norm="rmsnorm",
    frontend="vision",
    n_patches=256,
    rope=True,
    rope_theta=1_000_000_000.0,
    source="hf:mistralai/Pixtral-12B-2409 (unverified)",
)
