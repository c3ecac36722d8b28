"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave (one attention
layer per 8), MoE 16e top-2 on every other layer.  [arXiv:2403.19887; hf]"""
from repro_torch.config import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    mlp="swiglu",
    norm="rmsnorm",
    mixer="mamba_hybrid",
    attn_layer_period=8,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=256),
    moe=MoEConfig(
        n_experts=16,
        top_k=2,
        n_shared=0,
        d_expert=14336,
        layer_period=2,
        capacity_factor=1.25,
        impl="tp",
    ),
    source="arXiv:2403.19887",
)
