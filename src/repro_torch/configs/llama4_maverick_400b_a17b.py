"""llama4-maverick-400b-a17b [moe] — 128-expert top-1 MoE with early fusion,
MoE on alternating layers (interleaved dense/MoE as in the Llama-4 family).
[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified]"""
from repro_torch.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    mlp="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(
        n_experts=128,
        top_k=1,
        n_shared=1,  # Llama-4 routes top-1 + always-on shared expert
        d_expert=8192,
        layer_period=2,  # MoE every other layer (interleaved)
        capacity_factor=1.25,
        impl="tp",
    ),
    opt_state_dtype="bfloat16",  # fp32 moments would not fit HBM at 400B
    source="hf:meta-llama/Llama-4 family (unverified)",
)
