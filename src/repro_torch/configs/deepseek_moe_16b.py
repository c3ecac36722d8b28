"""deepseek-moe-16b [moe] — fine-grained experts: 2 shared + 64 routed
top-6, d_expert=1408.  [arXiv:2401.06066; hf]"""
from repro_torch.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    mlp="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        n_shared=2,
        d_expert=1408,
        layer_period=1,  # every layer is MoE (first layer dense in hf; kept uniform)
        capacity_factor=1.3,
        impl="tp",
    ),
    source="arXiv:2401.06066",
)
