"""rwkv6-7b "Finch" [ssm] — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]  Runs long_500k (O(1) recurrent state)."""
from repro_torch.config import ArchConfig, RWKVConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # time-mix heads = d_model / head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    mixer="rwkv6",
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, chunk=256),
    mlp="swiglu",  # unused by rwkv blocks (channel-mix replaces the MLP)
    norm="layernorm",
    rope=True,  # no positional injection needed; kept for embed path parity
    source="arXiv:2404.05892",
)
