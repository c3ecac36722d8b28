"""qwen1.5-4b [dense] — QKV bias; 20 heads (deliberately indivisible by the
16-way model axis — exercises the head-replication TP fallback).
[hf:Qwen/Qwen1.5-4B; hf]  long_500k SKIPPED (full attention)."""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    mlp="swiglu",
    norm="rmsnorm",
    source="hf:Qwen/Qwen1.5-4B",
)
