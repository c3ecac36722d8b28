"""qwen2-72b [dense] — GQA with QKV bias; the biggest dense TP case.
[arXiv:2407.10671; hf]  long_500k SKIPPED (full attention)."""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    mlp="swiglu",
    norm="rmsnorm",
    source="arXiv:2407.10671",
)
