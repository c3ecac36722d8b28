"""olmo-1b [dense] — non-parametric LayerNorm.  [arXiv:2402.00838; hf]
long_500k SKIPPED (full attention)."""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    mlp="swiglu",
    norm="nonparametric_ln",
    tie_embeddings=True,
    source="arXiv:2402.00838",
)
