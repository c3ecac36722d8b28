"""gemma2-27b [dense] — alternating local(4096)/global attention, logit
soft-capping, sandwich norms.  [arXiv:2408.00118; hf]

long_500k is SKIPPED: the global layers are full attention."""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    mlp="geglu",
    norm="rmsnorm",
    post_norm=True,  # sandwich (pre+post) norms
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    window_pattern=2,  # local every other layer
    source="arXiv:2408.00118",
)
