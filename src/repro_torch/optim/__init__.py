"""repro_torch.optim — AdamW, LR schedules, gradient clipping and
gradient compression with error feedback (the twin of ``repro.optim``).

``compressed_allreduce_shardmap`` (a bf16 mean over the data axis) waits
for a data axis: ROADMAP.md Queue A item 15b."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
)
from repro_torch.optim.compress import (
    CompressState,
    compress_grads,
    init_compress_state,
)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWConfig",
    "CompressState",
    "adamw_init",
    "adamw_update",
    "compress_grads",
    "cosine_schedule",
    "global_norm",
    "init_compress_state",
    "linear_warmup_cosine",
]
