"""repro_torch.optim — AdamW, LR schedules, gradient clipping and
gradient compression with error feedback (the twin of ``repro.optim``);
``compressed_allreduce`` and ``sharded_global_norm`` serve the sharded
step on a mesh of ranks."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
    sharded_global_norm,
)
from repro_torch.optim.compress import (
    CompressState,
    compress_grads,
    compressed_allreduce,
    init_compress_state,
)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWConfig",
    "CompressState",
    "adamw_init",
    "adamw_update",
    "compress_grads",
    "compressed_allreduce",
    "cosine_schedule",
    "global_norm",
    "init_compress_state",
    "linear_warmup_cosine",
    "sharded_global_norm",
]
