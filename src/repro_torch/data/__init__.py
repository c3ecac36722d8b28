"""repro_torch.data — the deterministic synthetic token pipeline."""
from repro_torch.data.pipeline import DataConfig, SyntheticLMData, make_global_batch

__all__ = ["DataConfig", "SyntheticLMData", "make_global_batch"]
