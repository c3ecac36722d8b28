"""repro_torch.serving — batched KV-cache serving engine."""
from repro_torch.serving.engine import GenerationConfig, ServingEngine

__all__ = ["GenerationConfig", "ServingEngine"]
