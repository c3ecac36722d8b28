"""repro_torch.configs — the architecture registry of the port.

``get_arch(name)`` returns the full published config, with the aliases of
the JAX package's registry, which registers the same ten architectures:
the dense attention decoders, the MoE decoders (deepseek-moe-16b;
llama4-maverick-400b-a17b, whose 397.7 B parameters need more than one
card at full width), the recurrent ones (jamba-v0.1-52b, mamba and
attention layers with MoE, whose 51.45 B parameters need more than one
card at full depth; rwkv6-7b, attention free), the encoder-decoder
whisper-large-v3 and the early-fusion pixtral-12b.  An unknown name
raises ``KeyError``, as in the reference.
"""
from __future__ import annotations

import importlib

from repro_torch.config import ArchConfig

ARCH_IDS = (
    "pixtral_12b",
    "llama4_maverick_400b_a17b",
    "deepseek_moe_16b",
    "whisper_large_v3",
    "jamba_v0_1_52b",
    "gemma2_27b",
    "qwen2_72b",
    "olmo_1b",
    "qwen1_5_4b",
    "rwkv6_7b",
)

_ALIASES = {
    "pixtral-12b": "pixtral_12b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-large-v3": "whisper_large_v3",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "gemma2-27b": "gemma2_27b",
    "qwen2-72b": "qwen2_72b",
    "olmo-1b": "olmo_1b",
    "qwen1.5-4b": "qwen1_5_4b",
    "rwkv6-7b": "rwkv6_7b",
}


def get_arch(name: str) -> ArchConfig:
    key = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; one of {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def all_archs() -> dict[str, ArchConfig]:
    return {aid: get_arch(aid) for aid in ARCH_IDS}
