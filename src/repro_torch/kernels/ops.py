"""Public wrappers for the port's kernels (the twin of
``repro/kernels/ops.py``).

There is no ``interpret`` switch: each wrapper runs its CUDA kernel on CUDA
tensors and its plain PyTorch version on CPU tensors.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.block_spgemm import block_spgemm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.stacks import ProductStacks  # noqa: F401  (re-export)

__all__ = ["block_spgemm", "flash_attention", "ref"]
