"""Carry block-sparse matrices between the JAX package and the port.

Both sides meet at numpy: ``bsm_from_arrays`` builds the port's matrix from
``np.asarray`` of each field of the reference's ``BlockSparseMatrix``, and
``bsm_to_numpy`` goes the other way.  No jax import here.

JAX's bf16 arrays come out of ``np.asarray`` as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` rejects; they cross as float32 and are cast to
``torch.bfloat16`` — exact, since every bf16 value is a float32 value.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import resolve_device
from repro_torch.core.bsm import BlockSparseMatrix


def _to_tensor(x, device) -> torch.Tensor:
    a = np.array(x)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(a).to(device)


def bsm_from_arrays(blocks, mask, norms, *, device=None) -> BlockSparseMatrix:
    """The port's matrix from the three numpy fields (bit-exact)."""
    dev = resolve_device(device)
    return BlockSparseMatrix(
        blocks=_to_tensor(blocks, dev),
        mask=_to_tensor(mask, dev).to(torch.bool),
        norms=_to_tensor(norms, dev).to(torch.float32),
    )


def bsm_to_numpy(m: BlockSparseMatrix) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(blocks, mask, norms) as numpy; bf16 blocks come back as float32
    (exact), since numpy has no bfloat16 of its own."""
    blocks = m.blocks
    if blocks.dtype == torch.bfloat16:
        blocks = blocks.to(torch.float32)
    return (blocks.cpu().numpy(), m.mask.cpu().numpy(), m.norms.cpu().numpy())
