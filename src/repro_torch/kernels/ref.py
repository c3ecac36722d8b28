"""Plain-torch oracles for the kernels (the correctness references).

The twin of ``repro/kernels/ref.py``.  ``attention_ref`` arrives with the
attention kernel's slice.
"""
from __future__ import annotations

import torch


def block_spgemm_ref(
    a_blocks: torch.Tensor,  # (ni, nk, bs_r, bs_k)
    b_blocks: torch.Tensor,  # (nk, nj, bs_k, bs_c)
    pair_ok: torch.Tensor,  # (ni, nk, nj) bool — on-the-fly filter mask
    *,
    storage_dtype=None,
    out_dtype=None,
) -> torch.Tensor:
    """Filtered block-sparse matmul: C_ij = sum_k ok[i,k,j] * A_ik @ B_kj.

    The mixed-precision oracle: operands are (optionally) rounded to
    ``storage_dtype`` first, every product accumulates in f32, and the
    result is cast to ``out_dtype`` (default: the storage dtype).  bf16
    storage stays within ~3e-2 of the f32 oracle for unit-scaled blocks.

    Contracts the full (i, k, j) cube in one einsum: for test sizes only.
    f32 matmuls must run in full f32 (``torch.backends.cuda.matmul.
    allow_tf32`` False, PyTorch's default) for the stated tolerances.
    """
    if storage_dtype is not None:
        a_blocks = a_blocks.to(storage_dtype)
        b_blocks = b_blocks.to(storage_dtype)
    if out_dtype is None:
        out_dtype = a_blocks.dtype
    okf = pair_ok.to(torch.float32)
    c = torch.einsum(
        "ikj,ikab,kjbc->ijac",
        okf,
        a_blocks.to(torch.float32),
        b_blocks.to(torch.float32),
    )
    return c.to(out_dtype)
