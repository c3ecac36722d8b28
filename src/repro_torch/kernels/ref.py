"""Plain-torch oracles for the kernels (the correctness references).

The twin of ``repro/kernels/ref.py``.
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


def attention_ref(
    q: torch.Tensor,  # (sq, d)
    k: torch.Tensor,  # (skv, d)
    v: torch.Tensor,  # (skv, d)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Single-head attention oracle with causal/sliding-window masking and
    logit soft-capping (gemma2-style tanh cap), in f32.

    q_offset: absolute position of q[0] relative to k[0] (for decode where
    the query block sits at the end of the KV range).  Fully masked rows
    (possible with tiny windows) give zeros, not NaN.  Leading batch/head
    dims broadcast.
    """
    sq, d = q.shape[-2:]
    skv = k.shape[-2]
    if scale is None:
        scale = d**-0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    return torch.matmul(p, v.float()).to(q.dtype)
