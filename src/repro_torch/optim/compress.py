"""Gradient compression with exact error feedback — the twin of
``repro/optim/compress.py``'s ``compress_grads``.

The payload is cast to bf16; an f32 residual per parameter keeps the
quantization error of step t and adds it back at step t + 1, so the sum
of applied updates telescopes to the true gradient sum.  On one device
there is no collective to shrink: the train step applies the compression
as the reference's does on a 1 x 1 mesh, so both give the same update.
``compressed_allreduce_shardmap`` (the bf16 mean over the data axis)
comes with a data axis (ROADMAP.md Queue A item 15b).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.tree import tree_map

CompressState = Any  # a tree of f32 residuals, shaped as the grads


def init_compress_state(params: Any) -> CompressState:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compress_grads(grads: Any, residual: CompressState,
                   dtype=torch.bfloat16) -> tuple[Any, CompressState]:
    """(compressed grads in ``dtype``, new residual):
    g_c = cast(g + r); r' = g + r - g_c."""

    def one(g, r):
        corrected = g.float() + r
        q = corrected.to(dtype)
        return q, corrected - q.float()

    out = tree_map(one, grads, residual)
    return (tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out))
