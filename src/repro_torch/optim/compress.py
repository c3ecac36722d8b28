"""Gradient compression with exact error feedback — the twin of
``repro/optim/compress.py``'s ``compress_grads``.

The payload is cast to bf16; an f32 residual per parameter keeps the
quantization error of step t and adds it back at step t + 1, so the sum
of applied updates telescopes to the true gradient sum.  On one device
there is no collective to shrink: the train step applies the compression
as the reference's does on a 1 x 1 mesh, so both give the same update.

``compressed_allreduce`` is the twin of ``compressed_allreduce_shardmap``
on a mesh of ranks: each rank compresses its own gradient with its own f32
residual, and the bf16 payloads are averaged (or summed) over the data
axis — half the bytes of an f32 all-reduce.  The sharded train step
(``launch/steps.py``) syncs its data-replicated gradients through it under
``compress_grads``.
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


@torch.no_grad()
def compressed_allreduce(mesh, grads: Any, residual: CompressState, *,
                         axis="data", dtype=torch.bfloat16,
                         mean: bool = True) -> tuple[Any, CompressState]:
    """(synced f32 grads, residual') on a mesh of ranks: trees whose
    leaves are ``parallel.sharding.Shards`` (one tensor per rank).  Each
    rank's payload is ``compress_grads`` of its gradient and residual; the
    payloads are summed in ``dtype`` over ``axis`` (``transport.psum``;
    divided by the group size when ``mean``, the reference's ``pmean``)
    and widened to f32."""
    from repro_torch.core import transport as TR
    from repro_torch.parallel.sharding import Shards

    n = len(mesh.groups(axis)[0])

    def one(g, r):
        q, res = zip(*(compress_grads(a, b, dtype) for a, b in zip(g, r)))
        total = TR.psum(mesh, list(q), axis)
        return (Shards((t / n if mean else t).float() for t in total),
                Shards(res))

    out = tree_map(one, grads, residual)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)
