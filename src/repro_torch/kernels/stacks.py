"""Product-list compaction: DBCSR's "stack generation" for the local stage.

The torch twin of ``repro/kernels/stacks.py``.  The boolean (ni, nk, nj)
filter cube is compacted into a padded product list — int32 index arrays
sorted by output tile with k-runs contiguous — that drives both the
``stacks`` backend (gather, batched GEMM, scatter) and the CUDA kernel
(``kernels/block_spgemm.py``).

Everything runs on the cube's device: a 512^3 cube is never walked on the
host.  The index arrays are bit-identical to the reference's, padding
included; capacities are bucketed to powers of two as there.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch


class ProductStacks(NamedTuple):
    """Padded product list over surviving (i, k, j) block triples.

    All fields are int32 tensors of shape (capacity,), sorted by output tile
    (i, j) with the k-run of each tile contiguous — padding entries repeat
    the last real triple's indices and carry ``valid == 0``.

    ia / ik / ij — block coordinates of each product (A_ik . B_kj -> C_ij)
    tile         — flattened output tile id, ``ia * nj + ij``
    first        — 1 at the first product of each tile's k-run
    write        — 1 at the last entry touching a tile
    valid        — 1 for real products, 0 for padding
    """

    ia: torch.Tensor
    ik: torch.Tensor
    ij: torch.Tensor
    tile: torch.Tensor
    first: torch.Tensor
    write: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.ia.shape[0]


def bucket_capacity(n: int, *, minimum: int = 8) -> int:
    """Round a product count up to a power-of-two bucket (``n == 0`` keeps
    capacity 0 — the empty-product-list edge case)."""
    if n <= 0:
        return 0
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def resolve_capacity(capacity: int | None, cube: int) -> int:
    """Effective capacity: None means the full cube (always sound), an
    explicit bound is clamped to it."""
    return cube if capacity is None else min(capacity, cube)


def product_count(pair_ok: torch.Tensor) -> int:
    """Number of surviving products of a filter cube (one device sync)."""
    return int(pair_ok.sum())


def pair_cube(mask_a: torch.Tensor, mask_b: torch.Tensor,
              norms_a: torch.Tensor | None = None,
              norms_b: torch.Tensor | None = None,
              threshold: float = 0.0) -> torch.Tensor:
    """(ni, nk, nj) pair-filter cube on the operands' device.

    Presence product of the operand masks, AND — when ``threshold`` is
    active — the paper's norm-product screen ``|A_ik| |B_kj| > threshold``
    (f32 products, as in the reference).
    """
    am = mask_a.to(torch.bool)
    bm = mask_b.to(torch.bool)
    ok = am[:, :, None] & bm[None, :, :]
    if threshold > 0.0 and norms_a is not None:
        an = norms_a.to(torch.float32)
        bn = norms_b.to(torch.float32)
        ok &= an[:, :, None] * bn[None, :, :] > threshold
    return ok


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # np.packbits' big-endian order


def pattern_signature(pair_ok) -> bytes:
    """Digest of a boolean pattern (a (ni, nk, nj) filter cube, or a mask)
    — the plan-cache key for product lists, capacities and transports.
    Same bytes as the reference: sha1 of the shape's tuple repr, then of
    ``np.packbits`` of the pattern.  A tensor's bits are packed on its
    device, so only size/8 bytes come to the host; a numpy pattern is
    packed by numpy."""
    if not isinstance(pair_ok, torch.Tensor):
        ok = np.asarray(pair_ok).astype(bool)
        h = hashlib.sha1(repr(ok.shape).encode())
        h.update(np.packbits(ok).tobytes())
        return h.digest()
    ok = pair_ok.to(torch.bool)
    h = hashlib.sha1(repr(tuple(ok.shape)).encode())
    flat = ok.reshape(-1).to(torch.int32)
    pad = (-flat.numel()) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=flat.device)
    packed = (flat.view(-1, 8) * w).sum(1).to(torch.uint8)
    h.update(packed.cpu().numpy().tobytes())
    return h.digest()


def compact_pair_mask(pair_ok: torch.Tensor, *, capacity: int) -> ProductStacks:
    """Compact a (ni, nk, nj) filter cube into a ``ProductStacks`` list on
    the cube's device.

    ``torch.nonzero_static`` of the (i, j, k)-ordered cube gives the
    reference's order: output tiles consecutive, k-runs contiguous, and the
    list's length is ``capacity`` without a device sync.  If more than
    ``capacity`` products survive the excess is dropped, as in the
    reference — callers supply a sound capacity (``bucket_capacity`` of
    ``product_count``).
    """
    ni, nk, nj = pair_ok.shape
    dev = pair_ok.device
    if capacity <= 0:
        z = torch.zeros((0,), dtype=torch.int32, device=dev)
        return ProductStacks(z, z, z, z, z, z, z)
    okt = pair_ok.to(torch.bool).permute(0, 2, 1).reshape(-1)
    # the n listed products first, then the fill 0
    flat = torch.nonzero_static(okt, size=capacity, fill_value=0).squeeze(1)
    n = okt.sum().clamp(max=capacity)
    slot = torch.arange(capacity, device=dev)
    valid = slot < n
    # padding repeats the last real triple (or triple 0 when none survive)
    flat = flat[torch.minimum(slot, (n - 1).clamp(min=0))]
    ia = flat // (nj * nk)
    ij = (flat // nk) % nj
    ik = flat % nk
    tile = ia * nj + ij
    edge = tile.new_full((1,), -1)
    prev = torch.cat([edge, tile[:-1]])
    nxt = torch.cat([tile[1:], edge])
    i32 = torch.int32
    return ProductStacks(
        ia=ia.to(i32),
        ik=ik.to(i32),
        ij=ij.to(i32),
        tile=tile.to(i32),
        first=(tile != prev).to(i32),
        write=(tile != nxt).to(i32),
        valid=valid.to(i32),
    )
