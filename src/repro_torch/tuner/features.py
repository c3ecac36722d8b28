"""Sparsity-pattern features of a multiply's operands — the torch twin of
``repro/tuner/features.py``.

The winning engine depends on the application's sparsity pattern, not only
on the process count.  This module reduces a concrete operand pair to the
small feature vector the tuner keys its decisions on:

* occupancies of A and B and the product fill (surviving (i, k, j)
  triples / cube) from the boolean mask product ``A_mask @ B_mask`` —
  exact for threshold 0, an upper bound otherwise (the norm filter only
  removes products);
* the output fill (blocks of C with at least one contribution);
* the block-row bandwidth of both operands;
* the byte size of one A block-row panel, the s_a of Eq. (7);
* the product-load imbalance (max / mean per-panel load of the mask
  product) over a canonical mesh-independent grid.

``feature_bucket`` coarsens the vector (log2 shape classes, occupancy
deciles) into the tuning database's key; ``mask_bucket`` does the same for
one operand mask.  Everything here is host numpy: the operands' masks come
to the host once (``host_masks``), as a ``ShardedBSM``'s gathered home
layout or a ``BlockSparseMatrix``'s mask.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass

import numpy as np


@dataclass(frozen=True)
class PairFeatures:
    """Tuning features of one (A, B) multiply operand pair."""

    nb_r: int
    nb_k: int
    nb_c: int
    bs_r: int
    bs_k: int
    bs_c: int
    dtype: str  # storage dtype name, as numpy spells it ("float32", ...)
    occ_a: float  # block occupancy of A
    occ_b: float  # block occupancy of B
    n_products: int  # surviving (i, k, j) triples (mask product)
    product_fill: float  # n_products / (nb_r * nb_k * nb_c)
    out_fill: float  # fraction of C blocks with >= 1 contribution
    bandwidth_a: float  # block-row bandwidth of A, normalized by nb
    bandwidth_b: float
    panel_kb: float  # one A block-row panel triple, kilobytes
    imbalance: float = 1.0  # max/mean product load, canonical grid

    @property
    def cube(self) -> int:
        return self.nb_r * self.nb_k * self.nb_c

    def as_dict(self) -> dict:
        return asdict(self)


def dtype_name(dtype) -> str:
    """A torch dtype's name as numpy spells it (``torch.float32`` ->
    ``"float32"``), the form the reference keys its records on."""
    return str(dtype).removeprefix("torch.")


def host_masks(a, b) -> tuple[np.ndarray, np.ndarray]:
    """The operands' global block masks on the host (one copy each)."""
    from repro_torch.core.bsm import host_mask

    return host_mask(a), host_mask(b)


def _bandwidth(mask: np.ndarray) -> int:
    """Largest |i - j| over occupied blocks (0 for empty/diagonal-only)."""
    idx = np.argwhere(mask)
    if idx.size == 0:
        return 0
    return int(np.abs(idx[:, 0] - idx[:, 1]).max())


CANONICAL_GRID = 4  # imbalance reference grid (mesh-independent feature)


def _canonical_divisor(n: int, target: int = CANONICAL_GRID) -> int:
    for g in range(min(target, max(n, 1)), 0, -1):
        if n % g == 0:
            return g
    return 1


def _canonical_imbalance(counts: np.ndarray) -> float:
    """Max/mean product load over a canonical square-ish grid, the same
    for every mesh the pattern may run on (the mesh is a separate part of
    the database key; the model prices each mesh's own imbalance)."""
    from repro_torch.core.commvolume import load_imbalance

    g_r = _canonical_divisor(counts.shape[0])
    g_c = _canonical_divisor(counts.shape[1])
    if g_r < 2 and g_c < 2:
        return 1.0
    return load_imbalance(counts, g_r, g_c)


def mask_product(mask_a, mask_b) -> np.ndarray:
    """Integer boolean-mask product: products per C block, one
    (nb_r, nb_k) x (nb_k, nb_c) integer matmul instead of the
    (nb_r, nb_k, nb_c) filter cube."""
    am = np.asarray(mask_a, bool)
    bm = np.asarray(mask_b, bool)
    return am.astype(np.int64) @ bm.astype(np.int64)


def mask_union(masks) -> np.ndarray:
    """Bitwise union of a family of equal-shape boolean masks (the stream
    side of the envelope layer: one bound covering every member)."""
    it = iter(masks)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("mask_union needs at least one mask") from None
    out = np.asarray(first, bool).copy()
    for m in it:
        mm = np.asarray(m, bool)
        if mm.shape != out.shape:
            raise ValueError(
                f"mask shapes differ: {mm.shape} vs {out.shape}"
            )
        out |= mm
    return out


def featurize(a, b, threshold: float = 0.0, *, masks=None) -> PairFeatures:
    """Feature vector of a concrete operand pair (``BlockSparseMatrix`` or
    ``ShardedBSM``; host numpy, no device work beyond one copy of each
    mask).  ``masks`` — the host masks when the caller already holds
    them (``host_masks``)."""
    del threshold  # the mask product bounds the filtered count
    am, bm = host_masks(a, b) if masks is None else masks
    am = np.asarray(am, bool)
    bm = np.asarray(bm, bool)
    counts = mask_product(am, bm)  # products per C block
    n_products = int(counts.sum())
    nb_r, nb_k = am.shape
    nb_c = bm.shape[1]
    cube = nb_r * nb_k * nb_c
    bs_r, bs_k, bs_c = a.bs_r, a.bs_c, b.bs_c
    itemsize = a.dtype.itemsize
    # one block-row panel triple of A (blocks + mask + norms), the unit
    # the engines move per pull: the s_a of Eq. (7) in bytes
    panel_kb = nb_k * (bs_r * bs_k * itemsize + 1 + 4) / 1024.0
    return PairFeatures(
        nb_r=nb_r,
        nb_k=nb_k,
        nb_c=nb_c,
        bs_r=bs_r,
        bs_k=bs_k,
        bs_c=bs_c,
        dtype=dtype_name(a.dtype),
        occ_a=float(am.mean()) if am.size else 0.0,
        occ_b=float(bm.mean()) if bm.size else 0.0,
        n_products=n_products,
        product_fill=n_products / cube if cube else 0.0,
        out_fill=float((counts > 0).mean()) if counts.size else 0.0,
        bandwidth_a=_bandwidth(am) / max(nb_r, 1),
        bandwidth_b=_bandwidth(bm) / max(nb_k, 1),
        panel_kb=panel_kb,
        imbalance=_canonical_imbalance(counts),
    )


def _log2_class(x: int) -> int:
    return int(round(math.log2(max(int(x), 1))))


def _decile(x: float, step: float = 0.1) -> int:
    return min(int(x / step), int(round(1.0 / step)))


def mask_bucket(mask, bs_r: int = 1, bs_c: int = 1) -> tuple:
    """Coarse bucket of ONE operand mask (the serving dispatch key): the
    log2 shape classes and occupancy decile of ``feature_bucket`` plus a
    row-load class (max / mean occupied blocks per block row)."""
    m = np.asarray(mask, bool)
    if m.ndim != 2:
        raise ValueError(f"mask_bucket needs a 2D mask, got shape {m.shape}")
    nb_r, nb_c = m.shape
    occ = float(m.mean()) if m.size else 0.0
    row = m.sum(axis=1).astype(np.float64)
    mean = row.mean() if row.size else 0.0
    peak = float(row.max() / mean) if mean > 0 else 1.0
    return (
        "db1",  # dispatch-bucket schema version
        _log2_class(nb_r), _log2_class(nb_c),
        _log2_class(bs_r), _log2_class(bs_c),
        _decile(occ),
        # half-integer row-load classes, capped at 4x
        min(int(round(peak * 2)), 8),
    )


def feature_bucket(f: PairFeatures) -> tuple:
    """Coarse, stable bucket of a feature vector — the tuning database's
    key part: shapes as log2 classes, occupancies and fills as deciles, so
    drifting-but-similar patterns share one measured decision."""
    return (
        "fb2",  # bucket-schema version (bump when fields change)
        _log2_class(f.nb_r), _log2_class(f.nb_k), _log2_class(f.nb_c),
        _log2_class(f.bs_r), _log2_class(f.bs_k), _log2_class(f.bs_c),
        f.dtype,
        _decile(f.occ_a), _decile(f.occ_b),
        _decile(f.product_fill, 0.05),
        _decile(f.out_fill),
        _decile(f.bandwidth_a), _decile(f.bandwidth_b),
        # half-integer imbalance classes, capped at 4x: balanced and
        # hub-dominated patterns never share one record
        min(int(round(f.imbalance * 2)), 8),
    )
