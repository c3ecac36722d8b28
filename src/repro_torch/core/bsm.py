"""Block-sparse matrix format (DBCSR analogue), the torch twin of
``repro/core/bsm.py`` — the single-device part.

A matrix is a dense *block grid* plus a boolean occupation mask and
per-block Frobenius norms:

    blocks : (nb_r, nb_c, bs_r, bs_c)   block data (zero where unoccupied)
    mask   : (nb_r, nb_c) bool          block occupation
    norms  : (nb_r, nb_c) float32       per-block Frobenius norms

The mask and norms drive DBCSR's on-the-fly filtering (skip block products
with ``norm(A_ik) * norm(B_kj) <= eps``) and post-filtering (drop result
blocks below threshold).  All three live on one device; operations keep
them there.  ``ShardedBSM`` arrives with the distributed slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config import resolve_device


@dataclass(frozen=True)
class BlockSparseMatrix:
    """A block-sparse matrix: dense block grid + mask + block norms."""

    blocks: torch.Tensor  # (nb_r, nb_c, bs_r, bs_c)
    mask: torch.Tensor  # (nb_r, nb_c) bool
    norms: torch.Tensor  # (nb_r, nb_c) float32

    # ---- shape helpers -------------------------------------------------
    @property
    def nb_r(self) -> int:
        return self.blocks.shape[0]

    @property
    def nb_c(self) -> int:
        return self.blocks.shape[1]

    @property
    def bs_r(self) -> int:
        return self.blocks.shape[2]

    @property
    def bs_c(self) -> int:
        return self.blocks.shape[3]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nb_r * self.bs_r, self.nb_c * self.bs_c)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    # ---- stats (device scalars) ----------------------------------------
    def nnz_blocks(self) -> torch.Tensor:
        return self.mask.sum()

    def occupancy(self) -> torch.Tensor:
        """Fraction of occupied blocks (the paper's 'occupancy')."""
        return self.mask.to(torch.float32).mean()

    def frobenius_norm(self) -> torch.Tensor:
        return torch.sqrt(torch.sum(torch.square(self.norms)))

    # ---- conversions ---------------------------------------------------
    def astype(self, dtype: torch.dtype) -> "BlockSparseMatrix":
        """Cast block storage to ``dtype``, recalibrating norms from the
        quantized blocks (in f32), so the on-the-fly filter sees the values
        that will be multiplied.  Identity when the dtype already matches."""
        if dtype == self.dtype:
            return self
        blocks = self.blocks.to(dtype)
        return BlockSparseMatrix(blocks=blocks, mask=self.mask,
                                 norms=block_norms(blocks))

    def to_dense(self) -> torch.Tensor:
        nb_r, nb_c, bs_r, bs_c = self.blocks.shape
        masked = self.blocks * self.mask[:, :, None, None].to(self.dtype)
        return masked.permute(0, 2, 1, 3).reshape(nb_r * bs_r, nb_c * bs_c)


def block_norms(blocks: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of every block, computed in f32."""
    b32 = blocks.to(torch.float32)
    return torch.sqrt(torch.sum(b32 * b32, dim=(-2, -1)))


def make_bsm(blocks: torch.Tensor, mask: torch.Tensor) -> BlockSparseMatrix:
    """Build a BSM from raw blocks + mask, zeroing masked-out data and
    recomputing norms (keeps the three fields mutually consistent)."""
    m = mask.to(torch.bool)
    blocks = blocks * m[:, :, None, None].to(blocks.dtype)
    return BlockSparseMatrix(blocks=blocks, mask=m, norms=block_norms(blocks))


def _block_shape(bs) -> tuple[int, int]:
    """Normalize a block-size spec: int -> square, (bs_r, bs_c) -> as-is."""
    if isinstance(bs, (tuple, list)):
        bs_r, bs_c = bs
        return int(bs_r), int(bs_c)
    return int(bs), int(bs)


def from_dense(dense: torch.Tensor, bs, threshold: float = 0.0) -> BlockSparseMatrix:
    """Block a dense matrix; ``bs`` may be an int or a (bs_r, bs_c) tuple."""
    bs_r, bs_c = _block_shape(bs)
    n_r, n_c = dense.shape
    if n_r % bs_r or n_c % bs_c:
        raise ValueError(
            f"dense shape {tuple(dense.shape)} not divisible by "
            f"bs=({bs_r}, {bs_c})"
        )
    nb_r, nb_c = n_r // bs_r, n_c // bs_c
    blocks = dense.reshape(nb_r, bs_r, nb_c, bs_c).permute(0, 2, 1, 3)
    mask = block_norms(blocks) > threshold
    return make_bsm(blocks.contiguous(), mask)


def filter_bsm(m: BlockSparseMatrix, threshold: float) -> BlockSparseMatrix:
    """Post-multiplication filtering: drop blocks with norm <= threshold.
    Norms are derived (existing norms under the new mask), not recomputed."""
    keep = m.mask & (m.norms > threshold)
    return BlockSparseMatrix(
        blocks=m.blocks * keep[:, :, None, None].to(m.dtype),
        mask=keep,
        norms=torch.where(keep, m.norms, 0.0),
    )


def identity(nb: int, bs, dtype: torch.dtype = torch.float32,
             device=None) -> BlockSparseMatrix:
    """Blocked identity.  ``bs`` may be an int or a (bs_r, bs_c) tuple; a
    rectangular blocking must still tile a square matrix, and then blocks
    a dense eye."""
    dev = resolve_device(device)
    bs_r, bs_c = _block_shape(bs)
    if bs_r == bs_c:
        blocks = torch.zeros((nb, nb, bs_r, bs_r), dtype=dtype, device=dev)
        idx = torch.arange(nb, device=dev)
        blocks[idx, idx] = torch.eye(bs_r, dtype=dtype, device=dev)
        return make_bsm(blocks, torch.eye(nb, dtype=torch.bool, device=dev))
    n = nb * bs_r
    if n % bs_c:
        raise ValueError(
            f"identity of size {n} (nb={nb} x bs_r={bs_r}) is not "
            f"divisible by bs_c={bs_c}"
        )
    return from_dense(torch.eye(n, dtype=dtype, device=dev), (bs_r, bs_c))


def add(a: BlockSparseMatrix, b: BlockSparseMatrix) -> BlockSparseMatrix:
    """A + B (consistent triples need no re-masking; norms recomputed)."""
    blocks = a.blocks + b.blocks
    return BlockSparseMatrix(blocks=blocks, mask=a.mask | b.mask,
                             norms=block_norms(blocks))


def _scalar(s, dtype: torch.dtype, device) -> torch.Tensor:
    """``s`` (number or 0-d tensor) in the storage dtype, as the reference's
    ``jnp.asarray(s, dtype)`` rounds it."""
    return torch.as_tensor(s, dtype=dtype, device=device)


def scale(a: BlockSparseMatrix, s) -> BlockSparseMatrix:
    """s * A with derived norms: |s| . norms (no block-norm recompute)."""
    s = _scalar(s, a.dtype, a.device)
    return BlockSparseMatrix(
        blocks=a.blocks * s,
        mask=a.mask,
        norms=a.norms * torch.abs(s).to(torch.float32),
    )


def axpy(s, x: BlockSparseMatrix, y: BlockSparseMatrix) -> BlockSparseMatrix:
    """s * X + Y (one fused update; norms recomputed on the sum)."""
    blocks = x.blocks * _scalar(s, x.dtype, x.device) + y.blocks
    return BlockSparseMatrix(blocks=blocks, mask=x.mask | y.mask,
                             norms=block_norms(blocks))


def cast_bsm(m: BlockSparseMatrix, dtype: torch.dtype) -> BlockSparseMatrix:
    """Storage-dtype cast with norm recalibration; identity when already at
    ``dtype``."""
    return m.astype(dtype)


# ---------------------------------------------------------------------------
# Pattern generation (benchmark matrices; Table 1 of the paper)
# ---------------------------------------------------------------------------


def _pattern_mask(rng: np.random.Generator, nb_r, nb_c, occupancy, pattern,
                  bandwidth) -> np.ndarray:
    """numpy mask generation (host side — patterns are data)."""
    if pattern == "dense":
        return np.ones((nb_r, nb_c), bool)
    if pattern == "random":
        m = rng.random((nb_r, nb_c)) < occupancy
    elif pattern == "banded":
        # |i - j| <= bw occupied; models near-sightedness of the operators
        i = np.arange(nb_r)[:, None]
        j = np.arange(nb_c)[None, :]
        m = np.abs(i - j) <= bandwidth
    elif pattern == "decay":
        # exponential decay of occupation probability with block distance —
        # the shape of linear-scaling DFT operators (H, S, P)
        i = np.arange(nb_r)[:, None]
        j = np.arange(nb_c)[None, :]
        d = np.abs(i - j)
        # calibrate scale so mean probability ~= occupancy
        scale_ = max(occupancy * nb_c / 2.0, 1e-3)
        p = np.exp(-d / scale_)
        m = rng.random((nb_r, nb_c)) < p
    else:
        raise ValueError(f"unknown pattern {pattern!r}")
    # diagonal always occupied (operators have dominant diagonal)
    n = min(nb_r, nb_c)
    m[np.arange(n), np.arange(n)] = True
    return m


def random_bsm(
    seed: int,
    nb: int,
    bs: int,
    occupancy: float = 0.1,
    pattern: str = "random",
    bandwidth: int = 2,
    dtype: torch.dtype = torch.float32,
    symmetric: bool = False,
    device=None,
) -> BlockSparseMatrix:
    """Random block-sparse matrix with the given block occupancy pattern.

    The mask comes from a numpy ``Generator`` seeded with ``seed`` and the
    block data from a ``torch.Generator`` on ``device`` seeded with
    ``seed``; neither reproduces ``jax.random`` (tests carry the
    reference's matrices across with ``interop.bsm_from_arrays``).
    """
    dev = resolve_device(device)
    mask_np = _pattern_mask(np.random.default_rng(seed), nb, nb, occupancy,
                            pattern, bandwidth)
    if symmetric:
        mask_np = mask_np | mask_np.T
    mask = torch.from_numpy(mask_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks = torch.randn((nb, nb, bs, bs), generator=gen, device=dev)
    blocks = (blocks / np.sqrt(bs)).to(dtype)
    if symmetric:
        blocks = 0.5 * (blocks + blocks.permute(1, 0, 3, 2))
    return make_bsm(blocks, mask)


def permute(m: BlockSparseMatrix, perm_r, perm_c) -> BlockSparseMatrix:
    perm_r = torch.as_tensor(np.array(perm_r, np.int64), device=m.device)
    perm_c = torch.as_tensor(np.array(perm_c, np.int64), device=m.device)
    return BlockSparseMatrix(
        blocks=m.blocks[perm_r][:, perm_c],
        mask=m.mask[perm_r][:, perm_c],
        norms=m.norms[perm_r][:, perm_c],
    )


def grid_block_loads(mask, pr: int, pc: int) -> np.ndarray:
    """Occupied-block count of each (pr x pc) panel — load-balance metric."""
    mask = mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
    nb_r, nb_c = mask.shape
    return (
        mask.reshape(pr, nb_r // pr, pc, nb_c // pc)
        .sum(axis=(1, 3))
        .astype(np.int64)
    )
