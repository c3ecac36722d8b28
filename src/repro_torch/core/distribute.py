"""Block->device distribution: sparsity-aware row/column assignment — the
twin of ``repro/core/distribute.py`` (host numpy, as there).

The engines split the block grid into uniform (r, c) panels, so a rank's
product load is whatever the sparsity pattern puts in its panel, and every
capacity bound (product lists, compressed-transport packing) is a maximum
over ranks.  DBCSR's answer is a randomized row/column permutation (Sivkov
et al. 2019); Hong et al. 2024 (arXiv:2408.14558) partition by nonzero
count.  Three modes:

``identity``    the unpermuted block-coordinate layout (the default);
``randomized``  DBCSR-style random permutation, seeded from a digest of the
                mask product, so every caller derives the same one;
``nnz_greedy``  greedy bin-packing of block indices by their product load
                (row + column sums of the mask-product counts) into
                ``lcm(p_r, p_c)`` equal-cardinality bins.

An :class:`Assignment` is one permutation ``perm`` applied to block rows
AND block columns: ``A' = P A P^T``.  Symmetric assignments compose under
multiplication (``A'B' = P (AB) P^T``) and fix the identity, so a whole
Newton-Schulz chain runs in one permuted home layout: applied at
``bsm.shard_bsm``, undone at ``ShardedBSM.unshard``, with every engine,
kernel and transport in between unchanged.

The permutations are numpy on the host masks; ``apply_assignment`` /
``undo_assignment`` reindex a matrix on its own device (``index_select``
of rows, then columns).
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.bsm import host_array
from repro_torch.core.commvolume import device_product_loads, load_imbalance  # noqa: F401

MODES = ("identity", "randomized", "nnz_greedy")


@dataclass(frozen=True)
class Assignment:
    """One symmetric block permutation: new block ``i`` is old ``perm[i]``.

    Applied to rows and columns alike (``blocks[perm][:, perm]``), so it
    is closed under multiplication and leaves the blocked identity
    invariant — what lets a fused chain pin ONE assignment for all of its
    sweeps.
    """

    mode: str
    perm: tuple[int, ...]

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown assignment mode {self.mode!r}; "
                             f"one of {MODES}")

    @property
    def nb(self) -> int:
        return len(self.perm)

    @property
    def is_identity(self) -> bool:
        return all(p == i for i, p in enumerate(self.perm))

    @property
    def inv(self) -> tuple[int, ...]:
        """The undo permutation: ``x[perm][inv] == x``."""
        return tuple(int(i) for i in np.argsort(np.asarray(self.perm)))

    @property
    def key(self) -> tuple:
        """Compact cache-key element (mode + short digest of the perm)."""
        if self.is_identity:
            return ("identity",)
        digest = hashlib.sha1(
            np.asarray(self.perm, np.int64).tobytes()
        ).hexdigest()[:12]
        return (self.mode, self.nb, digest)

    def validate(self, nb_r: int, nb_c: int) -> None:
        """Check this assignment fits a (nb_r, nb_c) block grid: symmetric
        permutations need a square grid, and the perm must be a genuine
        permutation of its indices."""
        if nb_r != nb_c:
            raise ValueError(
                f"assignments permute rows and columns symmetrically; "
                f"block grid {nb_r}x{nb_c} is not square"
            )
        if len(self.perm) != nb_r:
            raise ValueError(
                f"assignment permutes {len(self.perm)} block indices, "
                f"matrix has {nb_r}"
            )
        if sorted(self.perm) != list(range(nb_r)):
            raise ValueError("assignment perm is not a permutation")


def identity_assignment(nb: int) -> Assignment:
    return Assignment("identity", tuple(range(nb)))


def randomized_assignment(nb: int, seed: int) -> Assignment:
    """DBCSR's randomized load-balance permutation, explicit seed."""
    rng = np.random.default_rng(int(seed) & 0x7FFFFFFF)
    return Assignment("randomized", tuple(int(i) for i in rng.permutation(nb)))


def balance_bins(nb: int, p_r: int, p_c: int) -> int:
    """Bin count of the greedy packer: ``lcm(p_r, p_c)``, the finest
    granularity at which both the row panels and the column panels of the
    mesh are unions of whole bins."""
    g = math.lcm(int(p_r), int(p_c))
    if nb % g:
        raise ValueError(
            f"block grid {nb} does not divide lcm(p_r={p_r}, p_c={p_c})={g}"
        )
    return g


def nnz_greedy_assignment(counts: np.ndarray, p_r: int, p_c: int) -> Assignment:
    """Greedy nnz-balanced bin-packing (Hong et al. 2024, on the static
    block grid): each block index is scored by its row plus column sums of
    the mask-product ``counts`` and placed, heaviest first, into the
    least-loaded of ``lcm(p_r, p_c)`` equal-cardinality bins; the
    permutation concatenates the bins."""
    counts = np.asarray(counts, np.int64)
    nb = counts.shape[0]
    if counts.shape[0] != counts.shape[1]:
        raise ValueError("nnz_greedy assignment needs a square block grid")
    g = balance_bins(nb, p_r, p_c)
    cap = nb // g
    w = counts.sum(axis=1) + counts.sum(axis=0)
    order = np.argsort(-w, kind="stable")
    bins: list[list[int]] = [[] for _ in range(g)]
    loads = np.zeros(g, np.int64)
    for i in order:
        open_bins = [j for j in range(g) if len(bins[j]) < cap]
        j = min(open_bins, key=lambda j: (loads[j], j))
        bins[j].append(int(i))
        loads[j] += int(w[i])
    return Assignment("nnz_greedy", tuple(i for b in bins for i in b))


def product_counts(mask_a, mask_b) -> np.ndarray:
    """Products contributing to each C block: the integer mask product
    ``A_mask @ B_mask`` (threshold-free, so every caller derives the same
    permutation from the same masks)."""
    am = np.asarray(mask_a, bool).astype(np.int64)
    bm = np.asarray(mask_b, bool).astype(np.int64)
    return am @ bm


def _grid(mesh_or_grid) -> tuple[int, int]:
    if isinstance(mesh_or_grid, tuple):
        p_r, p_c = mesh_or_grid
        return int(p_r), int(p_c)
    return int(mesh_or_grid.shape["r"]), int(mesh_or_grid.shape["c"])


def assignment_for(mode: str, counts: np.ndarray, mesh_or_grid) -> Assignment:
    """Deterministic assignment of one mode for (mask-product counts, mesh
    grid); the randomized mode seeds from a digest of the counts."""
    counts = np.asarray(counts, np.int64)
    nb = int(counts.shape[0])
    if mode == "identity":
        return identity_assignment(nb)
    if counts.shape[0] != counts.shape[1]:
        raise ValueError(
            f"non-identity assignments need a square block grid, got "
            f"{counts.shape}"
        )
    p_r, p_c = _grid(mesh_or_grid)
    if mode == "randomized":
        seed = int.from_bytes(
            hashlib.sha1(counts.tobytes()).digest()[:4], "little"
        )
        return randomized_assignment(nb, seed)
    if mode == "nnz_greedy":
        return nnz_greedy_assignment(counts, p_r, p_c)
    raise ValueError(f"unknown assignment mode {mode!r}; one of {MODES}")


def compute_assignment(mode: str, mask_a, mask_b, mesh_or_grid) -> Assignment:
    """Assignment of one mode from concrete operand masks (numpy, or
    tensors on any device: they come to the host once)."""
    return assignment_for(
        mode, product_counts(host_array(mask_a), host_array(mask_b)),
        mesh_or_grid)


def _reindex(m, perm):
    """``m`` with block rows and columns taken in ``perm`` order, on its
    own device: ``index_select`` of rows, then of columns."""
    import torch

    from repro_torch.core.bsm import BlockSparseMatrix

    p = torch.as_tensor(np.asarray(perm, np.int64), device=m.device)
    return BlockSparseMatrix(
        *(x.index_select(0, p).index_select(1, p)
          for x in (m.blocks, m.mask, m.norms)))


def apply_assignment(m, asg: Assignment):
    """Permute a BlockSparseMatrix into the assignment's home layout."""
    asg.validate(m.nb_r, m.nb_c)
    if asg.is_identity:
        return m
    return _reindex(m, asg.perm)


def undo_assignment(m, asg: Assignment):
    """Inverse of :func:`apply_assignment` (bit-exact: pure reindexing)."""
    asg.validate(m.nb_r, m.nb_c)
    if asg.is_identity:
        return m
    return _reindex(m, asg.inv)


def permute_cube(ok: np.ndarray, perm) -> np.ndarray:
    """The (i, k, j) filter cube in the permuted layout — what capacity
    bounds must be derived from under a non-identity assignment."""
    p = np.asarray(perm)
    return np.asarray(ok)[np.ix_(p, p, p)]


def assignment_imbalance(counts: np.ndarray, mesh_or_grid,
                         asg: Assignment | None = None) -> float:
    """Max/mean per-rank product load under an assignment (1.0 = perfectly
    balanced)."""
    p_r, p_c = _grid(mesh_or_grid)
    perm = None if asg is None or asg.is_identity else asg.perm
    return load_imbalance(counts, p_r, p_c, perm=perm)
