"""Blocked sparse tensors and matricized einsum contraction — the torch twin
of ``repro/core/tensor.py`` (DESIGN.md §10).

DBCSR was generalized from matrices to blocked sparse *tensors* for the
low-scaling correlated methods (RPA/MP2), whose working data are 3-index
three-center integral tensors, and the strategy is the one reproduced
here: a tensor contraction is **matricized** — the tensor's indices are
split into a (row group, col group), the block grid is flattened onto an
ordinary block-sparse matrix, and the contraction runs as a plain SpGEMM
through ``engine.multiply``.  Nothing below the matricization layer
changes: compacted product lists, the CUDA kernel (``backend="cuda"``, on
rectangular (bs_i·bs_j) x bs_k blocks), compressed transport, envelopes and
``engine="auto"`` all apply, because a matricized tensor *is* a
:class:`~repro_torch.core.bsm.BlockSparseMatrix` (typically tall-skinny).

Containers:

* :class:`BlockSparseTensor` — the N-index analogue of the BSM triple
  (a plain frozen dataclass; the reference registers a jax pytree)::

      blocks : (nb_1, ..., nb_N, bs_1, ..., bs_N)
      mask   : (nb_1, ..., nb_N) bool
      norms  : (nb_1, ..., nb_N) float32

* :class:`MatricizedTensor` — a tensor living in matrix form (a
  ``BlockSparseMatrix`` or a ``ShardedBSM`` on a mesh of ranks) with the
  index map that undoes the flattening.  Chained contractions whose splits
  line up stay sharded end to end.

Index map: ``matricize(t, row_axes, col_axes)`` flattens the block
coordinates block-major — matricized block (R, C) with
``R = ravel(i[row_axes])`` and ``C = ravel(i[col_axes])`` is tensor block
``i`` with its intra-block dims transposed to (row dims, col dims) order
and reshaped 2D.  Mask and norms move by the same transpose + reshape,
bit-exact, and ``unmatricize`` inverts losslessly.

``contract("ijk,kl->ijl", t1, t2, mesh=...)`` aligns every contracted
index on the shared k dimension (A rows = A's free indices, A cols = the
contracted group in A's spec order; B accordingly), multiplies through
``engine.multiply`` and folds the product back.  Traces and indices shared
by inputs *and* output (batch dims) are outside the matricized-SpGEMM
model and rejected.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config import resolve_device
from repro_torch.core.bsm import BlockSparseMatrix, ShardedBSM, shard_bsm

__all__ = [
    "BlockSparseTensor",
    "MatricizedTensor",
    "contract",
    "contract_reference",
    "from_dense_tensor",
    "make_tensor",
    "matricize",
    "random_tensor",
    "shard_tensor",
    "tensor_block_norms",
    "unmatricize",
]


@dataclass(frozen=True)
class BlockSparseTensor:
    """An N-index blocked sparse tensor: dense block grid + mask + norms."""

    blocks: torch.Tensor  # (nb_1..nb_N, bs_1..bs_N)
    mask: torch.Tensor  # (nb_1..nb_N) bool
    norms: torch.Tensor  # (nb_1..nb_N) float32

    # ---- shape helpers -------------------------------------------------
    @property
    def ndim(self) -> int:
        return self.mask.dim()

    @property
    def nbs(self) -> tuple[int, ...]:
        return tuple(self.blocks.shape[: self.ndim])

    @property
    def bss(self) -> tuple[int, ...]:
        return tuple(self.blocks.shape[self.ndim:])

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(nb * bs for nb, bs in zip(self.nbs, self.bss))

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
        return self.mask.to(torch.float32).mean()

    def frobenius_norm(self) -> torch.Tensor:
        return torch.sqrt(torch.sum(torch.square(self.norms)))

    # ---- conversions ---------------------------------------------------
    def to_dense(self) -> torch.Tensor:
        n = self.ndim
        m = self.mask
        masked = self.blocks * m.reshape(m.shape + (1,) * n).to(self.dtype)
        # interleave (grid_i, block_i) pairs, then merge each pair
        perm = tuple(x for i in range(n) for x in (i, n + i))
        return masked.permute(perm).reshape(self.shape)


def tensor_block_norms(blocks: torch.Tensor, ndim: int) -> torch.Tensor:
    """Frobenius norm of every block of an ``ndim``-index blocked tensor,
    in f32 (the N-axis analogue of ``bsm.block_norms``)."""
    b32 = blocks.to(torch.float32)
    return torch.sqrt(torch.sum(b32 * b32, dim=tuple(range(ndim, 2 * ndim))))


def make_tensor(blocks: torch.Tensor, mask) -> BlockSparseTensor:
    """Build a tensor from raw blocks + mask, zeroing masked-out data and
    recomputing norms (the ``make_bsm`` consistency contract).  ``mask``
    may be numpy; it moves to the blocks' device."""
    m = torch.as_tensor(mask, device=blocks.device).to(torch.bool)
    n = m.dim()
    if blocks.dim() != 2 * n:
        raise ValueError(
            f"blocks must have 2x the mask's rank (grid dims + block "
            f"dims); got blocks rank {blocks.dim()} for mask rank {n}"
        )
    blocks = blocks * m.reshape(m.shape + (1,) * n).to(blocks.dtype)
    return BlockSparseTensor(blocks=blocks, mask=m,
                             norms=tensor_block_norms(blocks, n))


def _block_sizes(bss, ndim: int) -> tuple[int, ...]:
    if isinstance(bss, (tuple, list)):
        if len(bss) != ndim:
            raise ValueError(f"need {ndim} block sizes, got {bss!r}")
        return tuple(int(b) for b in bss)
    return (int(bss),) * ndim


def from_dense_tensor(dense: torch.Tensor, bss,
                      threshold: float = 0.0) -> BlockSparseTensor:
    """Block a dense N-index tensor; ``bss`` is an int (cubic blocks) or a
    per-index tuple (rectangular atomic blocks, as in ``bsm.from_dense``)."""
    n = dense.dim()
    bss = _block_sizes(bss, n)
    for d, b in zip(dense.shape, bss):
        if d % b:
            raise ValueError(
                f"dense shape {tuple(dense.shape)} not divisible by blocks "
                f"{bss}"
            )
    nbs = tuple(d // b for d, b in zip(dense.shape, bss))
    split = tuple(x for nb, b in zip(nbs, bss) for x in (nb, b))
    # (nb_1, bs_1, nb_2, bs_2, ...) -> (grids..., blocks...)
    perm = tuple(range(0, 2 * n, 2)) + tuple(range(1, 2 * n, 2))
    blocks = dense.reshape(split).permute(perm)
    norms = tensor_block_norms(blocks, n)
    return make_tensor(blocks, norms > threshold)


def random_mask(seed, nbs, *, occupancy: float = 0.1,
                pattern: str = "decay", decay: float = 0.5) -> np.ndarray:
    """The occupation mask of ``random_tensor``, on the host: block
    (i_1, ..., i_N) kept with probability decaying exponentially in the
    spread of its normalized coordinates (``"decay"``, the shape of a
    screened three-center tensor (ij|k)) or flat (``"uniform"``); the
    full diagonal (all coordinates equal) is always kept.  ``seed`` is
    anything ``np.random.default_rng`` takes."""
    nbs = tuple(int(x) for x in nbs)
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(
        *[np.arange(nb, dtype=np.float32) / max(nb - 1, 1) for nb in nbs],
        indexing="ij")
    coords = np.stack(grids)
    spread = coords.max(axis=0) - coords.min(axis=0)
    if pattern == "decay":
        keep = np.exp(-spread / max(decay, 1e-6))
        # the acceptance scale sets the mean occupancy, the decay its shape
        scale = occupancy / max(float(keep.mean()), 1e-6)
        mask = rng.random(spread.shape) < keep * scale
    elif pattern == "uniform":
        mask = rng.random(spread.shape) < occupancy
    else:
        raise ValueError(f"unknown pattern {pattern!r}")
    return mask | (spread == 0.0)


def random_tensor(seed: int, nbs, bss, *, occupancy: float = 0.1,
                  pattern: str = "decay", dtype=torch.float32,
                  decay: float = 0.5, device=None) -> BlockSparseTensor:
    """Random blocked tensor with a physically shaped mask
    (``random_mask``).  The mask comes from a numpy generator seeded with
    ``seed``, the N(0, 1) block data from a ``torch.Generator`` on
    ``device`` (CUDA unless the caller names another) seeded with
    ``seed``; neither reproduces ``jax.random`` (parity tests carry the
    reference's arrays across with ``make_tensor``)."""
    nbs = tuple(int(x) for x in nbs)
    bss = _block_sizes(bss, len(nbs))
    dev = resolve_device(device)
    mask = random_mask(seed, nbs, occupancy=occupancy, pattern=pattern,
                       decay=decay)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    blocks = torch.randn(nbs + bss, generator=gen, device=dev).to(dtype)
    return make_tensor(blocks, torch.from_numpy(mask).to(dev))


# ---------------------------------------------------------------------------
# matricization: the lossless index map onto the SpGEMM stack
# ---------------------------------------------------------------------------


def _check_split(ndim: int, row_axes, col_axes) -> tuple[tuple, tuple]:
    row_axes = tuple(int(a) for a in row_axes)
    col_axes = tuple(int(a) for a in col_axes)
    if not row_axes or not col_axes:
        raise ValueError(
            "matricization needs at least one index on each side; got "
            f"rows {row_axes}, cols {col_axes}"
        )
    if sorted(row_axes + col_axes) != list(range(ndim)):
        raise ValueError(
            f"rows {row_axes} + cols {col_axes} must partition the "
            f"{ndim} tensor indices exactly once each"
        )
    return row_axes, col_axes


def _prod(xs) -> int:
    return int(np.prod(xs, dtype=np.int64))


def matricize(t: BlockSparseTensor, row_axes, col_axes) -> BlockSparseMatrix:
    """Flatten a blocked tensor onto a block-sparse matrix.

    ``row_axes`` / ``col_axes`` (ordered, disjoint, covering all indices)
    select which tensor indices compose the matrix rows and columns.  The
    flattening is block-major: matrix block (ravel(i_rows), ravel(i_cols))
    is tensor block i, its data transposed to (row dims, col dims) and
    reshaped — mask and norms move by the same transpose + reshape,
    bit-exact, and :func:`unmatricize` inverts losslessly.  The blocks
    come out contiguous, as the kernel reads them.
    """
    n = t.ndim
    row_axes, col_axes = _check_split(n, row_axes, col_axes)
    grid_perm = row_axes + col_axes
    block_perm = tuple(a + n for a in grid_perm)
    nb_r = _prod([t.nbs[a] for a in row_axes])
    nb_c = _prod([t.nbs[a] for a in col_axes])
    bs_r = _prod([t.bss[a] for a in row_axes])
    bs_c = _prod([t.bss[a] for a in col_axes])
    blocks = t.blocks.permute(grid_perm + block_perm).reshape(
        nb_r, nb_c, bs_r, bs_c)
    mask = t.mask.permute(grid_perm).reshape(nb_r, nb_c)
    norms = t.norms.permute(grid_perm).reshape(nb_r, nb_c)
    return BlockSparseMatrix(blocks=blocks.contiguous(), mask=mask,
                             norms=norms)


def unmatricize(m: BlockSparseMatrix, row_axes, col_axes,
                nbs, bss) -> BlockSparseTensor:
    """Invert :func:`matricize`: fold a block-sparse matrix back into the
    (``nbs``, ``bss``) blocked tensor it was flattened from.  ``row_axes``
    / ``col_axes`` / ``nbs`` / ``bss`` describe the TENSOR (the arguments
    and properties the matricize call saw)."""
    nbs = tuple(int(x) for x in nbs)
    n = len(nbs)
    bss = _block_sizes(bss, n)
    row_axes, col_axes = _check_split(n, row_axes, col_axes)
    grid_perm = row_axes + col_axes
    expect = (
        _prod([nbs[a] for a in row_axes]),
        _prod([nbs[a] for a in col_axes]),
        _prod([bss[a] for a in row_axes]),
        _prod([bss[a] for a in col_axes]),
    )
    if tuple(m.blocks.shape) != expect:
        raise ValueError(
            f"matrix blocks {tuple(m.blocks.shape)} do not fold into "
            f"tensor nbs={nbs} bss={bss} under rows {row_axes} / cols "
            f"{col_axes} (expected {expect})"
        )
    inv = tuple(int(i) for i in np.argsort(grid_perm))
    split_grid = tuple(nbs[a] for a in grid_perm)
    split_block = tuple(bss[a] for a in grid_perm)
    undo = inv + tuple(i + n for i in inv)
    blocks = m.blocks.reshape(split_grid + split_block).permute(undo)
    mask = m.mask.reshape(split_grid).permute(inv)
    norms = m.norms.reshape(split_grid).permute(inv)
    return BlockSparseTensor(blocks=blocks, mask=mask, norms=norms)


class MatricizedTensor:
    """A blocked tensor living in matricized form, with its index map.

    ``bsm`` is the flattened matrix — a ``BlockSparseMatrix`` or a
    ``ShardedBSM``.  ``row_axes`` / ``col_axes`` / ``nbs`` / ``bss``
    record the tensor structure so :meth:`to_tensor` can undo the
    flattening.  :func:`contract` takes these as operands and returns one
    when the product stays sharded.
    """

    def __init__(self, bsm, row_axes, col_axes, nbs, bss):
        nbs = tuple(int(x) for x in nbs)
        n = len(nbs)
        bss = _block_sizes(bss, n)
        row_axes, col_axes = _check_split(n, row_axes, col_axes)
        self.bsm = bsm
        self.row_axes = row_axes
        self.col_axes = col_axes
        self.nbs = nbs
        self.bss = bss

    @property
    def ndim(self) -> int:
        return len(self.nbs)

    @property
    def sharded(self) -> bool:
        return isinstance(self.bsm, ShardedBSM)

    @property
    def dtype(self) -> torch.dtype:
        return self.bsm.dtype

    def to_tensor(self) -> BlockSparseTensor:
        """Leave matrix form: gather (if sharded) and un-matricize — the
        chain-boundary operation, like ``ShardedBSM.unshard``."""
        m = self.bsm.unshard() if self.sharded else self.bsm
        return unmatricize(m, self.row_axes, self.col_axes,
                           self.nbs, self.bss)

    def __repr__(self) -> str:
        kind = "sharded" if self.sharded else "replicated"
        return (
            f"MatricizedTensor(nbs={self.nbs}, bss={self.bss}, "
            f"rows={self.row_axes}, cols={self.col_axes}, {kind})"
        )


def shard_tensor(t: BlockSparseTensor, mesh, row_axes,
                 col_axes) -> MatricizedTensor:
    """Matricize ``t`` under (``row_axes`` | ``col_axes``) and scatter the
    matrix to its 2D home layout on a mesh of ranks — the tensor chain's
    entry point, the analogue of ``bsm.shard_bsm``."""
    m = matricize(t, row_axes, col_axes)
    return MatricizedTensor(shard_bsm(m, mesh), row_axes, col_axes,
                            t.nbs, t.bss)


# ---------------------------------------------------------------------------
# einsum-style contraction driver
# ---------------------------------------------------------------------------


def _parse_spec(spec: str, n_ops: int) -> tuple[list[str], str]:
    spec = spec.replace(" ", "")
    if "->" not in spec:
        raise ValueError(
            f"contract spec {spec!r} needs an explicit '->' output"
        )
    ins, out = spec.split("->")
    in_specs = ins.split(",")
    if len(in_specs) != n_ops:
        raise ValueError(
            f"spec {spec!r} names {len(in_specs)} operands, got {n_ops}"
        )
    for s in in_specs + [out]:
        if not all(c.isalpha() for c in s):
            raise ValueError(f"bad index letters in {spec!r}")
    for s in in_specs:
        if len(set(s)) != len(s):
            raise ValueError(
                f"repeated index within one operand in {spec!r}: traces "
                "are outside the matricized-SpGEMM model"
            )
    if len(set(out)) != len(out):
        raise ValueError(f"repeated output index in {spec!r}")
    return in_specs, out


def _operand_dims(op, spec: str) -> tuple[tuple[int, ...], tuple[int, ...]]:
    if not isinstance(op, (BlockSparseTensor, MatricizedTensor)):
        raise TypeError(
            f"operand for {spec!r} must be a BlockSparseTensor or "
            f"MatricizedTensor, got {type(op).__name__}"
        )
    if len(spec) != len(op.nbs):
        raise ValueError(
            f"operand has {len(op.nbs)} indices but spec names {spec!r}"
        )
    return op.nbs, op.bss


def _pair_contract(a, a_spec: str, b, b_spec: str, out: str,
                   mesh, engine: str, kw: dict):
    """One matricized SpGEMM: contract every index shared by ``a_spec``
    and ``b_spec`` that does not survive into ``out``."""
    from repro_torch.core.engine import multiply

    shared = [c for c in a_spec if c in b_spec]
    batch = [c for c in shared if c in out]
    if batch:
        raise NotImplementedError(
            f"index {batch[0]!r} appears in both operands AND the output "
            "— batch/Hadamard dims are outside the matricized-SpGEMM "
            "model (contract them pairwise or use dense einsum)"
        )
    if not shared:
        raise ValueError(
            f"operands {a_spec!r} and {b_spec!r} share no contracted "
            "index — outer products are not SpGEMMs"
        )
    free_a = [c for c in a_spec if c not in shared]
    free_b = [c for c in b_spec if c not in shared]
    if not free_a or not free_b:
        raise ValueError(
            f"contraction {a_spec},{b_spec} leaves no free index on one "
            "side; full inner products are not supported"
        )
    stray = set(out) - set(free_a) - set(free_b)
    if stray:
        raise ValueError(
            f"output index {stray.pop()!r} appears in no operand"
        )

    # the contracted group is aligned in A-spec order on both sides
    k_order = [c for c in a_spec if c in shared]
    a_nbs, a_bss = _operand_dims(a, a_spec)
    b_nbs, b_bss = _operand_dims(b, b_spec)
    for c in k_order:
        ia, ib = a_spec.index(c), b_spec.index(c)
        if a_nbs[ia] != b_nbs[ib] or a_bss[ia] != b_bss[ib]:
            raise ValueError(
                f"contracted index {c!r} disagrees between operands: "
                f"{a_nbs[ia]} blocks of {a_bss[ia]} vs "
                f"{b_nbs[ib]} blocks of {b_bss[ib]}"
            )

    a_rows = tuple(a_spec.index(c) for c in free_a)
    a_cols = tuple(a_spec.index(c) for c in k_order)
    b_rows = tuple(b_spec.index(c) for c in k_order)
    b_cols = tuple(b_spec.index(c) for c in free_b)
    ma = _as_matrix(a, a_rows, a_cols, "A")
    mb = _as_matrix(b, b_rows, b_cols, "B")
    mc = multiply(ma, mb, mesh, engine=engine, **kw)

    out_nbs = tuple(a_nbs[a_spec.index(c)] for c in free_a) + tuple(
        b_nbs[b_spec.index(c)] for c in free_b
    )
    out_bss = tuple(a_bss[a_spec.index(c)] for c in free_a) + tuple(
        b_bss[b_spec.index(c)] for c in free_b
    )
    nat = "".join(free_a) + "".join(free_b)  # C's natural index order
    row_axes = tuple(range(len(free_a)))
    col_axes = tuple(range(len(free_a), len(nat)))
    if isinstance(mc, ShardedBSM):
        if out != nat:
            raise ValueError(
                f"sharded contraction produces index order {nat!r}; "
                f"reordering to {out!r} needs a gather — request "
                f"'->{nat}' and transpose at the chain boundary"
            )
        return MatricizedTensor(mc, row_axes, col_axes, out_nbs, out_bss), nat
    t = unmatricize(mc, row_axes, col_axes, out_nbs, out_bss)
    if out != nat:
        t = _transpose_tensor(t, tuple(nat.index(c) for c in out))
        nat = out
    return t, nat


def _as_matrix(op, rows: tuple, cols: tuple, side: str):
    """Matricize an operand for one SpGEMM — or pass its existing
    matricized form through when the split already lines up (the chaining
    path that never gathers)."""
    if isinstance(op, BlockSparseTensor):
        return matricize(op, rows, cols)
    if isinstance(op, MatricizedTensor):
        if (op.row_axes, op.col_axes) == (rows, cols):
            return op.bsm
        if op.sharded:
            raise ValueError(
                f"operand {side} is sharded under split "
                f"({op.row_axes} | {op.col_axes}) but this contraction "
                f"needs ({rows} | {cols}): re-matricizing a sharded "
                "tensor is a global redistribution — call .to_tensor() "
                "at the chain boundary and re-shard under the new split"
            )
        return matricize(op.to_tensor(), rows, cols)
    raise TypeError(
        f"operand {side} must be a BlockSparseTensor or MatricizedTensor, "
        f"got {type(op).__name__}"
    )


def _transpose_tensor(t: BlockSparseTensor, perm: tuple) -> BlockSparseTensor:
    n = t.ndim
    gp = tuple(perm)
    bp = tuple(a + n for a in gp)
    return BlockSparseTensor(
        blocks=t.blocks.permute(gp + bp),
        mask=t.mask.permute(gp),
        norms=t.norms.permute(gp),
    )


def contract(spec: str, *operands, mesh=None, engine: str = "auto", **kw):
    """Einsum-style blocked sparse tensor contraction over the SpGEMM stack.

    ``contract("ijk,kl->ijl", t1, t2, mesh=mesh, engine="auto")`` splits
    each operand's indices into (free | contracted), matricizes both onto
    block-sparse matrices whose shared k dimension carries ALL contracted
    indices (in first-operand order), multiplies via ``engine.multiply``
    and folds the product back into a tensor.  Every keyword
    (``threshold``, ``filter_eps``, ``backend``, ``l``, ``transport``, ...)
    passes through to ``multiply``, so ``backend="cuda"`` runs the kernel
    on the matricized blocks.

    Operands may be :class:`BlockSparseTensor` or
    :class:`MatricizedTensor` (see :func:`shard_tensor`).  When both
    operands of a pairwise product are sharded, the product stays sharded
    and comes back as a ``MatricizedTensor`` under its natural
    (free-A | free-B) split.

    More than two operands contract pairwise left to right; each
    intermediate keeps exactly the indices later operands or the output
    still need.
    """
    in_specs, out = _parse_spec(spec, len(operands))
    if len(operands) < 2:
        raise ValueError("contract needs at least two operands")
    acc, acc_spec = operands[0], in_specs[0]
    for i in range(1, len(operands)):
        later = set("".join(in_specs[i + 1:]))
        if i == len(operands) - 1:
            step_out = out
        else:
            keep = [c for c in acc_spec + in_specs[i]
                    if c in later or c in out]
            step_out = "".join(dict.fromkeys(keep))
        acc, acc_spec = _pair_contract(
            acc, acc_spec, operands[i], in_specs[i], step_out,
            mesh, engine, dict(kw),
        )
    return acc


def contract_reference(spec: str, *operands) -> np.ndarray:
    """Dense einsum oracle: densify every operand (in f64, on the host)
    and let ``np.einsum`` do the contraction — the ground truth ``contract``
    is held against."""
    dense = []
    for op in operands:
        t = op.to_tensor() if isinstance(op, MatricizedTensor) else op
        dense.append(t.to_dense().to(torch.float64).cpu().numpy())
    return np.einsum(spec, *dense)
