"""Block-sparse matrix format (DBCSR analogue), the torch twin of
``repro/core/bsm.py``.

A matrix is a dense *block grid* plus a boolean occupation mask and
per-block Frobenius norms:

    blocks : (nb_r, nb_c, bs_r, bs_c)   block data (zero where unoccupied)
    mask   : (nb_r, nb_c) bool          block occupation
    norms  : (nb_r, nb_c) float32       per-block Frobenius norms

The mask and norms drive DBCSR's on-the-fly filtering (skip block products
with ``norm(A_ik) * norm(B_kj) <= eps``) and post-filtering (drop result
blocks below threshold).  All three live on one device; operations keep
them there.

``ShardedBSM`` holds the same triple in the 2D home layout of a mesh of
ranks (``launch/mesh.py``): one (blocks, mask, norms) shard per rank, block
rows split over ``r`` and block columns over ``c``, replicated over a
depth axis ``l``, optionally under a block->rank assignment
(``core/distribute.py``).  ``shard_bsm`` / ``unshard`` are the chain
boundaries.
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


def host_array(x) -> np.ndarray:
    """A mask or norms array as numpy: a tensor is copied to the host (one
    sync on a card), anything else goes through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def host_mask(m) -> np.ndarray:
    """The global block mask of a matrix as numpy: a ``ShardedBSM``'s in
    its (possibly permuted) home layout, anything else from its ``mask``
    field."""
    if isinstance(m, ShardedBSM):
        return host_array(m.gather(m.mask))
    return host_array(m.mask)


def host_norms(m) -> np.ndarray:
    """The global block norms of a matrix as float32 numpy, in the layout
    of ``host_mask``."""
    norms = m.gather(m.norms) if isinstance(m, ShardedBSM) else m.norms
    return np.asarray(host_array(norms), np.float32)


def cast_bsm(m, dtype: torch.dtype):
    """Storage-dtype cast with norm recalibration for either matrix kind
    (``BlockSparseMatrix`` or ``ShardedBSM``); identity when already at
    ``dtype``."""
    return m.astype(dtype)


# ---------------------------------------------------------------------------
# ShardedBSM: a matrix resident on a mesh of ranks
# ---------------------------------------------------------------------------

def _shard_coords(mesh, rank: int) -> tuple[int, int]:
    """(r, c) position of a rank on its layer grid."""
    c = dict(zip(mesh.axis_names, mesh.coords(rank)))
    return c["r"], c["c"]


@dataclass(frozen=True)
class ShardedBSM:
    """A block-sparse matrix resident on a mesh of ranks for the lifetime
    of an iteration chain.

    Same triple as :class:`BlockSparseMatrix`, one shard per rank in
    flattened-rank order: rank (.., i, j) holds block rows
    ``[i * nb_r / p_r, (i + 1) * nb_r / p_r)`` and the matching block
    columns over ``c``, on ``mesh.devices[rank]``.  Ranks that differ only
    in ``l`` hold the same shard (one copy per device).  The algebra runs
    rank-local and updates norms as ``BlockSparseMatrix``'s does; a chain
    shards once (``shard_bsm``) and gathers once (``unshard``).

    ``assignment`` records the block->rank distribution the triple lives
    under (``distribute.Assignment``, None = identity layout): the shards
    hold the PERMUTED matrix, ``unshard`` undoes the permutation, and every
    algebra result inherits the layout.  Mixing layouts in one operation
    raises.
    """

    blocks: tuple  # per rank: (nb_r / p_r, nb_c / p_c, bs_r, bs_c)
    mask: tuple  # per rank: bool
    norms: tuple  # per rank: float32
    mesh: object
    assignment: object = None  # distribute.Assignment or None

    @classmethod
    def from_shards(cls, blocks, mask, mesh,
                    assignment=None) -> "ShardedBSM":
        """Shards of blocks and mask, norms computed rank-local."""
        return cls(tuple(blocks), tuple(mask),
                   tuple(block_norms(b) for b in blocks), mesh, assignment)

    def _join(self, other: "ShardedBSM"):
        """The layout of an operation on ``self`` and ``other``."""
        if other.mesh != self.mesh:
            raise ValueError("operands sharded on different meshes")
        return self._join_assignment(other)

    def _join_assignment(self, other: "ShardedBSM"):
        if self.assignment != other.assignment:
            raise ValueError(
                "operands live under different block assignments "
                f"({_assign_name(self.assignment)} vs "
                f"{_assign_name(other.assignment)}); reshard one of them"
            )
        return self.assignment

    # ---- shape helpers -------------------------------------------------
    @property
    def nb_r(self) -> int:
        return self.blocks[0].shape[0] * self.mesh.shape["r"]

    @property
    def nb_c(self) -> int:
        return self.blocks[0].shape[1] * self.mesh.shape["c"]

    @property
    def bs_r(self) -> int:
        return self.blocks[0].shape[2]

    @property
    def bs_c(self) -> int:
        return self.blocks[0].shape[3]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nb_r * self.bs_r, self.nb_c * self.bs_c)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        """The first rank's device (every rank's on a one-card mesh)."""
        return self.blocks[0].device

    # ---- rank-local algebra (norms updated incrementally) --------------
    def add(self, other: "ShardedBSM") -> "ShardedBSM":
        asg = self._join(other)
        blocks = [a + b for a, b in zip(self.blocks, other.blocks)]
        return ShardedBSM.from_shards(
            blocks, [a | b for a, b in zip(self.mask, other.mask)], self.mesh,
            asg)

    def scale(self, s) -> "ShardedBSM":
        out_b, out_n = [], []
        for b, n in zip(self.blocks, self.norms):
            sr = _scalar(s, b.dtype, b.device)
            out_b.append(b * sr)
            out_n.append(n * torch.abs(sr).to(torch.float32))
        return ShardedBSM(tuple(out_b), self.mask, tuple(out_n), self.mesh,
                          self.assignment)

    def axpy(self, s, y: "ShardedBSM") -> "ShardedBSM":
        """s * self + y."""
        asg = self._join(y)
        blocks = [x * _scalar(s, x.dtype, x.device) + yb
                  for x, yb in zip(self.blocks, y.blocks)]
        return ShardedBSM.from_shards(
            blocks, [a | b for a, b in zip(self.mask, y.mask)], self.mesh,
            asg)

    def filter(self, threshold: float) -> "ShardedBSM":
        """Post-filter on the shards: drop blocks with norm <= threshold
        (derived norms, no recompute, no gather)."""
        out = [filter_bsm(BlockSparseMatrix(b, m, n), threshold)
               for b, m, n in zip(self.blocks, self.mask, self.norms)]
        return ShardedBSM(tuple(o.blocks for o in out),
                          tuple(o.mask for o in out),
                          tuple(o.norms for o in out), self.mesh,
                          self.assignment)

    def astype(self, dtype: torch.dtype) -> "ShardedBSM":
        """Cast block storage on the shards, norms recalibrated from the
        cast blocks."""
        if dtype == self.dtype:
            return self
        return ShardedBSM.from_shards([b.to(dtype) for b in self.blocks],
                                      self.mask, self.mesh, self.assignment)

    # ---- reductions (device scalars on the mesh's first device) --------
    def _home_sum(self, per_rank) -> torch.Tensor:
        """Sum of ``per_rank(rank)`` over one copy of every shard."""
        dev = self.mesh.devices[0]
        return sum(per_rank(r).to(dev) for r in self.mesh.home_ranks())

    def frobenius_norm(self) -> torch.Tensor:
        return torch.sqrt(self._home_sum(
            lambda r: torch.sum(torch.square(self.norms[r]))))

    def nnz_blocks(self) -> torch.Tensor:
        return self._home_sum(lambda r: self.mask[r].sum())

    def occupancy(self) -> torch.Tensor:
        return self.nnz_blocks().to(torch.float32) / (self.nb_r * self.nb_c)

    def trace(self) -> torch.Tensor:
        """Trace over the occupied diagonal blocks: each rank sums the
        diagonal blocks its shard holds."""
        hr, hc = self.blocks[0].shape[:2]

        def part(rank):
            i, j = _shard_coords(self.mesh, rank)
            b, m = self.blocks[rank], self.mask[rank]
            lo, hi = max(i * hr, j * hc), min((i + 1) * hr, (j + 1) * hc)
            if lo >= hi:
                return torch.zeros((), dtype=b.dtype, device=b.device)
            d = torch.arange(lo, hi, device=b.device)
            tr = torch.diagonal(b[d - i * hr, d - j * hc], dim1=-2,
                                dim2=-1).sum(-1)
            return torch.sum(tr * m[d - i * hr, d - j * hc])

        return self._home_sum(part)

    # ---- chain-boundary conversions ------------------------------------
    def gather(self, parts) -> torch.Tensor:
        """One field's shards (``self.mask``, ...) joined into the global
        array on the mesh's first device, in the home layout the shards
        hold (permuted under an assignment)."""
        dev = self.mesh.devices[0]
        p_c = self.mesh.shape["c"]
        home = self.mesh.home_ranks()
        rows = [torch.cat([parts[r].to(dev) for r in home[i:i + p_c]], dim=1)
                for i in range(0, len(home), p_c)]
        return torch.cat(rows, dim=0)

    def unshard(self) -> BlockSparseMatrix:
        """Gather the triple onto the mesh's first device — the chain
        boundary — in original block coordinates (the assignment
        undone)."""
        out = BlockSparseMatrix(blocks=self.gather(self.blocks),
                                mask=self.gather(self.mask),
                                norms=self.gather(self.norms))
        if self.assignment is not None:
            from repro_torch.core import distribute as D

            out = D.undo_assignment(out, self.assignment)
        return out

    def to_dense(self) -> torch.Tensor:
        return self.unshard().to_dense()


def _assign_name(assignment) -> str:
    return "identity" if assignment is None else assignment.mode


def _resolve_shard_assignment(m: BlockSparseMatrix, mesh, assignment):
    """A ``shard_bsm`` assignment spec as a ``distribute.Assignment`` or
    None: None / "identity" stay the identity layout; a mode string
    derives the permutation from the matrix's own mask product (X . X, the
    purification chain's pattern); an ``Assignment`` is validated.
    Identity assignments collapse to None."""
    if assignment is None:
        return None
    from repro_torch.core import distribute as D

    if isinstance(assignment, str):
        if assignment == "identity":
            return None
        host = host_mask(m)
        assignment = D.compute_assignment(assignment, host, host, mesh)
    if not isinstance(assignment, D.Assignment):
        raise TypeError(
            f"assignment must be None, a mode string {D.MODES}, or a "
            f"distribute.Assignment; got {type(assignment).__name__}"
        )
    assignment.validate(m.nb_r, m.nb_c)
    return None if assignment.is_identity else assignment


def shard_bsm(m: BlockSparseMatrix | ShardedBSM, mesh,
              assignment=None) -> ShardedBSM:
    """Scatter a BlockSparseMatrix to its 2D home layout on ``mesh``: each
    rank gets its (r, c) shard on its own device, copied once per device
    (ranks of one device that differ only in ``l`` share the copy).
    Idempotent on a matrix already sharded on ``mesh``.

    ``assignment`` selects the block->rank distribution: None keeps the
    identity layout, a mode string ("randomized" / "nnz_greedy") derives
    the permutation from the matrix's own mask, and a
    ``distribute.Assignment`` is applied as it is.  The permutation happens
    here, on the whole matrix, before the scatter (``index_select`` of
    rows, then columns): the engines only ever see the permuted layout."""
    if isinstance(m, ShardedBSM):
        if m.mesh != mesh:
            raise ValueError("matrix is already sharded on a different mesh")
        if assignment is not None:
            want = _resolve_shard_assignment(m, mesh, assignment)
            if want != m.assignment:
                raise ValueError(
                    f"matrix is already sharded under assignment "
                    f"{_assign_name(m.assignment)}; unshard before "
                    f"redistributing to {_assign_name(want)}"
                )
        return m
    if "r" not in mesh.axis_names or "c" not in mesh.axis_names:
        raise ValueError(
            f"SpGEMM meshes carry ('r', 'c') axes; got {mesh.axis_names}"
        )
    p_r, p_c = mesh.shape["r"], mesh.shape["c"]
    if m.nb_r % p_r or m.nb_c % p_c:
        raise ValueError(
            f"block grid {m.nb_r}x{m.nb_c} does not divide the "
            f"{p_r}x{p_c} process grid"
        )
    asg = _resolve_shard_assignment(m, mesh, assignment)
    if asg is not None:
        from repro_torch.core import distribute as D

        m = D.apply_assignment(m, asg)
    hr, hc = m.nb_r // p_r, m.nb_c // p_c
    copies: dict[tuple, tuple] = {}
    shards = []
    for rank in range(mesh.size):
        i, j = _shard_coords(mesh, rank)
        dev = mesh.devices[rank]
        key = (i, j, dev)
        if key not in copies:
            copies[key] = tuple(
                x[i * hr:(i + 1) * hr, j * hc:(j + 1) * hc].to(
                    dev, copy=True, memory_format=torch.contiguous_format)
                for x in (m.blocks, m.mask, m.norms))
        shards.append(copies[key])
    blocks, mask, norms = zip(*shards)
    return ShardedBSM(blocks, mask, norms, mesh, asg)


def unshard_bsm(m: BlockSparseMatrix | ShardedBSM) -> BlockSparseMatrix:
    """Chain-boundary gather; identity on an unsharded matrix."""
    return m.unshard() if isinstance(m, ShardedBSM) else m


def unshard_row_scatter(mesh, blocks, mask) -> BlockSparseMatrix:
    """Gather C from the stacked engine's ``c_layout="scatter"``: rank
    (l, r, c) holds chunk l of block-row panel r (r-major, l-minor)."""
    dev = mesh.devices[0]
    s = mesh.shape
    rows_b, rows_m = [], []
    for i in range(s["r"]):
        for li in range(s["l"]):
            ranks = [mesh.rank((li, i, j)) for j in range(s["c"])]
            rows_b.append(torch.cat([blocks[r].to(dev) for r in ranks], 1))
            rows_m.append(torch.cat([mask[r].to(dev) for r in ranks], 1))
    cb = torch.cat(rows_b, 0)
    return BlockSparseMatrix(blocks=cb, mask=torch.cat(rows_m, 0),
                             norms=block_norms(cb))


def sharded_identity(nb: int, bs, mesh, dtype: torch.dtype = torch.float32,
                     assignment=None) -> ShardedBSM:
    """Blocked identity, sharded on ``mesh`` (under ``assignment``: the
    identity is invariant, so only the layout is recorded)."""
    return shard_bsm(identity(nb, bs, dtype, device=mesh.devices[0]), mesh,
                     assignment=assignment)


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


def random_load_balance_permutation(seed, nb: int) -> np.ndarray:
    """DBCSR's randomized row/column permutation for static load balance:
    ``np.random.default_rng(seed).permutation(nb)``.  ``seed`` is anything
    ``default_rng`` takes; the reference seeds from a jax key's first two
    data words, so passing those words gives its permutation."""
    return np.random.default_rng(seed).permutation(nb)


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
