"""Panel transport: how A/B panels move between the ranks of a mesh — the
twin of ``repro/core/transport.py``.

Engine bodies run over rank lists (``launch/mesh.py``): every panel state
is a tuple of per-rank lists and the collectives here take and return such
lists.  They follow the reference's ``lax`` collectives:

* ``permute``  — ``lax.ppermute``: ``pairs`` index the flattened domain of
  ``axes``; a single axis name permutes inside every group of the other
  axes (every row for ``"c"``).  A rank no pair addresses receives zeros,
  and a received tensor never aliases its source.
* ``all_gather_panels`` — the gather engine's pull-from-home.
* ``psum`` / ``psum_scatter`` — the sums over ``l`` of the stacked engine
  (and the sweep's convergence partials over ``(r, c)``).
* ``all_gather`` / ``all_to_all`` / ``pmax`` — the sharded LM step's
  weight gathers (FSDP), sequence gathers and the 2.5D head's relayout
  (``parallel/collectives.py`` gives them, ``psum`` and ``psum_scatter``
  their backward).

Two panel states, as in the reference (DBCSR ships only occupied blocks):

* ``dense``      — ``(blocks, mask)``: the whole panel and its 1-byte mask.
* ``compressed`` — ``(packed, idx1)``: the panel's occupied blocks packed
  into a ``(capacity, bs_r, bs_c)`` buffer (padding zeroed) and their
  one-based flat positions, int32, 0 for padding (``pack_panel``).  A
  rank that a permute does not address receives zeros, which decode as an
  empty panel (``unpack_panel``).  Capacities come from the plan layer
  (``plan.get_transport``: the bucketed maximum occupied-block count over
  every panel the schedule ships), so every block arrives: decoding gives
  the dense panel bit for bit, and compressed runs are bit-exact against
  dense ones.

Norms never ride the wire: ``panel_norms`` recomputes them from the
received blocks when the filter needs them.  A reduced wire element
(``PanelTransport.wire``: bfloat16, float8_e4m3fn) rounds blocks at the
sender and widens them at the receiver: lossy, so only on request.

Every collective adds the bytes it moves per destination rank to one
counter (``bytes_moved`` / ``reset_bytes``) under
``commvolume.plan_volume``'s conventions: a permute costs its full payload
whichever ranks it addresses (dense: blocks and mask; compressed:
capacity x (block bytes + 4)), an all-gather (n-1)/n of its output, a psum
(or pmax) 2(n-1)/n of its input, a psum-scatter (n-1) times its output, an
all-to-all (n-1)/n of its input.  The sum
over one multiply equals the plan's volume for the resolved transport.
``bytes_by_kind`` splits the same counter by the reference's HLO names
(``all-reduce``, ``reduce-scatter``, ``all-gather``, ``all-to-all``,
``collective-permute``), with the number of calls of each, and
``in_collective`` is true while a collective runs: a trace
(``roofline/hlo_cost.py``) prices the copies and sums that move the data
between the ranks' tensors as wire bytes, not as the ranks' own work.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.bsm import block_norms

MODES = ("dense", "compressed")

# wire element formats: "native" ships blocks at their storage dtype; a
# reduced wire on wider storage is a lossy opt-in that the auto path never
# picks
WIRES = ("native", "bfloat16", "float8_e4m3fn")

# bucketed-capacity fill above which auto transport keeps dense panels:
# past it the 4-byte index per packed block and the pack / unpack work eat
# the byte saving, and evolving patterns would flap across the boundary
AUTO_COMPRESS_MAX_FILL = 0.25

# smallest compressed buffer (the product lists' floor too)
MIN_CAPACITY = 8

_bytes = 0.0  # bytes per destination rank since the last reset
_by_kind: dict[str, list] = {}  # kind -> [bytes, calls] since the reset
_depth = 0  # collectives running (nested: a psum inside a gather's backward)


def bytes_moved() -> float:
    """Bytes per destination rank moved by the collectives since the last
    ``reset_bytes``."""
    return _bytes


def bytes_by_kind() -> dict[str, tuple[float, int]]:
    """``bytes_moved`` by collective kind: kind -> (bytes, calls)."""
    return {k: (v[0], v[1]) for k, v in _by_kind.items()}


def reset_bytes() -> None:
    global _bytes
    _bytes = 0.0
    _by_kind.clear()


def in_collective() -> bool:
    """Whether a collective is running (its copies and sums are the wire's
    work, not a rank's)."""
    return _depth > 0


@contextlib.contextmanager
def collective_scope():
    """Work that belongs to a collective (``in_collective`` holds): the
    copies that give ranks sharing a device their own results."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def _collective(fn):
    """Mark a function as one collective: ``in_collective`` holds while it
    runs (one counter, the cost of a call's frame).  Every collective of
    the port passes here, the engines' and the training step's own
    gradient reductions as well as ``parallel/collectives.py``'s."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        global _depth
        _depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _depth -= 1
    return run


def _count(n: float, kind: str) -> None:
    global _bytes
    _bytes += n
    acc = _by_kind.setdefault(kind, [0.0, 0])
    acc[0] += n
    acc[1] += 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """A read-only zero tensor of ``shape`` that takes no memory (one
    element, expanded): what an unaddressed rank receives, and the C of a
    rank that computed nothing."""
    return torch.zeros((), dtype=dtype, device=device).expand(shape)


@dataclass(frozen=True)
class PanelTransport:
    """Resolved transport of one multiply: mode + per-panel capacities.

    ``cap_a`` / ``cap_b`` are the packed-buffer capacities (occupied
    blocks) of one shipped A / B panel — 0 in dense mode.  ``wire`` selects
    the wire element format (``WIRES``).
    """

    mode: str = "dense"
    cap_a: int = 0
    cap_b: int = 0
    wire: str = "native"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown transport mode {self.mode!r}; "
                             f"one of {MODES}")
        if self.mode == "compressed" and min(self.cap_a, self.cap_b) <= 0:
            raise ValueError(
                "compressed transport needs positive panel capacities "
                f"(got cap_a={self.cap_a}, cap_b={self.cap_b})"
            )
        if self.wire not in WIRES:
            raise ValueError(f"unknown wire format {self.wire!r}; "
                             f"one of {WIRES}")

    @property
    def compressed(self) -> bool:
        return self.mode == "compressed"

    @property
    def wire_dtype(self) -> torch.dtype | None:
        """torch dtype blocks are cast to on the wire; None = storage."""
        return None if self.wire == "native" else getattr(torch, self.wire)

    def wire_itemsize(self, storage_itemsize: float) -> float:
        """Bytes per block element on the wire: the storage width under a
        native wire, the reduced width otherwise."""
        wd = self.wire_dtype
        if wd is None:
            return storage_itemsize
        return float(torch.empty((), dtype=wd).element_size())

    @property
    def key(self) -> tuple:
        """Cache-key contribution; the wire element is appended only when
        non-native."""
        base = (self.mode, self.cap_a, self.cap_b)
        return base if self.wire == "native" else base + (self.wire,)


DENSE = PanelTransport()


# ---------------------------------------------------------------------------
# packing format
# ---------------------------------------------------------------------------


def pack_panel(blocks: torch.Tensor, mask: torch.Tensor, capacity: int):
    """Pack a (nr, nc, bs_r, bs_c) panel into its wire form.

    Returns ``(packed, idx1)``: the first ``capacity`` occupied blocks in
    flat order gathered into a ``(capacity, bs_r, bs_c)`` buffer (padding
    zeroed) and their one-based flat positions, int32 (0 = padding) — the
    reference's ``flatnonzero(size=capacity)`` order.  No host sync: each
    occupied block's slot is a cumulative sum over the flattened mask, and
    the slots below ``capacity`` are scattered (the rest, and every empty
    block, go to a spare slot that is dropped).  Blocks past ``capacity``
    are dropped; the plan layer derives capacities that cover the panel.
    """
    nr, nc = mask.shape
    n = nr * nc
    dev = blocks.device
    flat = mask.reshape(n).to(torch.bool)
    slot = torch.cumsum(flat, 0, dtype=torch.int64) - 1
    take = flat & (slot < capacity)
    dest = torch.where(take, slot, capacity)
    pos1 = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    idx = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    idx.index_copy_(0, dest, torch.where(take, pos1, 0))
    idx1 = idx[:capacity]
    valid = idx1 > 0
    src = torch.where(valid, idx1.long() - 1, 0)
    packed = blocks.reshape((n,) + tuple(blocks.shape[2:])).index_select(
        0, src)
    return packed.masked_fill_(~valid[:, None, None], 0), idx1


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def unpack_panel(packed: torch.Tensor, idx1: torch.Tensor, nr: int, nc: int):
    """Inverse of :func:`pack_panel`: the dense ``(nr, nc, bs_r, bs_c)``
    panel and its boolean mask.  Each valid row is copied to its block
    (padding rows go to a spare block that is dropped), so the panel equals
    the packed one bit for bit.  An all-zero ``idx1`` (an unaddressed
    rank's zeros) decodes as an empty panel."""
    n = nr * nc
    dev = packed.device
    valid = idx1 > 0
    dest = torch.where(valid, idx1.long() - 1, n)
    # copied as bits (an integer view of the same width), so every wire
    # element type takes the same path; zero bits are +0.0
    bits = _BITS[packed.element_size()]
    flatb = torch.zeros((n + 1,) + tuple(packed.shape[1:]), dtype=bits,
                        device=dev)
    flatb.index_copy_(0, dest, packed.contiguous().view(bits))
    flatm = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    flatm.index_fill_(0, dest, True)
    return (flatb[:n].view(packed.dtype).reshape(
                (nr, nc) + tuple(packed.shape[1:])),
            flatm[:n].reshape(nr, nc))


def panel_norms(blocks: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-block norms of a received panel for the on-the-fly filter:
    recomputed from the blocks when ``threshold > 0`` (bit-identical to the
    home norms, same op on the same data), zeros otherwise (the filter
    does not read them)."""
    if threshold > 0.0:
        return block_norms(blocks)
    return torch.zeros(blocks.shape[:2], dtype=torch.float32,
                       device=blocks.device)


# ---------------------------------------------------------------------------
# panel states (what the engine bodies carry through their tick loops)
# ---------------------------------------------------------------------------


def _to_wire(tr: PanelTransport, blocks: torch.Tensor) -> torch.Tensor:
    """Cast blocks to the wire element format (no-op for native)."""
    wd = tr.wire_dtype
    return blocks if wd is None or blocks.dtype == wd else blocks.to(wd)


def ingest(tr: PanelTransport, capacity: int, blocks: list, mask: list):
    """Panel state entering an engine body, from per-rank (blocks, mask)
    lists: ``(packed, idx1)`` lists when compressed (``pack_panel`` at
    ``capacity``), else ``(blocks, mask)``; blocks cast to the wire dtype
    when one is selected."""
    if tr.compressed:
        packed, idx1 = zip(*(pack_panel(b, m, capacity)
                             for b, m in zip(blocks, mask)))
        return [_to_wire(tr, p) for p in packed], list(idx1)
    return [_to_wire(tr, b) for b in blocks], mask


def dense_view(tr: PanelTransport, state, nr: int, nc: int, dtype=None):
    """(blocks, mask) lists of a panel state for the local GEMM, each panel
    (nr, nc) blocks; blocks widened back to ``dtype`` when given."""
    if tr.compressed:
        blocks, mask = map(list, zip(*(unpack_panel(p, i, nr, nc)
                                       for p, i in zip(*state))))
    else:
        blocks, mask = state
    if dtype is not None:
        blocks = [b if b.dtype == dtype else b.to(dtype) for b in blocks]
    return blocks, mask


@_collective
def permute(mesh, state, axes, pairs):
    """One hop: ``lax.ppermute`` of every list of ``state`` over ``axes``.

    ``pairs`` are (source, destination) indices into each group of
    ``mesh.groups(axes)``, with unique sources and unique destinations.
    Unaddressed ranks receive zeros (``zeros``: read-only, no memory);
    every received tensor is a copy on the destination rank's device."""
    pairs = tuple(pairs)
    if (len({s for s, _ in pairs}) != len(pairs)
            or len({d for _, d in pairs}) != len(pairs)):
        raise ValueError(f"pairs {pairs} are not a partial permutation")
    groups = mesh.groups(axes)
    out = []
    for xs in state:
        ys = [None] * mesh.size
        for g in groups:
            for src, dst in pairs:
                ys[g[dst]] = xs[g[src]].to(mesh.devices[g[dst]], copy=True)
        for r, y in enumerate(ys):
            if y is None:
                ys[r] = zeros(xs[r].shape, xs[r].dtype, mesh.devices[r])
        _count(_nbytes(xs[0]), "collective-permute")
        out.append(ys)
    return tuple(out)


@_collective
def all_gather_panels(mesh, tr: PanelTransport, capacity: int, blocks: list,
                      mask: list, axis_name: str, axis: int):
    """The gather engine's pull-from-home along ``axis_name``, concatenated
    on tensor ``axis`` (1: an A row panel, 0: a B column panel).

    Dense: a tiled all-gather of blocks and mask.  Compressed: an
    all-gather of each home shard's packed buffer and indices, each decoded
    into its place in the row / column panel — the gathered bytes scale
    with occupancy."""
    if axis not in (0, 1):
        raise ValueError(f"gather axis must be 0 or 1, got {axis}")
    dtype = blocks[0].dtype  # widen wire-cast blocks back after the gather
    nr, nc = mask[0].shape
    out_b, out_m = [None] * mesh.size, [None] * mesh.size
    groups = mesh.groups(axis_name)
    for g in groups:
        d0 = mesh.devices[g[0]]
        if tr.compressed:
            parts = []
            for r in g:
                packed, idx1 = pack_panel(blocks[r], mask[r], capacity)
                parts.append(unpack_panel(_to_wire(tr, packed).to(d0),
                                          idx1.to(d0), nr, nc))
            payload = _nbytes(_to_wire(tr, packed)) + _nbytes(idx1)
            gb = torch.cat([b for b, _ in parts], dim=axis)
            gm = torch.cat([m for _, m in parts], dim=axis)
        else:
            gb = torch.cat([_to_wire(tr, blocks[r]).to(d0) for r in g],
                           dim=axis)
            gm = torch.cat([mask[r].to(d0) for r in g], dim=axis)
            payload = (_nbytes(gb) + _nbytes(gm)) / len(g)
        gb = gb.to(dtype)
        for r in g:
            out_b[r] = gb.to(mesh.devices[r])
            out_m[r] = gm.to(mesh.devices[r])
    # (n - 1) / n of the gathered output, n payloads
    _count((len(groups[0]) - 1) * payload, "all-gather")
    return out_b, out_m


def _group_sums(mesh, xs: list, axes) -> tuple[list, list]:
    """(groups, the sum of each group on its first rank's device), summed
    in group order."""
    groups = mesh.groups(axes)
    sums = []
    for g in groups:
        d0 = mesh.devices[g[0]]
        total = xs[g[0]].to(d0, copy=True)
        for r in g[1:]:
            total = total + xs[r].to(d0)
        sums.append(total)
    return groups, sums


@_collective
def psum(mesh, xs: list, axes) -> list:
    """``lax.psum`` over ``axes``: every rank gets its group's sum (ranks
    of a group on one device share the tensor)."""
    groups, sums = _group_sums(mesh, xs, axes)
    out = [None] * mesh.size
    for g, total in zip(groups, sums):
        for r in g:
            out[r] = total.to(mesh.devices[r])
    n = len(groups[0])
    _count(2.0 * (n - 1) / n * _nbytes(xs[0]), "all-reduce")
    return out


@_collective
def psum_scatter(mesh, xs: list, axes, dim: int = 0) -> list:
    """Tiled ``lax.psum_scatter`` over ``axes``: the group's sum split into
    equal chunks along ``dim``, chunk m to the group's m-th rank."""
    groups, sums = _group_sums(mesh, xs, axes)
    n = len(groups[0])
    if xs[0].shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {xs[0].shape[dim]} does "
                         f"not split into {n} chunks")
    out = [None] * mesh.size
    for g, total in zip(groups, sums):
        for r, chunk in zip(g, total.chunk(n, dim=dim)):
            out[r] = chunk.to(mesh.devices[r], copy=True)
    _count((n - 1) * _nbytes(out[0]), "reduce-scatter")
    return out


@_collective
def all_gather(mesh, xs: list, axes, dim: int = 0) -> list:
    """Tiled ``lax.all_gather`` over ``axes``: every rank gets its group's
    tensors concatenated along ``dim`` in group order (ranks of a group on
    one device share the tensor)."""
    out = [None] * mesh.size
    groups = mesh.groups(axes)
    for g in groups:
        d0 = mesh.devices[g[0]]
        total = torch.cat([xs[r].to(d0) for r in g], dim=dim)
        for r in g:
            out[r] = total.to(mesh.devices[r])
    n = len(groups[0])
    # (n - 1) / n of the output
    _count((n - 1) * _nbytes(xs[0]), "all-gather")
    return out


@_collective
def all_to_all(mesh, xs: list, axes, split_dim: int, concat_dim: int) -> list:
    """Tiled ``lax.all_to_all`` over ``axes``: rank m of a group splits its
    tensor into n chunks along ``split_dim`` and sends chunk j to rank j,
    which concatenates what it receives along ``concat_dim`` in group
    order.  Costs (n - 1) / n of the input."""
    out = [None] * mesh.size
    groups = mesh.groups(axes)
    n = len(groups[0])
    if xs[0].shape[split_dim] % n:
        raise ValueError(f"dimension {split_dim} of size "
                         f"{xs[0].shape[split_dim]} does not split into {n}")
    for g in groups:
        parts = [xs[r].chunk(n, dim=split_dim) for r in g]
        for j, r in enumerate(g):
            dev = mesh.devices[r]
            out[r] = torch.cat([parts[i][j].to(dev) for i in range(n)],
                               dim=concat_dim)
    _count((n - 1) / n * _nbytes(xs[0]), "all-to-all")
    return out


def deal_foreign(n: int, parts: int, inverse: bool = False) -> int:
    """The most chunks any rank of ``deal``'s group of ``n`` receives from
    another rank (``inverse``: of the deal back)."""
    if inverse:
        return max(sum((i * parts + a) % n != i for a in range(parts))
                   for i in range(n))
    return max(sum((j + q * n) // parts != j for q in range(parts))
               for j in range(n))


@_collective
def deal(mesh, xs: list, axes, dim: int, parts: int,
         inverse: bool = False) -> list:
    """Every rank of a group splits its tensor into ``parts`` equal chunks
    along ``dim``; the group's chunks, numbered f = rank x parts + chunk in
    group order, are dealt round it: chunk f to rank f mod n, which
    concatenates its chunks along ``dim`` in the order of f.  ``inverse``
    deals them back.  With ``parts`` = n it is ``all_to_all``; with 2 it
    brings each rank its contiguous share of both halves of a tensor whose
    halves (mamba's x and z) the ranks hold contiguously in turn.  Costs
    the most any rank receives from another (``deal_foreign`` chunks)."""
    groups = mesh.groups(axes)
    n = len(groups[0])
    if xs[0].shape[dim] % parts:
        raise ValueError(f"dimension {dim} of size {xs[0].shape[dim]} does "
                         f"not split into {parts}")
    out = [None] * mesh.size
    for g in groups:
        chunks = [xs[r].chunk(parts, dim=dim) for r in g]
        for j, r in enumerate(g):
            if inverse:  # rank j's chunk a came from flat f = j parts + a
                src = [((j * parts + a) % n, (j * parts + a) // n)
                       for a in range(parts)]
            else:
                src = [((j + q * n) // parts, (j + q * n) % parts)
                       for q in range(parts)]
            dev = mesh.devices[r]
            out[r] = torch.cat([chunks[i][c].to(dev) for i, c in src],
                               dim=dim)
    _count(deal_foreign(n, parts, inverse) * _nbytes(xs[0]) / parts,
           "all-to-all")
    return out


@_collective
def pmax(mesh, xs: list, axes) -> list:
    """``lax.pmax`` over ``axes`` (priced as a psum)."""
    groups = mesh.groups(axes)
    out = [None] * mesh.size
    for g in groups:
        d0 = mesh.devices[g[0]]
        top = xs[g[0]].to(d0, copy=True)
        for r in g[1:]:
            top = torch.maximum(top, xs[r].to(d0))
        for r in g:
            out[r] = top.to(mesh.devices[r])
    n = len(groups[0])
    _count(2.0 * (n - 1) / n * _nbytes(xs[0]), "all-reduce")
    return out


# ---------------------------------------------------------------------------
# capacity bounds (host numpy, the transport analogue of
# plan.device_stack_bound)
# ---------------------------------------------------------------------------


def panel_nnz_bound(mask, row_parts: int, col_parts: int) -> int:
    """Max occupied-block count over a (row_parts x col_parts) partition
    of ``mask`` — the sound capacity for a schedule that ships those
    partitions as panels."""
    m = np.asarray(mask, bool)
    nb_r, nb_c = m.shape
    if nb_r % row_parts or nb_c % col_parts:
        raise ValueError(
            f"mask {m.shape} does not divide a {row_parts}x{col_parts} "
            "panel partition"
        )
    hr, hc = nb_r // row_parts, nb_c // col_parts
    counts = m.reshape(row_parts, hr, col_parts, hc).sum(axis=(1, 3))
    return int(counts.max()) if counts.size else 0


def plan_panel_parts(plan) -> tuple[tuple[int, int], tuple[int, int]]:
    """(row_parts, col_parts) of the A and B panels a plan ships: whole 2D
    home shards for ring / stacked / gather plans, virtual-grid subpanels
    (``ca`` column slices of an A shard, ``cb`` row slices of a B shard)
    for the pull formulation."""
    if plan.kind == "pull":
        return ((plan.p_r, plan.p_c * plan.ca),
                (plan.p_r * plan.cb, plan.p_c))
    return ((plan.p_r, plan.p_c), (plan.p_r, plan.p_c))


def bucket(n: int) -> int:
    """Power-of-two capacity bucket with the transport floor."""
    from repro_torch.kernels.stacks import bucket_capacity

    return max(MIN_CAPACITY, bucket_capacity(n))


def capacities_for(mask_a, mask_b, plan) -> tuple[int, int, int, int]:
    """Bucketed per-panel packing capacities + panel block counts of one
    (operand-mask pair, plan): ``(cap_a, cap_b, blocks_a, blocks_b)``.
    Monotone in the masks, so capacities derived from a pattern envelope
    cover every concrete panel of the chain."""
    am = np.asarray(mask_a, bool)
    bm = np.asarray(mask_b, bool)
    (ar, ac), (br, bc) = plan_panel_parts(plan)
    cap_a = bucket(panel_nnz_bound(am, ar, ac))
    cap_b = bucket(panel_nnz_bound(bm, br, bc))
    blocks_a = (am.shape[0] // ar) * (am.shape[1] // ac)
    blocks_b = (bm.shape[0] // br) * (bm.shape[1] // bc)
    return cap_a, cap_b, blocks_a, blocks_b


def resolve_mode(
    mode: str, cap_a: int, cap_b: int, blocks_a: int, blocks_b: int
) -> str:
    """``auto`` policy: compress only while the bucketed capacities stay at
    most ``AUTO_COMPRESS_MAX_FILL`` of the panel block counts."""
    if mode != "auto":
        return mode
    fill_a = cap_a / max(blocks_a, 1)
    fill_b = cap_b / max(blocks_b, 1)
    if max(fill_a, fill_b) <= AUTO_COMPRESS_MAX_FILL:
        return "compressed"
    return "dense"
