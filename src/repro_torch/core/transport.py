"""Panel transport: how A/B panels move between the ranks of a mesh — the
twin of ``repro/core/transport.py``, dense mode.

Engine bodies run over rank lists (``launch/mesh.py``): every panel state
is a tuple of per-rank lists, ``(blocks, mask)``, and the collectives here
take and return such lists.  They follow the reference's ``lax``
collectives:

* ``permute``  — ``lax.ppermute``: ``pairs`` index the flattened domain of
  ``axes``; a single axis name permutes inside every group of the other
  axes (every row for ``"c"``).  A rank no pair addresses receives zeros,
  and a received tensor never aliases its source.
* ``all_gather_panels`` — tiled ``lax.all_gather`` of blocks and mask.
* ``psum`` / ``psum_scatter`` — the sums over ``l`` of the stacked engine
  (and the sweep's convergence partials over ``(r, c)``).

Norms never ride the wire: ``panel_norms`` recomputes them from the
received blocks when the filter needs them.

Every collective adds the bytes it moves per destination rank to one
counter (``bytes_moved`` / ``reset_bytes``) under
``commvolume.plan_volume``'s conventions: a permute costs its full payload
(blocks and the 1-byte mask) whichever ranks it addresses, an all-gather
(n-1)/n of its output, a psum 2(n-1)/n of its input, a psum-scatter (n-1)
times its output.  The sum over one multiply equals the plan's volume.

The occupancy-compressed wire (``pack_panel``, capacities) and reduced
wire formats are ROADMAP.md Queue A item 8; asking for them raises.
The reference documents compressed transport as bit-exact against dense,
so results do not depend on the mode.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.bsm import block_norms

MODES = ("dense", "compressed")
_ITEM_8 = ("compressed and reduced-wire panel transport are ROADMAP.md "
           "Queue A item 8; this port moves dense panels")

_bytes = 0.0  # bytes per destination rank since the last reset


def bytes_moved() -> float:
    """Bytes per destination rank moved by the collectives since the last
    ``reset_bytes``."""
    return _bytes


def reset_bytes() -> None:
    global _bytes
    _bytes = 0.0


def _count(n: float) -> None:
    global _bytes
    _bytes += n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """A read-only zero tensor of ``shape`` that takes no memory (one
    element, expanded): what an unaddressed rank receives, and the C of a
    rank that computed nothing."""
    return torch.zeros((), dtype=dtype, device=device).expand(shape)


@dataclass(frozen=True)
class PanelTransport:
    """Resolved transport of one multiply (dense only in the port)."""

    mode: str = "dense"
    cap_a: int = 0
    cap_b: int = 0
    wire: str = "native"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown transport mode {self.mode!r}; "
                             f"one of {MODES}")
        if self.mode != "dense" or self.wire != "native":
            raise NotImplementedError(_ITEM_8)


DENSE = PanelTransport()


def resolve(spec) -> PanelTransport:
    """A transport argument as a ``PanelTransport``: None, ``"auto"`` and
    ``"dense"`` are dense; ``"compressed"`` raises (item 8)."""
    if isinstance(spec, PanelTransport):
        return spec
    if spec is None or spec in ("auto", "dense"):
        return DENSE
    if spec == "compressed":
        raise NotImplementedError(_ITEM_8)
    raise ValueError(f"unknown transport {spec!r}; a PanelTransport or one "
                     "of auto | dense | compressed")


def ingest(tr: PanelTransport, capacity: int, blocks: list, mask: list):
    """Panel state entering an engine body: the (blocks, mask) lists."""
    del tr, capacity  # dense: the panels travel as they are
    return (blocks, mask)


def dense_view(tr: PanelTransport, state, dtype=None):
    """(blocks, mask) lists of a panel state for the local GEMM, blocks
    cast to ``dtype`` when given."""
    del tr
    blocks, mask = state
    if dtype is not None:
        blocks = [b.to(dtype) for b in blocks]
    return blocks, mask


def panel_norms(blocks: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-block norms of a received panel for the on-the-fly filter:
    recomputed from the blocks when ``threshold > 0`` (bit-identical to the
    home norms, same op on the same data), zeros otherwise (the filter
    does not read them)."""
    if threshold > 0.0:
        return block_norms(blocks)
    return torch.zeros(blocks.shape[:2], dtype=torch.float32,
                       device=blocks.device)


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
        _count(_nbytes(xs[0]))
        out.append(ys)
    return tuple(out)


def all_gather_panels(mesh, tr: PanelTransport, capacity: int, blocks: list,
                      mask: list, axis_name: str, axis: int):
    """The gather engine's pull-from-home: a tiled all-gather of blocks
    and mask along ``axis_name``, concatenated on tensor ``axis`` (1: an A
    row panel, 0: a B column panel)."""
    del tr, capacity
    if axis not in (0, 1):
        raise ValueError(f"gather axis must be 0 or 1, got {axis}")
    out_b, out_m = [None] * mesh.size, [None] * mesh.size
    groups = mesh.groups(axis_name)
    for g in groups:
        d0 = mesh.devices[g[0]]
        gb = torch.cat([blocks[r].to(d0) for r in g], dim=axis)
        gm = torch.cat([mask[r].to(d0) for r in g], dim=axis)
        for r in g:
            out_b[r] = gb.to(mesh.devices[r])
            out_m[r] = gm.to(mesh.devices[r])
    n = len(groups[0])
    _count((n - 1) / n * (_nbytes(out_b[0]) + _nbytes(out_m[0])))
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


def psum(mesh, xs: list, axes) -> list:
    """``lax.psum`` over ``axes``: every rank gets its group's sum (ranks
    of a group on one device share the tensor)."""
    groups, sums = _group_sums(mesh, xs, axes)
    out = [None] * mesh.size
    for g, total in zip(groups, sums):
        for r in g:
            out[r] = total.to(mesh.devices[r])
    n = len(groups[0])
    _count(2.0 * (n - 1) / n * _nbytes(xs[0]))
    return out


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
    _count((n - 1) * _nbytes(out[0]))
    return out
