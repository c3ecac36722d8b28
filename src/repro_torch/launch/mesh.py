"""Meshes of ranks for the SpGEMM engines — the twin of
``repro/launch/mesh.py``.

The reference runs one controller over a ``jax.make_mesh``: one process
drives every device, and an engine body written once per shard runs on all
of them (``shard_map``).  The port's counterpart is a ``Mesh`` of ranks
held by one process.  Each rank is a position of the mesh with its own
``torch.device``; an engine body takes one list of tensors per operand,
indexed by the flattened rank, and runs each rank's local stage in turn on
that rank's device (``core/cannon.py``, ``core/gather.py``,
``core/twofive.py``).  The collectives of ``core/transport.py`` move
tensors between the ranks' devices.

Every rank may sit on one card: the schedules, their collectives and their
byte counts are the same as on distinct cards, and every copy stays on that
card.  A list of distinct devices may be given instead.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass

import torch

from repro_torch.config import resolve_device


@dataclass(frozen=True)
class Mesh:
    """A named grid of ranks, one ``torch.device`` per rank.

    ``axis_names`` and ``sizes`` give the axes in order; ranks are the
    row-major flattening of their coordinates (``(l, r, c)`` on a stacked
    mesh).  Hashable, so plans are cached on it as the reference caches
    them on its ``jax`` mesh.
    """

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes {self.sizes}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(s < 1 for s in self.sizes):
            raise ValueError(f"mesh sizes must be positive: {self.sizes}")
        if len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size} ranks")

    @property
    def shape(self) -> OrderedDict:
        """Axis name -> size, in axis order (``jax`` mesh semantics)."""
        return OrderedDict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coords(self, rank: int) -> tuple[int, ...]:
        """Coordinates of a flattened rank, one per axis."""
        out = []
        for s in reversed(self.sizes):
            rank, c = divmod(rank, s)
            out.append(c)
        return tuple(reversed(out))

    def rank(self, coords) -> int:
        """Flattened rank of per-axis coordinates."""
        r = 0
        for c, s in zip(coords, self.sizes):
            r = r * s + c
        return r

    def groups(self, axes) -> list[list[int]]:
        """Ranks that ``axes`` span, one group per position of the other
        axes; inside a group, the row-major order of ``axes`` (the index a
        collective over ``axes`` names)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"no axis {a!r} in {self.axis_names}")
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.sizes)) if i not in idx]
        groups: dict[tuple, list[tuple[tuple, int]]] = {}
        for r in range(self.size):
            c = self.coords(r)
            key = tuple(c[i] for i in rest)
            inner = 0
            for i in idx:
                inner = inner * self.sizes[i] + c[i]
            groups.setdefault(key, []).append((inner, r))
        return [[r for _, r in sorted(g)] for _, g in sorted(groups.items())]

    def home_ranks(self) -> list[int]:
        """The (r, c) grid's ranks at depth 0, row-major: one copy of every
        shard of a matrix in the 2D home layout."""
        return [r for r in range(self.size)
                if all(c == 0 for a, c in zip(self.axis_names,
                                              self.coords(r))
                       if a not in ("r", "c"))]


def _devices(n: int, device) -> tuple[torch.device, ...]:
    """``n`` rank devices from one device spec (every rank on it) or a
    list of ``n`` distinct devices."""
    if isinstance(device, (list, tuple)):
        devs = tuple(resolve_device(d) for d in device)
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices for {n} ranks")
        if len(set(devs)) != n:
            raise ValueError("a device list names each rank's own device; "
                             f"got repeats in {devs}")
        return devs
    return (resolve_device(device),) * n


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device=None) -> Mesh:
    """Arbitrary mesh of ranks (tests / scaled-down runs).  ``device``: one
    device for every rank (default ``cuda``; raises without one), or one
    distinct device per rank."""
    shape = tuple(int(s) for s in shape)
    return Mesh(tuple(axes), shape, _devices(math.prod(shape), device))


def make_spgemm_mesh(
    *,
    p: int | None = None,
    l: int = 1,
    p_r: int | None = None,
    p_c: int | None = None,
    device=None,
) -> Mesh:
    """Mesh for the SpGEMM engines.

    ``p``          — square (r, c) grid side (``p_r = p_c = p``).
    ``p_r, p_c``   — non-square (r, c) grid (the paper's non-ideal
                     topologies); the 2.5D pull engine derives its virtual
                     depth L = max/min from the grid itself.
    ``l > 1``      — adds a depth axis: (l, r, c) mesh of l layer grids for
                     the stacked 2.5D formulation (square layers only).
    ``device``     — as in :func:`make_mesh`.
    """
    if p is not None:
        p_r = p_c = p
    if p_r is None or p_c is None:
        raise ValueError("pass p= or both p_r= and p_c=")
    if l == 1:
        return make_mesh((p_r, p_c), ("r", "c"), device)
    if p_r != p_c:
        raise ValueError(
            "stacked (l, r, c) meshes need square layer grids; non-square "
            "topologies run the 2.5D pull engine on the 2D (r, c) mesh"
        )
    return make_mesh((l, p_r, p_c), ("l", "r", "c"), device)
