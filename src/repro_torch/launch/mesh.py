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

The production meshes (``make_production_mesh``): (data 16, model 16) and
(pod 2, data 16, model 16), the reference's.  The reference's dry run
forces 512 host devices; the port's (``launch/dryrun.py``) asks for
``abstract=True``: every rank on ``meta``, which holds shapes and no data
and touches no card, and marked as its own device (``Mesh.abstract``:
``Mesh.home`` keeps ranks from sharing a tensor, where a plain ``meta``
device has no index to tell them apart, and a ``torch.device`` index
stops at 127).  Not ``cuda``: a
fake CUDA tensor cannot carry autograd on a PyTorch built without CUDA
(its autograd metadata needs CUDA's device guard, and the process
aborts), and the dry run traces training steps on such a host too.  The
kernels' wrappers give ``meta`` tensors the ops' fake implementations,
as a fake tensor mode gives fake CUDA tensors, so a trace takes the
card's path.
"""
from __future__ import annotations

import functools
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
    abstract: bool = False  # every rank its own device, though all "meta"

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

    def home(self, rank: int):
        """What ranks that may share a tensor have in common: their device,
        or on an abstract mesh the rank itself (no two ranks share)."""
        return rank if self.abstract else self.devices[rank]

    @property
    def n_devices(self) -> int:
        """How many devices the ranks sit on."""
        return len({self.home(r) for r in range(self.size)})

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
        return [list(g) for g in _groups(self.axis_names, self.sizes, axes)]

    def _groups(self, axes: tuple) -> list[list[int]]:
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


@functools.lru_cache(maxsize=256)
def _groups(names: tuple, sizes: tuple, axes: tuple) -> tuple:
    """``Mesh.groups`` of a mesh's axes (its devices do not enter)."""
    mesh = Mesh(names, sizes, (None,) * math.prod(sizes))
    return tuple(tuple(g) for g in mesh._groups(axes))


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


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         abstract: bool = False) -> Mesh:
    """16 x 16 single pod (256 ranks) or 2 x 16 x 16 two-pod (512 ranks),
    the reference's shapes and axis names.  ``device`` as in
    :func:`make_mesh` (default ``cuda``; raises without one); with
    ``abstract`` every rank on ``meta`` and each its own device (the dry
    run), and ``device`` must be None."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if abstract:
        if device is not None:
            raise ValueError("an abstract mesh names no device")
        return Mesh(axes, shape, (torch.device("meta"),) * math.prod(shape),
                    abstract=True)
    return make_mesh(shape, axes, device)


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
