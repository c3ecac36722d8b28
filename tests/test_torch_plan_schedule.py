"""The port's schedule layer against the reference's ``repro.core.plan``:
``plan_multiply`` field by field on every mesh the engines run on, the
same ``ValueError``s, and ``validate_blocks``.

The reference's ``plan_multiply`` only reads a mesh's ``shape`` and
``axis_names`` (and hashes it for its cache), so a small duck-typed mesh
builds its plans on the CPU without devices; the port's plan is built on
the same duck mesh and on the port's own ``Mesh``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import pytest

from repro.core import plan as RP
from repro_torch.core import plan as PP
from repro_torch.launch.mesh import make_mesh


class DuckMesh:
    """Just what ``plan_multiply`` reads: ``shape`` and ``axis_names``."""

    def __init__(self, sizes, axes):
        self.axis_names = tuple(axes)
        self.sizes = tuple(sizes)
        self.shape = OrderedDict(zip(axes, sizes))

    def __hash__(self):
        return hash((self.axis_names, self.sizes))

    def __eq__(self, other):
        return (isinstance(other, DuckMesh)
                and (self.axis_names, self.sizes)
                == (other.axis_names, other.sizes))


def _mesh(sizes):
    return ("r", "c") if len(sizes) == 2 else ("l", "r", "c")


# (engine, mesh sizes, l): the meshes the port's engines are held on
PLANS = [
    ("cannon", (2, 2), None), ("cannon", (3, 3), None),
    *[(e, s, None) for e in ("onesided", "gather")
      for s in ((2, 2), (2, 4), (4, 2), (1, 8))],
    ("twofive", (2, 4), None), ("twofive", (4, 2), None),
    ("twofive", (4, 4), 4),
    ("twofive", (2, 2, 2), None), ("twofive", (4, 2, 2), None),
]


def plan_fields(plan) -> dict:
    """Every field of a plan but its mesh, nested dataclasses as dicts."""
    d = dataclasses.asdict(dataclasses.replace(plan, mesh=None))
    del d["mesh"]
    return d


@pytest.mark.parametrize("engine,sizes,l", PLANS, ids=str)
def test_plan_matches_reference_field_by_field(engine, sizes, l):
    duck = DuckMesh(sizes, _mesh(sizes))
    want = RP.plan_multiply(duck, engine, l)
    got = PP.plan_multiply(duck, engine, l)
    assert plan_fields(got) == plan_fields(want)
    assert got.mesh is duck and got.l == want.l
    # the port's own mesh gives the same schedule
    mesh = make_mesh(sizes, _mesh(sizes), device="cpu")
    assert plan_fields(PP.plan_multiply(mesh, engine, l)) == plan_fields(want)


ERRORS = [
    ("summa", (2, 2), None),  # unknown engine
    ("cannon", (2, 4), None),  # Cannon needs a square grid
    ("onesided", (2, 2), 2),  # no depth parameter
    ("gather", (2, 2), 1),
    ("cannon", (2, 2, 2), None),  # 'l' axis is twofive's
    ("twofive", (2, 2, 2), 4),  # l conflicts with the mesh
    ("twofive", (2, 2, 4), None),  # stacked needs square layers
    ("twofive", (2, 4), 3),  # L invalid for the grid
    ("twofive", (2, 2), 2),
]


@pytest.mark.parametrize("engine,sizes,l", ERRORS, ids=str)
def test_plan_errors_match_reference(engine, sizes, l):
    duck = DuckMesh(sizes, _mesh(sizes))
    with pytest.raises(ValueError) as want:
        RP.plan_multiply(duck, engine, l)
    with pytest.raises(ValueError) as got:
        PP.plan_multiply(duck, engine, l)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("engine,sizes,l", PLANS, ids=str)
def test_validate_blocks_matches_reference(engine, sizes, l):
    duck = DuckMesh(sizes, _mesh(sizes))
    want = RP.plan_multiply(duck, engine, l)
    got = PP.plan_multiply(duck, engine, l)
    for grid in ((8, 8, None), (12, 12, None), (16, 16, None), (6, 6, None),
                 (8, 16, 8), (8, 8, 12), (16, 8, 4), (24, 24, 6)):
        outcome = []
        for plan in (want, got):
            try:
                plan.validate_blocks(*grid)
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], grid


def test_schedule_helpers_match_reference():
    pairs = [(0, 1), (0, 2), (0, 3), (1, 4), (2, 4), (3, 0)]
    assert PP._partition_rounds(pairs) == RP._partition_rounds(pairs)
    for p in range(1, 6):
        for shift in (1, 2):
            assert PP._ring_perm(p, shift) == RP._ring_perm(p, shift)
    for p_r, p_c, l in ((2, 4, None), (4, 2, None), (2, 2, None), (3, 9, None),
                        (2, 8, None), (4, 4, 4)):
        assert PP._resolve_l(p_r, p_c, l) == RP._resolve_l(p_r, p_c, l)
