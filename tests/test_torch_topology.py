"""The port's copy of the paper's topology logic (Algorithm 2) against the
reference's ``repro.core.topology``: every field and derived quantity,
``group_products`` and the numpy simulator, exactly."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import topology as RT
from repro_torch.core import topology as PT

GRIDS = [(2, 2, 1), (2, 4, 2), (4, 2, 2), (4, 4, 4), (3, 3, 1), (1, 8, 1)]


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_topology_fields_match(grid):
    want, got = RT.make_topology(*grid), PT.make_topology(*grid)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.square, got.ticks, got.total_buffers) == (
        want.square, want.ticks, want.total_buffers)
    for lay in range(want.l):
        assert got.chunk(lay) == want.chunk(lay)
        assert got.layer_groups(lay) == want.layer_groups(lay)
        assert got.fetch_counts(lay) == want.fetch_counts(lay)
    for l in range(1, 10):
        assert PT.validate_l(grid[0], grid[1], l) == RT.validate_l(
            grid[0], grid[1], l)


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_group_products_match(grid):
    want, got = RT.make_topology(*grid), PT.make_topology(*grid)
    for i in range(grid[0]):
        for j in range(grid[1]):
            assert PT.coords3d(got, i, j) == RT.coords3d(want, i, j)
            for g in range(want.ticks):
                assert PT.group_k(got, i, j, g) == RT.group_k(want, i, j, g)
                assert PT.group_products(got, i, j, g) == \
                    RT.group_products(want, i, j, g)


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_simulate_algorithm2_matches(grid):
    rng = np.random.default_rng(sum(grid))
    n = 24  # divides every grid side and V above
    a, b = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    got = PT.simulate_algorithm2(a, b, *grid)
    np.testing.assert_array_equal(got, RT.simulate_algorithm2(a, b, *grid))
    np.testing.assert_allclose(got, a @ b, rtol=1e-12, atol=1e-12)
