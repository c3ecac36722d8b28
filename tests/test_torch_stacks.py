"""Product-list compaction: the port against the JAX reference.

The seven index arrays must be bit-identical (order, k-runs, padding),
and the capacity rules, the filter cube and the pattern signature equal.
Inputs are made once with numpy and handed to both packages.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import stacks as ref_stacks
from repro_torch.kernels import stacks as port_stacks

FIELDS = ("ia", "ik", "ij", "tile", "first", "write", "valid")


def _cube(seed, ni, nk, nj, occupancy):
    rng = np.random.default_rng(seed)
    return rng.random((ni, nk, nj)) < occupancy


@pytest.mark.parametrize(
    "ni,nk,nj,occupancy,capacity",
    [
        (2, 2, 2, 0.5, "exact"),
        (5, 6, 4, 0.3, "exact"),  # ni != nk != nj
        (3, 7, 2, 0.6, "double"),  # capacity above the count
        (4, 3, 5, 0.0, 0),  # empty list, capacity 0
        (4, 3, 5, 0.0, 16),  # no survivor, padded list
        (6, 5, 4, 0.8, "tight"),  # capacity below the count: truncated
        (4, 4, 4, 1.0, "exact"),  # full cube
        (1, 9, 1, 0.5, "exact"),
    ],
)
def test_compact_pair_mask_bit_identical(ni, nk, nj, occupancy, capacity):
    ok = _cube(ni * 100 + nk * 10 + nj, ni, nk, nj, occupancy)
    n = int(ok.sum())
    cap = {"exact": ref_stacks.bucket_capacity(n),
           "double": 2 * ref_stacks.bucket_capacity(n),
           "tight": max(n - 3, 1)}.get(capacity, capacity)
    want = ref_stacks.compact_pair_mask(jnp.asarray(ok), capacity=cap)
    got = port_stacks.compact_pair_mask(torch.from_numpy(ok), capacity=cap)
    assert got.capacity == want.capacity == cap
    for f in FIELDS:
        g = getattr(got, f)
        assert g.dtype == torch.int32, f
        # exact: indices, flags and padding must match bit for bit
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_bucket_and_resolve_capacity_equal():
    for n in (0, 1, 7, 8, 9, 100, 1000, 4096, 4097, 2_695_938):
        assert port_stacks.bucket_capacity(n) == ref_stacks.bucket_capacity(n)
        assert (port_stacks.bucket_capacity(n, minimum=1)
                == ref_stacks.bucket_capacity(n, minimum=1))
    for cap, cube in ((None, 60), (8, 60), (100, 60), (0, 60)):
        assert (port_stacks.resolve_capacity(cap, cube)
                == ref_stacks.resolve_capacity(cap, cube))


@pytest.mark.parametrize("threshold", [0.0, 0.3])
def test_pair_cube_equal(threshold):
    rng = np.random.default_rng(3)
    ma, mb = rng.random((5, 6)) < 0.5, rng.random((6, 4)) < 0.5
    na = rng.random((5, 6)).astype(np.float32)
    nb_ = rng.random((6, 4)).astype(np.float32)
    want = ref_stacks.pair_cube(ma, mb, na, nb_, threshold)
    got = port_stacks.pair_cube(torch.from_numpy(ma), torch.from_numpy(mb),
                                torch.from_numpy(na), torch.from_numpy(nb_),
                                threshold)
    np.testing.assert_array_equal(got.numpy(), want)  # exact
    assert port_stacks.product_count(got) == ref_stacks.product_count(want)


@pytest.mark.parametrize("shape", [(2, 2, 2), (3, 5, 7), (4, 1, 9), (1, 1, 1)])
def test_pattern_signature_same_bytes(shape):
    ok = _cube(sum(shape), *shape, 0.4)
    want = ref_stacks.pattern_signature(ok)
    assert port_stacks.pattern_signature(torch.from_numpy(ok)) == want
    flipped = ok.copy()
    flipped.flat[0] = not flipped.flat[0]
    assert port_stacks.pattern_signature(torch.from_numpy(flipped)) != want
