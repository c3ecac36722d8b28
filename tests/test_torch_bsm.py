"""Block-sparse matrix format: the port against the JAX reference, with
the reference's matrices carried across through ``interop``.

Masks are compared exactly; norms and block data to 1e-6 relative (f32
sums over a block may run in another order), bf16 data exactly where no
arithmetic happens.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bsm as RB
from repro_torch import interop
from repro_torch.core import bsm as PB

RTOL = 1e-6


def _ref_pair(seed, nb=4, bs=6, occupancy=0.5, dtype="float32"):
    m = RB.random_bsm(jax.random.key(seed), nb=nb, bs=bs, occupancy=occupancy,
                      pattern="random")
    if dtype == "bfloat16":
        m = m.astype(jnp.bfloat16)
    return m, interop.bsm_from_arrays(m.blocks, m.mask, m.norms, device="cpu")


def _assert_same(port, ref, rtol=RTOL):
    blocks, mask, norms = interop.bsm_to_numpy(port)
    np.testing.assert_array_equal(mask, np.asarray(ref.mask))
    np.testing.assert_allclose(blocks, np.asarray(ref.blocks, np.float32),
                               rtol=rtol, atol=rtol)
    np.testing.assert_allclose(norms, np.asarray(ref.norms), rtol=rtol,
                               atol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interop_round_trip_is_exact(dtype):
    ref, port = _ref_pair(0, dtype=dtype)
    assert port.dtype == {"float32": torch.float32,
                          "bfloat16": torch.bfloat16}[dtype]
    assert port.mask.dtype == torch.bool and port.norms.dtype == torch.float32
    blocks, mask, norms = interop.bsm_to_numpy(port)
    np.testing.assert_array_equal(blocks, np.asarray(ref.blocks, np.float32))
    np.testing.assert_array_equal(mask, np.asarray(ref.mask))
    np.testing.assert_array_equal(norms, np.asarray(ref.norms))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_norms_and_make_bsm(dtype):
    ref, port = _ref_pair(1, dtype=dtype)
    np.testing.assert_allclose(PB.block_norms(port.blocks).numpy(),
                               np.asarray(RB.block_norms(ref.blocks)),
                               rtol=RTOL)
    rng = np.random.default_rng(1)
    keep = rng.random(port.mask.shape) < 0.5
    _assert_same(PB.make_bsm(port.blocks, torch.from_numpy(keep)),
                 RB.make_bsm(ref.blocks, jnp.asarray(keep)))


@pytest.mark.parametrize("threshold", [0.0, 0.5, 1.0, 10.0])
def test_filter_bsm(threshold):
    ref, port = _ref_pair(2)
    _assert_same(PB.filter_bsm(port, threshold), RB.filter_bsm(ref, threshold))


def test_add_scale_axpy():
    ra, pa = _ref_pair(3)
    rb, pb = _ref_pair(4)
    _assert_same(PB.add(pa, pb), RB.add(ra, rb))
    _assert_same(PB.scale(pa, -2.5), RB.scale(ra, -2.5))
    _assert_same(PB.axpy(0.75, pa, pb), RB.axpy(0.75, ra, rb))
    # a device-scalar factor, as the spectral scaling passes
    s = pa.frobenius_norm()
    _assert_same(PB.scale(pa, 1.0 / s), RB.scale(ra, 1.0 / ra.frobenius_norm()))
    assert float(pa.occupancy()) == pytest.approx(float(ra.occupancy()))
    assert int(pa.nnz_blocks()) == int(ra.nnz_blocks())


@pytest.mark.parametrize("bs", [4, (2, 4), (6, 3)])
def test_identity(bs):
    _assert_same(PB.identity(6, bs, device="cpu"), RB.identity(6, bs))


@pytest.mark.parametrize("bs", [4, (4, 2)])
@pytest.mark.parametrize("threshold", [0.0, 0.8])
def test_from_dense_and_to_dense(bs, threshold):
    rng = np.random.default_rng(5)
    dense = rng.standard_normal((16, 16)).astype(np.float32)
    dense[:8, 8:] = 0.0
    port = PB.from_dense(torch.from_numpy(dense), bs, threshold)
    ref = RB.from_dense(jnp.asarray(dense), bs, threshold)
    _assert_same(port, ref)
    np.testing.assert_allclose(port.to_dense().numpy(),
                               np.asarray(ref.to_dense()), rtol=RTOL)
    with pytest.raises(ValueError, match="divisible"):
        PB.from_dense(torch.zeros(10, 10), 4)


def test_astype_recalibrates_norms():
    ref, port = _ref_pair(6)
    rq, pq = ref.astype(jnp.bfloat16), port.astype(torch.bfloat16)
    assert pq.dtype == torch.bfloat16
    _assert_same(pq, rq)  # quantization is exact on both sides
    assert port.astype(torch.float32) is port
    assert PB.cast_bsm(port, torch.float32) is port


def test_permute_and_grid_block_loads():
    ref, port = _ref_pair(7, nb=4)
    perm = np.array([2, 0, 3, 1])
    _assert_same(PB.permute(port, perm, perm[::-1]),
                 RB.permute(ref, perm, perm[::-1]))
    np.testing.assert_array_equal(PB.grid_block_loads(port.mask, 2, 2),
                                  RB.grid_block_loads(ref.mask, 2, 2))


@pytest.mark.parametrize("pattern", ["random", "banded", "decay", "dense"])
def test_random_bsm_is_seeded_and_consistent(pattern):
    a = PB.random_bsm(3, nb=6, bs=4, occupancy=0.3, pattern=pattern,
                      symmetric=True, device="cpu")
    b = PB.random_bsm(3, nb=6, bs=4, occupancy=0.3, pattern=pattern,
                      symmetric=True, device="cpu")
    assert torch.equal(a.blocks, b.blocks) and torch.equal(a.mask, b.mask)
    assert bool(a.mask.diagonal().all())  # dominant diagonal always occupied
    dense = a.to_dense()
    assert torch.equal(dense, dense.T)  # symmetric
    np.testing.assert_allclose(a.norms.numpy(),
                               PB.block_norms(a.blocks).numpy(), rtol=RTOL)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PB.identity(2, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PB.random_bsm(0, nb=2, bs=4)


@pytest.mark.parametrize("seed,nb", [(0, 8), (3, 16), (11, 64)])
def test_random_load_balance_permutation_matches_reference(seed, nb):
    """DBCSR's randomized permutation: ``default_rng(seed).permutation``;
    given a jax key's two data words it is the reference's."""
    got = PB.random_load_balance_permutation(seed, nb)
    np.testing.assert_array_equal(
        got, np.random.default_rng(seed).permutation(nb))
    assert sorted(got.tolist()) == list(range(nb))
    key = jax.random.key(seed)
    words = np.asarray(jax.random.key_data(key)).ravel()[:2]
    np.testing.assert_array_equal(
        PB.random_load_balance_permutation(words, nb),
        RB.random_load_balance_permutation(key, nb))
