"""Local stage: every port backend against the JAX reference's dense
``local_filtered_mm(backend="jnp")`` across occupancy, threshold, dtype and
rectangular blocks; the filter cube and the C mask must be equal exactly.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import local_mm as ref_lm
from repro_torch.core import local_mm as port_lm

TOL = {"float32": 1e-5, "bfloat16": 3e-2}  # as tests/test_local_mm.py
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mats(seed, ni, nk, nj, bs_r, bs_k, bs_c, occupancy, dtype):
    """Operands made once in numpy; returns (jax args, torch args)."""
    rng = np.random.default_rng(seed)
    ab = (rng.standard_normal((ni, nk, bs_r, bs_k)) / np.sqrt(bs_k))
    bb = (rng.standard_normal((nk, nj, bs_k, bs_c)) / np.sqrt(bs_k))
    am = rng.random((ni, nk)) < occupancy
    bm = rng.random((nk, nj)) < occupancy
    ab = (ab * am[:, :, None, None]).astype(np.float32)
    bb = (bb * bm[:, :, None, None]).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jab, jbb = jnp.asarray(ab).astype(jdt), jnp.asarray(bb).astype(jdt)
    # norms of the stored (quantized) blocks, in f32, on each side
    jan = jnp.sqrt(jnp.sum(jnp.square(jab.astype(jnp.float32)), axis=(2, 3)))
    jbn = jnp.sqrt(jnp.sum(jnp.square(jbb.astype(jnp.float32)), axis=(2, 3)))
    tab = torch.from_numpy(ab).to(TORCH_DT[dtype])
    tbb = torch.from_numpy(bb).to(TORCH_DT[dtype])
    # the same norms on both sides, so the filter decisions agree exactly
    tan = torch.from_numpy(np.array(jan))
    tbn = torch.from_numpy(np.array(jbn))
    jargs = (jab, jnp.asarray(am), jan, jbb, jnp.asarray(bm), jbn)
    targs = (tab, torch.from_numpy(am), tan, tbb, torch.from_numpy(bm), tbn)
    return jargs, targs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("threshold", [0.0, 0.05])
@pytest.mark.parametrize("occupancy", [0.0, 0.05, 0.3, 1.0])
def test_backends_agree_with_reference(occupancy, threshold, dtype):
    jargs, targs = _mats(42, 5, 6, 4, 8, 8, 8, occupancy, dtype)
    want, want_m = ref_lm.local_filtered_mm(*jargs, threshold=threshold,
                                            backend="jnp")
    want32 = np.asarray(want.astype(jnp.float32))
    tol = TOL[dtype]
    for backend in port_lm.BACKENDS:
        got, got_m = port_lm.local_filtered_mm(*targs, threshold=threshold,
                                               backend=backend)
        assert got.dtype == TORCH_DT[dtype], backend
        np.testing.assert_allclose(got.float().numpy(), want32, rtol=tol,
                                   atol=tol, err_msg=backend)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("shape", [(4, 16, 8), (8, 16, 4), (23, 5, 7)])
def test_rectangular_blocks(shape):
    jargs, targs = _mats(7, 3, 4, 3, *shape, 0.6, "float32")
    want, want_m = ref_lm.local_filtered_mm(*jargs, backend="jnp")
    for backend in port_lm.BACKENDS:
        got, got_m = port_lm.local_filtered_mm(*targs, backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=backend)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("capacity", [8, 64, 10_000])
def test_explicit_stack_capacity_matches_reference(capacity):
    """An explicit capacity (clamped to the cube, truncating beyond it)
    gives the reference's result for the same capacity."""
    jargs, targs = _mats(11, 4, 5, 3, 4, 4, 4, 0.7, "float32")
    want, _ = ref_lm.local_filtered_mm(*jargs, backend="stacks",
                                       stack_capacity=capacity)
    for backend in ("stacks", "cuda"):
        got, _ = port_lm.local_filtered_mm(*targs, backend=backend,
                                           stack_capacity=capacity)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=backend)


@pytest.mark.parametrize("threshold", [0.0, 0.02, 0.5])
def test_pair_filter_equal(threshold):
    jargs, targs = _mats(3, 5, 6, 4, 4, 4, 4, 0.5, "float32")
    want = ref_lm.pair_filter(jargs[1], jargs[2], jargs[4], jargs[5],
                              threshold)
    got = port_lm.pair_filter(targs[1], targs[2], targs[4], targs[5],
                              threshold)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # exact


def test_unknown_backend_raises():
    _, targs = _mats(0, 2, 2, 2, 4, 4, 4, 1.0, "float32")
    with pytest.raises(ValueError, match="unknown backend"):
        port_lm.local_filtered_mm(*targs, backend="jnp")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cost_model_keeps_the_reference_shape(dtype):
    """Same formulas, same (placeholder) constants: the dense and stacks
    costs equal the reference's jnp and stacks costs exactly."""
    dims = (5, 6, 4, 8, 16, 8)
    for fill in (0.0, 0.1, 0.7):
        for mine, theirs in (("dense", "jnp"), ("stacks", "stacks")):
            got = port_lm.local_stage_cost(*dims, fill=fill, backend=mine,
                                           dtype=TORCH_DT[dtype])
            want = ref_lm.local_stage_cost(*dims, fill=fill, backend=theirs,
                                           dtype=jnp.dtype(dtype))
            assert (got.flops, got.hbm_bytes, got.effective) == (
                want.flops, want.hbm_bytes, want.effective)
    cuda = port_lm.local_stage_cost(*dims, fill=0.5, backend="cuda",
                                    dtype=TORCH_DT[dtype])
    assert cuda.feasible and cuda.flops == 2.0 * 0.5 * 5 * 6 * 4 * 8 * 16 * 8
