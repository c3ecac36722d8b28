"""Single-device ``multiply``: the port against the JAX reference's
``multiply_reference`` (plus its post-filter) across backends, on-the-fly
threshold and post-filter, with the reference's matrices carried across.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bsm as RB
from repro.core import engine as RE
from repro_torch import interop
from repro_torch.core import engine as PE
from repro_torch.core import plan as plan_mod
from repro_torch.launch.mesh import make_spgemm_mesh


def _pair(seed, nb=6, bs=8, occupancy=0.4, dtype="float32"):
    m = RB.random_bsm(jax.random.key(seed), nb=nb, bs=bs, occupancy=occupancy,
                      pattern="decay", symmetric=True)
    if dtype == "bfloat16":
        m = m.astype(jnp.bfloat16)
    return m, interop.bsm_from_arrays(m.blocks, m.mask, m.norms, device="cpu")


def _ref_multiply(a, b, threshold, filter_eps):
    c = RE.multiply_reference(a, b, threshold=threshold, backend="jnp")
    eps = threshold if filter_eps is None else filter_eps
    return RB.filter_bsm(c, eps) if eps > 0.0 else c


@pytest.mark.parametrize("backend", ["dense", "stacks", "cuda", "auto", None])
@pytest.mark.parametrize("threshold,filter_eps", [(0.0, None), (0.5, None),
                                                  (0.0, 1.0), (0.3, 2.0)])
def test_multiply_matches_reference(backend, threshold, filter_eps):
    ra, pa = _pair(0)
    rb, pb = _pair(1)
    want = _ref_multiply(ra, rb, threshold, filter_eps)
    got = PE.multiply(pa, pb, threshold=threshold, filter_eps=filter_eps,
                      backend=backend)
    blocks, mask, norms = interop.bsm_to_numpy(got)
    np.testing.assert_array_equal(mask, np.asarray(want.mask))  # exact
    # f32, up to summation order
    np.testing.assert_allclose(blocks, np.asarray(want.blocks), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(norms, np.asarray(want.norms), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["dense", "stacks", "cuda"])
def test_multiply_bf16_matches_reference(backend):
    ra, pa = _pair(2, dtype="bfloat16")
    want = RE.multiply_reference(ra, ra, backend="jnp")
    got = PE.multiply(pa, pa, backend=backend)
    assert got.dtype == torch.bfloat16
    # bf16 storage: one output rounding of unit-scaled blocks
    np.testing.assert_allclose(got.blocks.float().numpy(),
                               np.asarray(want.blocks, np.float32),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def test_repeated_pattern_hits_the_product_list_cache():
    _, pa = _pair(3)
    plan_mod.clear_cache()
    first = PE.multiply(pa, pa, backend="cuda", threshold=1e-9)
    stats = plan_mod.cache_stats()
    assert (stats["pattern_hits"], stats["pattern_misses"]) == (0, 1)
    again = PE.multiply(pa, pa, backend="stacks", threshold=1e-9)
    stats = plan_mod.cache_stats()
    assert (stats["pattern_hits"], stats["pattern_misses"]) == (1, 1)
    torch.testing.assert_close(again.blocks, first.blocks, rtol=1e-6,
                               atol=1e-6)
    plan_mod.clear_cache()
    assert plan_mod.cache_stats()["pattern_misses"] == 0


def test_choose_backend_follows_the_reference():
    """Same cost model: "jnp" there is "dense" here; the compacted choice is
    "stacks" on the CPU (the reference's non-TPU choice)."""
    names = {"jnp": "dense", "stacks": "stacks"}
    for occ in (0.05, 0.3, 1.0):
        ra, pa = _pair(4, nb=8, occupancy=occ)
        want = RE.choose_backend(ra, ra, 0.0)
        assert PE.choose_backend(pa, pa, 0.0) == names[want]


@pytest.mark.parametrize("kwarg", ["transport", "assignment", "envelope"])
def test_distributed_arguments_raise(kwarg):
    """What the distributed arguments refuse raises, as in the reference:
    an unknown transport, an assignment without a mesh or of an unknown
    mode, and an envelope that is no ``Envelope`` raise — with a named
    engine and under ``engine="auto"`` (the tuner) alike."""
    _, pa = _pair(5, nb=8)
    mesh = make_spgemm_mesh(p=2, device="cpu")
    bad = {"transport": [(mesh, "zip", ValueError, "unknown transport")],
           "assignment": [(None, "nnz_greedy", ValueError, "needs a mesh"),
                          (mesh, "spiral", ValueError,
                           "unknown assignment")],
           "envelope": [(m, "auto", TypeError, "Envelope")
                        for m in (None, mesh)]}[kwarg]
    for engine in ("twofive", "auto"):
        for m, value, err, match in bad:
            with pytest.raises(err, match=match):
                PE.multiply(pa, pa, m, engine=engine, **{kwarg: value})
    with pytest.raises(ValueError, match="unknown engine"):
        PE.multiply(pa, pa, engine="summa")
