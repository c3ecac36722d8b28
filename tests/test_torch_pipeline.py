"""The GPipe schedule (``parallel.pipeline``) on a CPU mesh of ranks at the
reference's ``check_pipeline`` sizes (4 stages over ``pod``, 8
microbatches of 2 rows, d 16, stage ``tanh(x @ w)``, inputs from numpy):
every rank's output within 2e-5 of the stages composed in order, one
permute of one microbatch per tick, and ``split_microbatches`` equal to
the reference's."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel.pipeline import split_microbatches as jsplit
from repro_torch.core import transport as TR
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.pipeline import pipeline, split_microbatches

D, STAGES, MICRO = 16, 4, 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("axes", [("pod",), ("pod", "data")])
def test_pipeline_equals_sequential_composition(axes):
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((STAGES, D, D)) * D**-0.5).astype(np.float32)
    x = rng.standard_normal((MICRO, 2, D)).astype(np.float32)
    mesh = make_mesh((STAGES,) + (2,) * (len(axes) - 1), axes, "cpu")
    stage = [mesh.coords(r)[0] for r in range(mesh.size)]
    params = [torch.from_numpy(ws[s]) for s in stage]
    TR.reset_bytes()
    out = pipeline(mesh, lambda w, v: torch.tanh(v @ w), params,
                   [torch.from_numpy(x)] * mesh.size, axis="pod")
    want = x.astype(np.float64)
    for i in range(STAGES):
        want = np.tanh(want @ ws[i].astype(np.float64))
    for o in out:
        np.testing.assert_allclose(o.numpy(), want, rtol=2e-5, atol=2e-5)
    ticks = MICRO + STAGES - 1
    # a permute per tick of one (2, D) f32 activation, then the psum of
    # the banked (MICRO, 2, D) outputs
    assert TR.bytes_moved() == ticks * 2 * D * 4 + 2 * (STAGES - 1) / \
        STAGES * MICRO * 2 * D * 4


@pytest.mark.parametrize("b,n", [(8, 4), (8, 8), (6, 3), (4, 1)])
def test_split_microbatches_equals_reference(b, n):
    x = np.arange(b * 3 * 5, dtype=np.float32).reshape(b, 3, 5)
    got = split_microbatches(torch.from_numpy(x), n)
    want = np.asarray(jsplit(jnp.asarray(x), n))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
