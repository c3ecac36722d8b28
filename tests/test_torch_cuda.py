"""Checks that need the card: the CUDA kernel against its plain version,
the launch counter, and the slice on CUDA tensors.  Marked ``gpu``; each
test skips without a CUDA device.  On the card (no jax needed):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import bsm as B
from repro_torch.core import engine as E
from repro_torch.core import signiter as S
from repro_torch.kernels import block_spgemm as K
from repro_torch.kernels import ref, stacks

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 in the oracles
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 4, 4), (23, 23, 23), (4, 16, 8),
                                   (64, 64, 64), (128, 128, 128)])
def test_kernel_matches_plain_and_oracle(cuda, shape, dtype):
    bs_r, bs_k, bs_c = shape
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((5, 6, bs_r, bs_k)) / np.sqrt(bs_k))
    b = torch.from_numpy(rng.standard_normal((6, 4, bs_k, bs_c)) / np.sqrt(bs_k))
    a, b = a.to(cuda, dtype), b.to(cuda, dtype)
    ok = torch.from_numpy(rng.random((5, 6, 4)) < 0.4).to(cuda)
    st = stacks.compact_pair_mask(
        ok, capacity=stacks.bucket_capacity(stacks.product_count(ok)))
    before = K.launches
    got = K.block_spgemm_stacks(a, b, st, ni=5, nj=4)
    assert K.launches == before + 1
    tol = TOL[dtype]
    for want in (K.block_spgemm_stacks_plain(a, b, st, ni=5, nj=4),
                 ref.block_spgemm_ref(a, b, ok)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_empty_list_launches_nothing(cuda):
    a = torch.ones(2, 3, 8, 8, device=cuda)
    ok = torch.zeros(2, 3, 2, dtype=torch.bool, device=cuda)
    before = K.launches
    c = K.block_spgemm(a, a.permute(1, 0, 2, 3).contiguous(), ok)
    assert K.launches == before and not bool(c.any())


def test_multiply_and_density_matrix_on_cuda(cuda):
    h = B.random_bsm(0, nb=16, bs=23, occupancy=0.2, pattern="decay",
                     symmetric=True, device=cuda)
    c = E.multiply(h, h, backend="cuda", threshold=1e-9)
    d = E.multiply(h, h, backend="stacks", threshold=1e-9)
    torch.testing.assert_close(c.blocks, d.blocks, rtol=1e-5, atol=1e-5)
    assert torch.equal(c.mask, d.mask)
    before = K.launches
    p, stats = S.density_matrix(h, 0.0, backend="cuda", max_iter=100,
                                tol=1e-6)
    assert stats.converged and K.launches - before == 2 * stats.iterations
    w = torch.linalg.eigvalsh(h.to_dense().double())
    assert abs(float(S.trace(p)) - int((w < 0).sum())) < 0.05
