"""The paper's 2.5D schedule on the LM head (``parallel.matmul_2p5d``)
on a CPU mesh of ranks, at the reference's ``check_matmul_2p5d`` sizes
(a (pod 2, data 2, model 4) mesh, T 16, d 32, V 64, inputs from numpy):
the product within 1e-5 of ``x @ w`` in both reduce forms, the scatter
form's bytes per rank exactly ``plan_2p5d``'s, the gradient of the
scatter form that of ``x @ w``, and ``plan_2p5d`` equal to the
reference's over a grid of shapes."""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro.parallel.matmul_2p5d import plan_2p5d as jplan
from repro_torch.core import transport as TR
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.matmul_2p5d import (
    gather_2p5d,
    matmul_2p5d,
    place_2p5d,
    plan_2p5d,
)

T, D, V = 16, 32, 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((D, V)).astype(np.float32)))


@pytest.mark.parametrize("reduce", ["scatter", "psum"])
def test_matmul_2p5d_equals_x_at_w(reduce):
    mesh = make_mesh((2, 2, 4), ("pod", "data", "model"), "cpu")
    x, w = _inputs()
    xs, ws = place_2p5d(mesh, x, w)
    assert tuple(xs[0].shape) == (T, D // 2) and tuple(ws[0].shape) == (
        D // 2, V // 4)
    TR.reset_bytes()
    out = matmul_2p5d(mesh, xs, ws, reduce=reduce)
    moved = TR.bytes_moved()
    rows = T // 2 if reduce == "scatter" else T
    assert all(tuple(o.shape) == (rows, V // 4) for o in out)
    got = gather_2p5d(mesh, out, reduce=reduce)
    np.testing.assert_allclose(got.numpy(), (x.double() @ w.double()).numpy(),
                               rtol=1e-5, atol=1e-5)
    plan = plan_2p5d(tokens=T, d_model=D, vocab=V, l=2, tp=4, bytes_per_el=4)
    if reduce == "scatter":
        assert moved == plan.bytes_2p5d  # exactly, not approximately
    else:
        assert moved == 2 * plan.bytes_2p5d  # a psum costs 2 (n-1)/n


def test_matmul_2p5d_gradient_is_that_of_x_at_w():
    mesh = make_mesh((2, 2, 4), ("pod", "data", "model"), "cpu")
    x, w = _inputs(1)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (T, V)).astype(np.float32))
    xs, ws = place_2p5d(mesh, x, w)
    xs = [t.detach().requires_grad_() for t in xs]
    ws = [t.detach().requires_grad_() for t in ws]
    out = matmul_2p5d(mesh, xs, ws, reduce="scatter")
    # every rank's output chunk gets its slice of g
    gs = [g.chunk(2, dim=0)[mesh.coords(r)[0]].chunk(4, dim=1)[
        mesh.coords(r)[2]] for r in range(mesh.size)]
    torch.autograd.backward(out, gs)
    want_dw = x.double().T @ g.double()
    for r in range(mesh.size):
        p, _, m = mesh.coords(r)
        np.testing.assert_allclose(
            ws[r].grad.numpy(),
            want_dw[p * 16:(p + 1) * 16, m * 16:(m + 1) * 16].numpy(),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tokens,d_model,vocab,l,tp,bpe", list(
    itertools.product((2048, 16384), (2048, 4096), (50304, 128256),
                      (1, 2, 4), (1, 16), (2, 4))))
def test_plan_2p5d_equals_reference(tokens, d_model, vocab, l, tp, bpe):
    got = plan_2p5d(tokens, d_model, vocab, l, tp, bpe)
    want = jplan(tokens, d_model, vocab, l, tp, bpe)
    assert (got.l, got.bytes_baseline, got.bytes_2p5d, got.wins) == (
        want.l, want.bytes_baseline, want.bytes_2p5d, want.wins)
