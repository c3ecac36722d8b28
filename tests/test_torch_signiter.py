"""Sign iteration and density matrix: the port against the JAX reference
on the same Hamiltonian (carried across through ``interop``), and the
slice end to end through ``repro_torch.launch.purify``.

Tolerances: equal sweep counts; residual traces to 1e-4 relative (1e-7
absolute below the f32 noise floor), as the reference's own fused-vs-
legacy test; the converged X to 1e-5.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core import bsm as RB
from repro.core import signiter as RS
from repro_torch import interop
from repro_torch.core import bsm as B
from repro_torch.core import plan as plan_mod
from repro_torch.core import signiter as PS
from repro_torch.launch import purify
from repro_torch.launch.mesh import make_spgemm_mesh


def _sym(seed, nb=4, bs=6, occupancy=0.5):
    m = RB.random_bsm(jax.random.key(seed), nb=nb, bs=bs, occupancy=occupancy,
                      pattern="banded", symmetric=True)
    return m, interop.bsm_from_arrays(m.blocks, m.mask, m.norms, device="cpu")


def _assert_chain_matches(got, got_stats, want, want_stats):
    assert got_stats.converged and want_stats.converged
    assert got_stats.iterations == want_stats.iterations
    assert got_stats.multiplications == want_stats.multiplications
    np.testing.assert_allclose(got_stats.residual_trace,
                               want_stats.residual_trace, rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(got_stats.occupancy_trace,
                               want_stats.occupancy_trace, atol=1e-7)
    np.testing.assert_allclose(got.to_dense().numpy(),
                               np.asarray(want.to_dense()), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("thr,eps", [(0.0, 0.0), (1e-7, 1e-6), (1e-4, 1e-4)])
def test_legacy_matches_reference(thr, eps):
    ref, port = _sym(5)
    kw = dict(threshold=thr, filter_eps=eps, max_iter=80, tol=1e-6,
              mode="legacy")
    want, want_stats = RS.sign_iteration(ref, **kw)
    got, got_stats = PS.sign_iteration(port, backend="stacks", **kw)
    _assert_chain_matches(got, got_stats, want, want_stats)


@pytest.mark.parametrize("backend", ["dense", "stacks", "cuda"])
@pytest.mark.parametrize("thr,eps", [(0.0, 0.0), (1e-7, 1e-6), (1e-4, 1e-4)])
def test_fused_matches_reference(backend, thr, eps):
    ref, port = _sym(5)
    kw = dict(threshold=thr, filter_eps=eps, max_iter=80, tol=1e-6)
    want, want_stats = RS.sign_iteration(ref, mode="fused", backend="jnp",
                                         **kw)
    got, got_stats = PS.sign_iteration(port, mode="fused", backend=backend,
                                       **kw)
    _assert_chain_matches(got, got_stats, want, want_stats)


def test_fused_reuses_one_sweep_and_batches_syncs():
    _, port = _sym(6)
    plan_mod.clear_cache()
    s1, st1 = PS.sign_iteration(port, max_iter=80, tol=1e-6, sync_every=1,
                                backend="stacks")
    s5, st5 = PS.sign_iteration(port, max_iter=80, tol=1e-6, sync_every=5,
                                backend="stacks")
    assert st1.retraces == 1 and st5.retraces == 0  # one sweep, reused
    assert st1.converged and st5.converged
    assert st1.iterations <= st5.iterations <= st1.iterations + 4
    assert st5.host_syncs < st5.iterations
    assert len(st5.residual_trace) == st5.iterations
    np.testing.assert_allclose(s5.to_dense().numpy(), s1.to_dense().numpy(),
                               atol=1e-5)


def test_density_matrix_counts_states_and_matches_reference():
    """trace(P) == number of eigenvalues below mu (paper Eq. (1))."""
    ref, port = _sym(2, nb=4, bs=6)
    dense = np.asarray(ref.to_dense(), np.float64)
    w = np.linalg.eigvalsh(dense)
    mu = float(np.median(w)) + 1e-3
    n_occ = int((w < mu).sum())
    p, stats = PS.density_matrix(port, mu, max_iter=100, tol=1e-6,
                                 backend="cuda")
    assert stats.converged
    assert float(PS.trace(p)) == pytest.approx(n_occ, abs=1e-2)
    want, _ = RS.density_matrix(ref, mu, max_iter=100, tol=1e-6)
    np.testing.assert_allclose(p.to_dense().numpy(),
                               np.asarray(want.to_dense()), atol=1e-5)
    assert float(PS.trace(p)) == pytest.approx(float(RS.trace(want)),
                                               abs=1e-4)
    pd = p.to_dense().double()
    np.testing.assert_allclose((pd @ pd).numpy(), pd.numpy(), atol=1e-3)


def test_storage_dtype_bf16_converges_near_f32():
    _, port = _sym(7)
    s32, st32 = PS.sign_iteration(port, max_iter=80, tol=1e-6)
    s16, _ = PS.sign_iteration(port, max_iter=40, tol=1e-3, backend="stacks",
                               storage_dtype=torch.bfloat16)
    assert st32.converged and s16.dtype == torch.bfloat16
    # bf16 fixed point within ~3e-2 of the f32 one (kernels.ref's model)
    np.testing.assert_allclose(s16.to_dense().float().numpy(),
                               s32.to_dense().numpy(), atol=3e-2)


def test_mesh_raises():
    """What the chain refuses raises, as in the reference: a chain program
    needs a resolved engine (``sign_iteration`` resolves "auto" through
    the tuner first); an assignment needs a mesh; a non-dense chain
    transport needs an envelope; the legacy loop takes no sharded matrix
    and no fused-chain controls."""
    _, port = _sym(8)
    mesh = make_spgemm_mesh(p=2, device="cpu")
    with pytest.raises(ValueError, match="resolve engine='auto'"):
        PS.get_sweep_program(port, mesh, engine="auto", threshold=0.0,
                             filter_eps=0.0, backend="dense")
    with pytest.raises(ValueError, match="needs a mesh"):
        PS.sign_iteration(port, assignment="nnz_greedy")
    with pytest.raises(ValueError, match="needs an envelope"):
        PS.sign_iteration(port, mesh=mesh, transport="compressed")
    with pytest.raises(ValueError, match="fused-chain"):
        PS.sign_iteration(port, mesh=mesh, mode="legacy", envelope="auto")
    with pytest.raises(TypeError, match="replicated"):
        PS.sign_iteration(B.shard_bsm(port, mesh), mode="legacy")


def _prescaled(seed, nb=4, bs=6):
    """A Hamiltonian scaled to a unit Frobenius norm on the host, carried
    to both sides: the same input bits for ``scale_input=False``."""
    ref, _ = _sym(seed, nb=nb, bs=bs)
    ref = RB.scale(ref, float(1.0 / float(ref.frobenius_norm())))
    return ref, interop.bsm_from_arrays(ref.blocks, ref.mask, ref.norms,
                                        device="cpu")


@pytest.mark.parametrize("mode", ["fused", "legacy"])
@pytest.mark.parametrize("thr,eps", [(0.0, 0.0), (1e-7, 1e-6)])
def test_scale_input_false_matches_reference(mode, thr, eps):
    """``scale_input=False`` iterates on X0 as given, as the reference's
    does (``tests/test_envelope.py`` and ``tests/_dist.py`` call it)."""
    ref, port = _prescaled(5)
    kw = dict(threshold=thr, filter_eps=eps, max_iter=80, tol=1e-6,
              mode=mode, scale_input=False)
    want, want_stats = RS.sign_iteration(ref, backend="jnp", **kw)
    got, got_stats = PS.sign_iteration(port, backend="stacks", **kw)
    _assert_chain_matches(got, got_stats, want, want_stats)
    # without the scale the chain really starts elsewhere: a matrix of
    # norm 3 diverges from the unit-scaled chain's first residual
    big, _ = PS.sign_iteration(B.scale(port, 3.0), scale_input=False,
                               max_iter=1, tol=0.0)
    scaled, _ = PS.sign_iteration(B.scale(port, 3.0), max_iter=1, tol=0.0)
    assert not torch.allclose(big.blocks, scaled.blocks)


@pytest.mark.parametrize("capacity", [64, 256])
def test_explicit_stack_capacity_matches_reference(capacity):
    """An explicit ``stack_capacity`` is used as given (at least the
    4^3-product cube here, so sound), with the reference's result."""
    ref, port = _prescaled(3)
    kw = dict(threshold=1e-7, filter_eps=1e-6, max_iter=80, tol=1e-6,
              scale_input=False, stack_capacity=capacity)
    want, want_stats = RS.sign_iteration(ref, backend="stacks", **kw)
    plan_mod.clear_cache()
    got, got_stats = PS.sign_iteration(port, backend="stacks", **kw)
    _assert_chain_matches(got, got_stats, want, want_stats)
    # the capacity is part of the cached sweep's key: a new capacity is a
    # new sweep, the same one a hit
    PS.sign_iteration(port, backend="stacks", **kw)
    assert plan_mod.cache_stats()["chain_misses"] == 1
    PS.sign_iteration(port, backend="stacks", **{**kw,
                                                 "stack_capacity": 512})
    assert plan_mod.cache_stats()["chain_misses"] == 2


def test_explicit_capacity_wins_over_the_envelope():
    """Under an envelope the envelope's capacity applies only when the
    caller gave none; an explicit (sound) one is used as given, with the
    same result."""
    _, port = _prescaled(4)
    kw = dict(threshold=1e-7, filter_eps=1e-6, max_iter=6, tol=0.0,
              scale_input=False, backend="stacks", envelope="auto")
    plan_mod.clear_cache()
    a, _ = PS.sign_iteration(port, **kw)
    b, _ = PS.sign_iteration(port, stack_capacity=64, **kw)
    assert torch.equal(a.blocks, b.blocks) and torch.equal(a.mask, b.mask)
    keys = [k for k in plan_mod._chain_cache]
    assert {k[-1] for k in keys} == {None}  # no group layout named
    assert 64 in {k[-2] for k in keys}


@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_purify_entry_point_runs_the_slice(backend, capsys):
    argv = ["--device", "cpu", "--nb", "8", "--bs", "6", "--repeats", "2",
            "--backend", backend]
    assert purify.main(argv) == 0
    out = capsys.readouterr().out
    assert "purify OK" in out and "trace(P)=" in out
    report = purify.run(argv)
    assert report["ok"] and len(report["runs"]) == 2
    for r in report["runs"]:
        assert r["converged"] and r["trace_err"] <= purify.TRACE_TOL
        assert r["launches"] == 0  # CPU: the kernel's plain version ran
    assert report["runs"][1]["chain"]["chain_misses"] == 1  # sweep reused
