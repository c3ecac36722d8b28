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
    """What the chain refuses raises, as in the reference: the tuner
    (engine="auto" on a mesh, backend="auto" under an envelope) names its
    item; an assignment needs a mesh; a non-dense chain transport needs an
    envelope; the legacy loop takes no sharded matrix and no fused-chain
    controls."""
    _, port = _sym(8)
    mesh = make_spgemm_mesh(p=2, device="cpu")
    with pytest.raises(NotImplementedError, match="tuner"):
        PS.sign_iteration(port, mesh=mesh, engine="auto")
    with pytest.raises(NotImplementedError, match="item 10"):
        PS.sign_iteration(port, mesh=mesh, envelope="auto", backend="auto",
                          max_iter=2)
    with pytest.raises(ValueError, match="needs a mesh"):
        PS.sign_iteration(port, assignment="nnz_greedy")
    with pytest.raises(ValueError, match="needs an envelope"):
        PS.sign_iteration(port, mesh=mesh, transport="compressed")
    with pytest.raises(ValueError, match="fused-chain"):
        PS.sign_iteration(port, mesh=mesh, mode="legacy", envelope="auto")
    with pytest.raises(TypeError, match="replicated"):
        PS.sign_iteration(B.shard_bsm(port, mesh), mode="legacy")


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
