"""The sharded purification chain of the port (fused sweep and legacy loop
over a mesh of ranks on the CPU) against the reference's single-device
``density_matrix`` on the same Hamiltonian (nb 16, bs 4, carried across
through ``interop``): equal sweep counts, trace within 1e-4, P within
1e-5 (f32; the distributed sums run in another order).  Plus the
entry point on a stacked mesh.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import bsm as RB
from repro.core import signiter as RS
from repro_torch import interop
from repro_torch.core import bsm as B
from repro_torch.core import commvolume as PC
from repro_torch.core import plan as plan_mod
from repro_torch.core import signiter as PS
from repro_torch.core import transport as T
from repro_torch.launch import purify
from repro_torch.launch.mesh import make_spgemm_mesh

MU = 0.0
THR, EPS = 1e-9, 1e-8  # the purification launchers' thresholds

# (mesh, engine): the pull body on a square grid and with forced L = 2,
# the stacked body, and Cannon and the gather engine on 2 x 2
MESHES = [
    (dict(p=2), "twofive"),
    (dict(p_r=2, p_c=4), "twofive"),
    (dict(p=2, l=2), "twofive"),
    (dict(p=2), "cannon"),
    (dict(p=2), "gather"),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small operations per rank: with several test workers on the
    machine, torch's intra-op threads would only spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _hamiltonian():
    """(reference H, port H, reference P, its stats)."""
    ref = RB.random_bsm(jax.random.key(11), nb=16, bs=4, occupancy=0.3,
                        pattern="decay", symmetric=True)
    port = interop.bsm_from_arrays(ref.blocks, ref.mask, ref.norms,
                                   device="cpu")
    want, stats = RS.density_matrix(ref, MU, threshold=THR, filter_eps=EPS,
                                    max_iter=100, tol=1e-6)
    return ref, port, want, stats


def _assert_matches(p, stats, want, want_stats):
    assert stats.converged and want_stats.converged
    assert stats.iterations == want_stats.iterations
    assert float(PS.trace(p)) == pytest.approx(float(RS.trace(want)),
                                               abs=1e-4)
    p = B.unshard_bsm(p)
    np.testing.assert_array_equal(p.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(p.to_dense().numpy(),
                               np.asarray(want.to_dense()), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["fused", "legacy"])
@pytest.mark.parametrize("mk,engine", MESHES, ids=str)
def test_density_matrix_on_a_mesh_matches_reference(mk, engine, mode):
    _, port, want, want_stats = _hamiltonian()
    mesh = make_spgemm_mesh(**mk, device="cpu")
    p, stats = PS.density_matrix(port, MU, mesh=mesh, engine=engine,
                                 threshold=THR, filter_eps=EPS, max_iter=100,
                                 tol=1e-6, mode=mode, backend="stacks")
    assert isinstance(p, B.BlockSparseMatrix)  # gathered at the boundary
    _assert_matches(p, stats, want, want_stats)


@pytest.mark.parametrize("mk", [dict(p=2), dict(p_r=2, p_c=4),
                                dict(p=2, l=2)], ids=str)
def test_sharded_chain_stays_sharded(mk):
    """A ShardedBSM H gives a ShardedBSM P (the CUDA backend's plain
    version on CPU tensors, sync_every 3); one sweep program serves the
    chain, and each sweep moves two multiplies' plan volume plus the
    psum of the three convergence partials."""
    _, port, want, want_stats = _hamiltonian()
    mesh = make_spgemm_mesh(**mk, device="cpu")
    h = B.shard_bsm(port, mesh)
    plan_mod.clear_cache()
    T.reset_bytes()
    p, stats = PS.density_matrix(h, MU, threshold=THR, filter_eps=EPS,
                                 max_iter=100, tol=1e-6, sync_every=3,
                                 backend="cuda")
    assert isinstance(p, B.ShardedBSM) and p.mesh == mesh
    assert stats.retraces == 1 and stats.host_syncs < stats.iterations
    # sync_every > 1 may run up to 2 sweeps past convergence
    assert want_stats.iterations <= stats.iterations \
        <= want_stats.iterations + 2
    np.testing.assert_allclose(p.to_dense().numpy(),
                               np.asarray(want.to_dense()), atol=1e-5)
    assert float(PS.trace(p)) == pytest.approx(float(RS.trace(want)),
                                               abs=1e-4)
    vol = PC.plan_volume(plan_mod.plan_multiply(mesh, "twofive"), 16, 4,
                         itemsize=4).total
    n = mesh.shape["r"] * mesh.shape["c"]
    psum = 2.0 * (n - 1) / n * 3 * 4
    assert T.bytes_moved() == pytest.approx(stats.iterations * (2 * vol
                                                                + psum))


@pytest.mark.parametrize("assignment", ["randomized", "nnz_greedy"])
@pytest.mark.parametrize("mk,engine", MESHES[:3], ids=str)
def test_density_matrix_under_an_assignment_matches_reference(
        mk, engine, assignment):
    """The chain sharded under a block->rank assignment (replicated H in,
    fused and legacy, and a ShardedBSM H that carries its layout) against
    the reference's single-device P; P comes home in original block
    coordinates."""
    _, port, want, want_stats = _hamiltonian()
    mesh = make_spgemm_mesh(**mk, device="cpu")
    kw = dict(engine=engine, threshold=THR, filter_eps=EPS, max_iter=100,
              tol=1e-6, backend="stacks")
    for mode in ("fused", "legacy"):
        p, stats = PS.density_matrix(port, MU, mesh=mesh, mode=mode,
                                     assignment=assignment, **kw)
        _assert_matches(p, stats, want, want_stats)
    h = B.shard_bsm(port, mesh, assignment=assignment)
    p, stats = PS.density_matrix(h, MU, **kw)
    assert isinstance(p, B.ShardedBSM) and p.assignment == h.assignment
    _assert_matches(p, stats, want, want_stats)
    with pytest.raises(ValueError, match="unshard before"):
        PS.density_matrix(h, MU, assignment="identity", **kw)


def test_purify_entry_point_on_a_stacked_mesh(capsys, tmp_path):
    argv = ["--device", "cpu", "--nb", "8", "--p", "2", "--l", "2"]
    report = purify.run(argv)
    assert report["ok"] and report["mesh"] == {"l": 2, "r": 2, "c": 2}
    assert report["ranks"] == 8 and report["engine"] == "twofive"
    for r in report["runs"]:
        assert r["converged"] and r["bytes_per_rank"] > 0
        assert r["local_multiplies"] == 8 * 2 * r["iterations"]
    assert purify.main(argv + ["--repeats", "1"]) == 0
    assert "bytes per rank per sweep" in capsys.readouterr().out
    # with a tuning database, --engine auto asks the tuner: a stacked
    # mesh admits only twofive, so that is what it measures and picks
    tuned = purify.run(argv + ["--tuning-db", str(tmp_path / "db.json"),
                               "--repeats", "1"])
    assert tuned["ok"] and tuned["engine"] == "twofive"
    assert tuned["tuner"]["tuner_misses"] == 1
