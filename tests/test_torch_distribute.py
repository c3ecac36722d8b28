"""The port's block->rank distribution against the reference's
``repro.core.distribute`` (both numpy, so exact): every mode's permutation
for several seeds and grids, the bin packer, the load statistics and the
cube permutation.  Then the layout on the port's side: ``shard_bsm`` under
an assignment holds the reference's permuted slices, ``unshard`` undoes
it, every engine under an assignment equals the single-device oracle, and
the plan layer's assignment cache counts its hits.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core import bsm as RB
from repro.core import distribute as RD
from repro.core import engine as RE
from repro_torch import interop
from repro_torch.core import bsm as B
from repro_torch.core import distribute as D
from repro_torch.core import engine as E
from repro_torch.core import plan as PP
from repro_torch.launch.mesh import make_mesh

from test_torch_plan_schedule import _mesh

GRIDS = [(2, 2), (2, 4), (4, 2), (1, 8)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small operations per rank: with several test workers on the
    machine, torch's intra-op threads would only spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks(nb: int, seed: int, occ: float = 0.3):
    rng = np.random.default_rng(seed)
    hub = rng.random(nb) < 0.2  # a few hub rows, as the tuner's corpus has
    a = (rng.random((nb, nb)) < occ) | hub[:, None]
    return a, a.T.copy() | np.eye(nb, dtype=bool)


@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", D.MODES)
def test_assignments_match_reference(mode, seed, grid):
    nb = 16
    am, bm = _masks(nb, seed)
    counts = D.product_counts(am, bm)
    np.testing.assert_array_equal(counts, RD.product_counts(am, bm))
    got = D.compute_assignment(mode, am, bm, grid)
    want = RD.compute_assignment(mode, am, bm, grid)
    assert (got.mode, got.perm) == (want.mode, want.perm)
    assert got.inv == want.inv and got.key == want.key
    assert got.is_identity == want.is_identity
    assert D.assignment_for(mode, counts, grid).perm == want.perm
    for asg in (None, got):
        ref = None if asg is None else want
        assert D.assignment_imbalance(counts, grid, asg) == \
            RD.assignment_imbalance(counts, grid, ref)
    np.testing.assert_array_equal(
        D.device_product_loads(counts, *grid, perm=got.perm),
        RD.device_product_loads(counts, *grid, perm=want.perm))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_explicit_constructors_match_reference(seed):
    for nb in (8, 12, 24):
        assert D.randomized_assignment(nb, seed).perm == \
            RD.randomized_assignment(nb, seed).perm
        assert D.identity_assignment(nb).perm == \
            RD.identity_assignment(nb).perm
    counts = D.product_counts(*_masks(24, seed))
    for grid in ((2, 3), (3, 4), (6, 4)):
        assert D.balance_bins(24, *grid) == RD.balance_bins(24, *grid)
        assert D.nnz_greedy_assignment(counts, *grid).perm == \
            RD.nnz_greedy_assignment(counts, *grid).perm
    ok = np.random.default_rng(seed).random((8, 8, 8)) < 0.3
    perm = D.randomized_assignment(8, seed).perm
    np.testing.assert_array_equal(D.permute_cube(ok, perm),
                                  RD.permute_cube(ok, perm))


def test_validation_errors_match_reference():
    for mod in (D, RD):
        with pytest.raises(ValueError, match="unknown assignment mode"):
            mod.Assignment("spiral", (0, 1))
        with pytest.raises(ValueError, match="not a permutation"):
            mod.Assignment("randomized", (0, 0)).validate(2, 2)
        with pytest.raises(ValueError, match="not square"):
            mod.identity_assignment(2).validate(2, 4)
        with pytest.raises(ValueError, match="does not divide"):
            mod.balance_bins(10, 4, 3)
        with pytest.raises(ValueError, match="square"):
            mod.assignment_for("nnz_greedy", np.ones((4, 6), int), (2, 2))


@pytest.mark.parametrize("mode", ["randomized", "nnz_greedy"])
def test_apply_undo_and_shard_layout(mode):
    """``apply_assignment`` equals the reference's permuted matrix, undo is
    exact, and every rank's shard is the reference's slice of it."""
    ref = RB.random_bsm(jax.random.key(5), nb=16, bs=3, occupancy=0.3,
                        pattern="decay")
    port = interop.bsm_from_arrays(ref.blocks, ref.mask, ref.norms,
                                   device="cpu")
    mesh = make_mesh((2, 2, 2), ("l", "r", "c"), device="cpu")
    asg = D.compute_assignment(mode, port.mask, port.mask, mesh)
    rasg = RD.compute_assignment(mode, np.asarray(ref.mask),
                                 np.asarray(ref.mask), (2, 2))
    assert asg.perm == rasg.perm
    want = RD.apply_assignment(ref, rasg)
    got = D.apply_assignment(port, asg)
    for f in ("blocks", "mask", "norms"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
        assert torch.equal(getattr(D.undo_assignment(got, asg), f),
                           getattr(port, f))
    s = B.shard_bsm(port, mesh, assignment=mode)
    assert s.assignment == asg
    assert B.shard_bsm(s, mesh, assignment=asg) is s
    with pytest.raises(ValueError, match="already sharded under"):
        B.shard_bsm(s, mesh, assignment="identity")
    for rank in range(mesh.size):
        _, i, j = mesh.coords(rank)
        np.testing.assert_array_equal(
            s.blocks[rank].numpy(),
            np.asarray(want.blocks)[i * 8:(i + 1) * 8, j * 8:(j + 1) * 8])
    back = s.unshard()
    for f in ("blocks", "mask", "norms"):
        assert torch.equal(getattr(back, f), getattr(port, f))
    # the identity keeps its data under any layout (P I P^T = I)
    ident = B.sharded_identity(16, 3, mesh, assignment=asg)
    assert ident.assignment == asg
    assert torch.equal(ident.unshard().blocks, B.identity(16, 3,
                                                          device="cpu").blocks)


@pytest.mark.parametrize("mode", ["randomized", "nnz_greedy"])
@pytest.mark.parametrize("engine,sizes,l", [
    ("cannon", (2, 2), None), ("onesided", (2, 4), None),
    ("gather", (4, 2), None), ("twofive", (2, 4), None),
    ("twofive", (2, 2, 2), None)], ids=str)
def test_engines_under_an_assignment_match_the_oracle(engine, sizes, l,
                                                      mode):
    """Replicated operands multiplied under an assignment come back in
    original block coordinates, equal to the reference's single-device
    product (masks exact, values within 1e-5); sharded operands carry the
    layout through the multiply."""
    ra, rb = (RB.random_bsm(jax.random.key(s), nb=16, bs=4, occupancy=0.3,
                            pattern="decay") for s in (0, 1))
    a, b = (interop.bsm_from_arrays(m.blocks, m.mask, m.norms, device="cpu")
            for m in (ra, rb))
    want = RE.multiply_reference(ra, rb, threshold=0.35, backend="jnp")
    mesh = make_mesh(sizes, _mesh(sizes), device="cpu")
    got = E.multiply(a, b, mesh, engine=engine, l=l, threshold=0.35,
                     filter_eps=0.0, backend="stacks", assignment=mode)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.blocks.numpy(), np.asarray(want.blocks),
                               rtol=1e-5, atol=1e-5)
    asg = D.compute_assignment(mode, a.mask, b.mask, mesh)
    sa, sb = (B.shard_bsm(m, mesh, assignment=asg) for m in (a, b))
    sc = E.multiply(sa, sb, engine=engine, l=l, threshold=0.35,
                    filter_eps=0.0, backend="stacks", assignment=mode)
    assert sc.assignment == asg
    np.testing.assert_allclose(sc.unshard().blocks.numpy(),
                               np.asarray(want.blocks), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="cannot execute under"):
        E.multiply(sa, sb, engine=engine, l=l, assignment="identity")


def test_plan_layer_caches_assignments():
    am, bm = _masks(16, 4)
    mesh = make_mesh((2, 4), ("r", "c"), device="cpu")
    PP.clear_cache()
    first = PP.get_assignment(am, bm, mesh, "nnz_greedy")
    assert PP.get_assignment(am, bm, mesh, "nnz_greedy") is first
    stats = PP.cache_stats()
    assert (stats["assign_hits"], stats["assign_misses"]) == (1, 1)
    m = B.make_bsm(torch.ones(16, 16, 2, 2), torch.from_numpy(am))
    assert PP.resolve_assignment("identity", m, m, mesh) is None
    assert PP.resolve_assignment(D.identity_assignment(16), m, m,
                                 mesh) is None
    asg = PP.resolve_assignment("randomized", m, m, mesh)
    assert asg.perm == RD.compute_assignment("randomized", am, am,
                                             (2, 4)).perm
    with pytest.raises(TypeError, match="assignment must be"):
        PP.resolve_assignment(3, m, m, mesh)
    with pytest.raises(ValueError, match="matrix has"):
        PP.resolve_assignment(D.identity_assignment(8), m, m, mesh)
