"""The paper's distributed engines in the port, over meshes of ranks on the
CPU, against the reference's single-device ``multiply_reference`` on the
same matrices (carried across with ``interop``): masks exact, values
within 1e-5 (f32; the distributed sums run in another order), for every
engine on every mesh of the schedule tests, with the ``dense``, ``stacks``
and ``cuda`` local backends (the CUDA kernel's wrapper runs its plain
version on CPU tensors) and thresholds 0 and 0.35 (the reference's own
distributed-check threshold).  Also: the stacked "scatter" layout,
sharded operands in and out, ``shard_bsm`` / ``unshard_bsm`` against the
reference's P("r", "c") slices, and the pull engine against
``topology.simulate_algorithm2``.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import bsm as RB
from repro.core import engine as RE
from repro.core import topology as RT
from repro_torch import interop
from repro_torch.core import bsm as B
from repro_torch.core import engine as E
from repro_torch.core.cannon import multiply_2d, ring_executor
from repro_torch.core.gather import multiply_gather
from repro_torch.core.plan import build_shard_body, plan_multiply
from repro_torch.core.signiter import trace
from repro_torch.core.twofive import multiply_25d
from repro_torch.launch.mesh import make_mesh

from test_torch_plan_schedule import PLANS, _mesh

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small operations per rank: with several test workers on the
    machine, torch's intra-op threads would only spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(nb: int, seed: int = 0):
    """(reference A, B, port A, B): decay pattern, occupancy 0.3."""
    out = []
    for s in (seed, seed + 1):
        m = RB.random_bsm(jax.random.key(s), nb=nb, bs=4, occupancy=0.3,
                          pattern="decay")
        out.append(m)
    return (*out, *(interop.bsm_from_arrays(m.blocks, m.mask, m.norms,
                                            device="cpu") for m in out))


@functools.lru_cache(maxsize=None)
def _oracle(nb: int, threshold: float):
    ra, rb, _, _ = _pair(nb)
    return RE.multiply_reference(ra, rb, threshold=threshold, backend="jnp")


def _nb(sizes) -> int:
    return 12 if sizes == (3, 3) else 16


def _assert_matches(got, want):
    blocks, mask, _ = interop.bsm_to_numpy(got)
    np.testing.assert_array_equal(mask, np.asarray(want.mask))
    np.testing.assert_allclose(blocks, np.asarray(want.blocks), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("threshold", [0.0, 0.35])
@pytest.mark.parametrize("backend", ["dense", "stacks", "cuda"])
@pytest.mark.parametrize("engine,sizes,l", PLANS, ids=str)
def test_engine_matches_single_device_oracle(engine, sizes, l, backend,
                                             threshold):
    nb = _nb(sizes)
    _, _, a, b = _pair(nb)
    mesh = make_mesh(sizes, _mesh(sizes), device="cpu")
    got = E.multiply(a, b, mesh, engine=engine, l=l, threshold=threshold,
                     filter_eps=0.0, backend=backend)
    assert isinstance(got, B.BlockSparseMatrix)
    _assert_matches(got, _oracle(nb, threshold))


@pytest.mark.parametrize("sizes", [(2, 2, 2), (4, 2, 2)], ids=str)
@pytest.mark.parametrize("threshold", [0.0, 0.35])
def test_stacked_scatter_layout(sizes, threshold):
    _, _, a, b = _pair(16)
    mesh = make_mesh(sizes, _mesh(sizes), device="cpu")
    got = multiply_25d(a, b, mesh, threshold=threshold, backend="stacks",
                       c_layout="scatter")
    _assert_matches(got, _oracle(16, threshold))
    # the C shards are spread over every rank: block rows r-major, l-minor
    body_rows = 16 // (sizes[1] * sizes[0])
    plan = plan_multiply(mesh, "twofive")
    sa, sb = B.shard_bsm(a, mesh), B.shard_bsm(b, mesh)
    cb, _ = build_shard_body(plan, threshold=threshold, backend="dense",
                             c_layout="scatter")(
        sa.blocks, sa.mask, sa.norms, sb.blocks, sb.mask, sb.norms)
    assert {tuple(c.shape[:2]) for c in cb} == {(body_rows, 16 // sizes[2])}


@pytest.mark.parametrize("engine,sizes,l", [
    ("cannon", (2, 2), None), ("onesided", (2, 4), None),
    ("gather", (4, 2), None), ("twofive", (2, 4), None),
    ("twofive", (4, 4), 4), ("twofive", (2, 2, 2), None),
    ("twofive", (4, 2, 2), None)], ids=str)
def test_sharded_operands_stay_sharded(engine, sizes, l):
    """ShardedBSM in, ShardedBSM out (post-filtered rank-local), equal to
    the reference's filtered single-device product."""
    _, _, a, b = _pair(16)
    ra, rb, _, _ = _pair(16)
    mesh = make_mesh(sizes, _mesh(sizes), device="cpu")
    sa, sb = B.shard_bsm(a, mesh), B.shard_bsm(b, mesh)
    got = E.multiply(sa, sb, engine=engine, l=l, threshold=0.35,
                     backend="stacks")
    assert isinstance(got, B.ShardedBSM) and got.mesh == mesh
    assert len(got.blocks) == mesh.size
    want = RB.filter_bsm(RE.multiply_reference(ra, rb, threshold=0.35), 0.35)
    _assert_matches(got.unshard(), want)
    with pytest.raises(TypeError, match="mixed"):
        E.multiply(sa, b, engine=engine)
    with pytest.raises(ValueError, match="conflicts"):
        E.multiply(sa, sb, make_mesh((1, 1), ("r", "c"), device="cpu"),
                   engine=engine)


@pytest.mark.parametrize("sizes", [(2, 2), (2, 4), (4, 2), (1, 8),
                                   (2, 2, 2), (4, 2, 2)], ids=str)
def test_shard_roundtrip_and_reference_slices(sizes):
    """Each rank's shard is the reference's P("r", "c") slice of the global
    array (every layer the same), and unshard restores the matrix."""
    ra, _, a, _ = _pair(16)
    mesh = make_mesh(sizes, _mesh(sizes), device="cpu")
    s = B.shard_bsm(a, mesh)
    assert B.shard_bsm(s, mesh) is s
    p_r, p_c = mesh.shape["r"], mesh.shape["c"]
    hr, hc = 16 // p_r, 16 // p_c
    for rank in range(mesh.size):
        c = dict(zip(mesh.axis_names, mesh.coords(rank)))
        i, j = c["r"], c["c"]
        for got, ref in ((s.blocks, ra.blocks), (s.mask, ra.mask),
                         (s.norms, ra.norms)):
            want = np.asarray(ref)[i * hr:(i + 1) * hr, j * hc:(j + 1) * hc]
            np.testing.assert_array_equal(got[rank].numpy(), want)
            assert got[rank].is_contiguous()
    back = B.unshard_bsm(s)
    for f in ("blocks", "mask", "norms"):
        assert torch.equal(getattr(back, f), getattr(a, f))
    assert B.unshard_bsm(a) is a
    assert (s.nb_r, s.nb_c, s.bs_r, s.bs_c, s.shape, s.dtype) == (
        a.nb_r, a.nb_c, a.bs_r, a.bs_c, a.shape, a.dtype)


def test_sharded_algebra_matches_replicated():
    _, _, a, b = _pair(16)
    mesh = make_mesh((2, 2, 2), ("l", "r", "c"), device="cpu")
    sa, sb = B.shard_bsm(a, mesh), B.shard_bsm(b, mesh)
    for got, want in (
            (sa.add(sb), B.add(a, b)), (sa.scale(-0.5), B.scale(a, -0.5)),
            (sa.axpy(2.0, sb), B.axpy(2.0, a, b)),
            (sa.filter(0.8), B.filter_bsm(a, 0.8)),
            (sa.astype(torch.bfloat16), a.astype(torch.bfloat16)),
            (B.sharded_identity(16, 4, mesh), B.identity(16, 4,
                                                         device="cpu"))):
        back = got.unshard()
        for f in ("blocks", "mask", "norms"):
            assert torch.equal(getattr(back, f), getattr(want, f)), f
    torch.testing.assert_close(sa.frobenius_norm(), a.frobenius_norm())
    assert int(sa.nnz_blocks()) == int(a.nnz_blocks())
    torch.testing.assert_close(sa.occupancy(), a.occupancy())
    torch.testing.assert_close(trace(sa), trace(a))
    # under an assignment: unshard undoes it, and layouts do not mix
    sg = B.shard_bsm(a, mesh, assignment="nnz_greedy")
    assert sg.assignment is not None and sg.assignment.mode == "nnz_greedy"
    back = sg.unshard()
    for f in ("blocks", "mask", "norms"):
        assert torch.equal(getattr(back, f), getattr(a, f)), f
    with pytest.raises(ValueError, match="different block assignments"):
        sg.add(sa)
    with pytest.raises(ValueError, match="divide"):
        B.shard_bsm(B.identity(6, 4, device="cpu"),
                    make_mesh((4, 4), ("r", "c"), device="cpu"))


@pytest.mark.parametrize("grid", [(2, 2, 1), (2, 4, 2), (4, 2, 2),
                                  (4, 4, 4), (1, 8, 1)], ids=str)
def test_pull_engine_matches_simulate_algorithm2(grid):
    """Dense operands, no filter: the pull body equals the reference's
    numpy simulator of Algorithm 2 (float64) within f32 rounding."""
    p_r, p_c, l = grid
    rng = np.random.default_rng(sum(grid))
    nb, bs = 8, 3
    a = rng.standard_normal((nb * bs, nb * bs)) / np.sqrt(nb * bs)
    b = rng.standard_normal((nb * bs, nb * bs)) / np.sqrt(nb * bs)
    want = RT.simulate_algorithm2(a, b, p_r, p_c, l)
    pa = B.from_dense(torch.from_numpy(a.astype(np.float32)), bs)
    pb = B.from_dense(torch.from_numpy(b.astype(np.float32)), bs)
    mesh = make_mesh((p_r, p_c), ("r", "c"), device="cpu")
    engine = "onesided" if l == 1 else "twofive"
    got = E.multiply(pa, pb, mesh, engine=engine,
                     l=l if engine == "twofive" else None, backend="stacks")
    np.testing.assert_allclose(got.to_dense().numpy(), want, rtol=TOL,
                               atol=TOL)


def test_per_engine_wrappers():
    _, _, a, b = _pair(16)
    want = _oracle(16, 0.0)
    mesh = make_mesh((2, 2), ("r", "c"), device="cpu")
    plan = plan_multiply(mesh, "cannon")
    for got in (multiply_2d(a, b, mesh), multiply_2d(a, b, mesh,
                                                     engine="onesided"),
                multiply_gather(a, b, mesh), multiply_25d(a, b, mesh),
                ring_executor(plan, threshold=0.0, backend="stacks")(a, b)):
        _assert_matches(got, want)
