"""Parity of the port's blocked sparse tensors (``repro_torch.core.tensor``)
with the reference's ``repro.core.tensor``.

The reference draws every tensor (``jax.random``); its three arrays cross
to the port bit for bit.  Index maps (``matricize`` / ``unmatricize``)
are pure relabelings, so blocks, masks and norms must come out exactly
equal to the reference's; contractions run the same filtered SpGEMM in
another summation order, so their values are held to 1e-5 and their masks
exactly.  The sharded contraction runs on a mesh of ranks on the CPU and
is held against ``contract_reference`` and the single-device
``contract`` (the reference's own sharded check does not run under the
installed jax).
"""
from __future__ import annotations

from itertools import permutations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tensor as RT
from repro_torch.core import bsm as B
from repro_torch.core import tensor as T
from repro_torch.launch.mesh import make_spgemm_mesh

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port(t) -> T.BlockSparseTensor:
    """The reference's tensor in the port, bit for bit."""
    return T.BlockSparseTensor(
        blocks=torch.from_numpy(np.array(t.blocks)),
        mask=torch.from_numpy(np.array(t.mask)),
        norms=torch.from_numpy(np.array(t.norms)))


def _rand(seed, nbs, bss, occupancy):
    ref = RT.random_tensor(jax.random.key(seed), nbs, bss,
                           occupancy=occupancy)
    return ref, _port(ref)


def _equal(got, want) -> None:
    """Bit-equal fields: a port tensor / matrix against a reference one."""
    for f in ("blocks", "mask", "norms"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


def test_make_tensor_matches_reference():
    rng = np.random.default_rng(0)
    blocks = rng.standard_normal((2, 3, 2, 4, 5, 3)).astype(np.float32)
    mask = rng.random((2, 3, 2)) < 0.5
    want = RT.make_tensor(jnp.asarray(blocks), jnp.asarray(mask))
    got = T.make_tensor(torch.from_numpy(blocks), mask)
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(want.blocks))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.norms.numpy(), np.asarray(want.norms),
                               rtol=1e-6)
    assert got.nbs == (2, 3, 2) and got.bss == (4, 5, 3)
    assert got.shape == (8, 15, 6) and got.ndim == 3
    assert int(got.nnz_blocks()) == int(mask.sum())
    np.testing.assert_allclose(float(got.frobenius_norm()),
                               float(want.frobenius_norm()), rtol=1e-6)
    with pytest.raises(ValueError, match="2x the mask's rank"):
        T.make_tensor(torch.zeros((2, 2, 4, 4)), torch.ones((2, 2, 2)))


def test_dense_roundtrip_rectangular_blocks():
    dense = np.random.default_rng(1).standard_normal((6, 8, 10)).astype(
        np.float32)
    want = RT.from_dense_tensor(jnp.asarray(dense), (3, 2, 5))
    got = T.from_dense_tensor(torch.from_numpy(dense), (3, 2, 5))
    assert got.nbs == (2, 4, 2) and got.bss == (3, 2, 5)
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(want.blocks))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.to_dense().numpy(), dense)
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))
    with pytest.raises(ValueError, match="not divisible"):
        T.from_dense_tensor(torch.zeros((6, 7)), (3, 3))


@pytest.mark.parametrize("pattern", ["decay", "uniform"])
def test_random_tensor_keeps_diagonal(pattern):
    t = T.random_tensor(2, (5, 5, 5), 4, occupancy=0.05, pattern=pattern,
                        device="cpu")
    m = t.mask.numpy()
    assert m[np.arange(5), np.arange(5), np.arange(5)].all()
    assert 0.0 < m.mean() < 1.0
    again = T.random_tensor(2, (5, 5, 5), 4, occupancy=0.05,
                            pattern=pattern, device="cpu")
    assert torch.equal(t.blocks, again.blocks)
    with pytest.raises(ValueError, match="pattern"):
        T.random_mask(0, (3, 3), pattern="nope")


# ---------------------------------------------------------------------------
# matricization: bit-exact, and the reference's bits
# ---------------------------------------------------------------------------


def test_matricize_every_ordered_split_matches_reference():
    ref, t = _rand(3, (2, 3, 4), (3, 2, 4), 0.4)
    for perm in permutations(range(3)):
        for cut in (1, 2):
            rows, cols = perm[:cut], perm[cut:]
            m = T.matricize(t, rows, cols)
            _equal(m, RT.matricize(ref, rows, cols))
            assert m.blocks.is_contiguous()
            _equal(T.unmatricize(m, rows, cols, t.nbs, t.bss), ref)


@pytest.mark.parametrize("ndim,cut,reverse,rect", [
    (2, 1, False, False), (3, 2, True, True), (4, 1, True, True),
    (4, 3, False, True), (4, 2, True, False)])
@pytest.mark.parametrize("occupancy", [0.0, 0.5, 1.0])
def test_matricize_roundtrip_ranks(ndim, cut, reverse, rect, occupancy):
    nbs = (2, 3, 4, 2)[:ndim]
    bss = (3, 2, 4, 5)[:ndim] if rect else (3,) * ndim
    ref, t = _rand(ndim + cut, nbs, bss, occupancy)
    axes = tuple(range(ndim))[::-1] if reverse else tuple(range(ndim))
    rows, cols = axes[:cut], axes[cut:]
    m = T.matricize(t, rows, cols)
    _equal(m, RT.matricize(ref, rows, cols))
    _equal(T.unmatricize(m, rows, cols, t.nbs, t.bss), ref)


def test_matricize_carries_norms_and_checks_splits():
    ref, t = _rand(4, (3, 2, 2), (2, 5, 3), 0.3)
    m = T.matricize(t, (2, 0), (1,))
    assert int(m.mask.sum()) == int(t.mask.sum())
    np.testing.assert_allclose(m.norms.numpy(),
                               B.block_norms(m.blocks).numpy(), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="do not fold"):
        T.unmatricize(T.matricize(t, (0, 1), (2,)), (0,), (1, 2), t.nbs,
                      t.bss)
    with pytest.raises(ValueError, match="at least one index"):
        T.matricize(t, (0, 1, 2), ())
    with pytest.raises(ValueError, match="partition"):
        T.matricize(t, (0,), (0, 1))


# ---------------------------------------------------------------------------
# contract: the reference's results
# ---------------------------------------------------------------------------


def _pair(seed=7, nb=3, bs=4):
    t = _rand(seed, (nb, nb, nb), bs, 0.3)
    m = _rand(seed + 1, (nb, nb), bs, 0.6)
    return t, m


def _check(spec, refs, ports, **kw):
    want = RT.contract(spec, *refs, **kw)
    got = T.contract(spec, *ports, **kw)
    assert isinstance(got, T.BlockSparseTensor)
    assert got.nbs == tuple(want.nbs) and got.bss == tuple(want.bss)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.to_dense().numpy(),
                               np.asarray(want.to_dense()), rtol=TOL,
                               atol=TOL)
    if not kw.get("threshold"):  # the oracle does not filter
        np.testing.assert_allclose(got.to_dense().numpy(),
                                   T.contract_reference(spec, *ports),
                                   rtol=TOL, atol=TOL)
    return got


@pytest.mark.parametrize("backend", [None, "stacks", "cuda", "auto"])
def test_contract_three_center(backend):
    """``backend`` passes through to ``engine.multiply``; ``cuda`` on CPU
    tensors is the kernel's plain version."""
    (rt, t), (rm, m) = _pair()
    kw = {} if backend is None else {"backend": backend}
    out = _check("ijk,kl->ijl", (rt, rm), (t, m))
    got = T.contract("ijk,kl->ijl", t, m, **kw)
    assert torch.equal(got.mask, out.mask)
    np.testing.assert_allclose(got.blocks.numpy(), out.blocks.numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("spec", ["ijk,kl->lij", "ijk,kl->jil"])
def test_contract_permuted_output(spec):
    (rt, t), (rm, m) = _pair(seed=9)
    _check(spec, (rt, rm), (t, m))


def test_contract_multi_index_contraction():
    (rt, t), _ = _pair(seed=11)
    rt2, t2 = _rand(20, (3, 3, 3), 4, 0.3)
    _check("ijk,mjk->im", (rt, rt2), (t, t2))


def test_contract_rectangular_blocks():
    rt, t = _rand(12, (2, 3, 4), (3, 2, 4), 0.5)
    rm, m = _rand(13, (4, 3), (4, 5), 0.7)
    out = _check("ijk,kl->ijl", (rt, rm), (t, m))
    assert out.bss == (3, 2, 5)


def test_contract_chain_three_operands():
    (rt, t), (rm, m) = _pair(seed=15)
    rm2, m2 = _rand(16, (3, 3), 4, 0.6)
    _check("ijk,kl,lm->ijm", (rt, rm, rm2), (t, m, m2))


@pytest.mark.parametrize("threshold", [0.5, 1e6])
def test_contract_threshold_filters(threshold):
    (rt, t), (rm, m) = _pair(seed=17)
    _check("ijk,kl->ijl", (rt, rm), (t, m), threshold=threshold)
    exact = T.contract("ijk,kl->ijl", t, m)
    loose = T.contract("ijk,kl->ijl", t, m, threshold=1e6)
    assert int(loose.mask.sum()) < int(exact.mask.sum())


@pytest.mark.parametrize("spec,ops,err,match", [
    ("ijk,kl", "pair", ValueError, "->"),
    ("iik,kl->il", "pair", ValueError, "trace"),
    ("ijk,kl->ijkl", "pair", NotImplementedError, "batch"),
    ("ij,kl->ijkl", "square", ValueError, "outer"),
    ("ij,ij->", "square", ValueError, "no free index"),
    ("ijk,kl->ijz", "pair", ValueError, "appears in no operand"),
    ("ijk,kl->ijl", "mismatch", ValueError, "disagrees"),
    ("ijk->ijk", "one", ValueError, "two operands"),
    ("ijk,kl->ijl", "foreign", TypeError, "BlockSparseTensor"),
])
def test_contract_rejections_match_reference(spec, ops, err, match):
    (rt, t), (rm, m) = _pair()
    sq = [_rand(21 + i, (2, 2), 3, 1.0) for i in range(2)]
    cases = {
        "pair": ((rt, rm), (t, m)),
        "square": ((sq[0][0], sq[1][0]), (sq[0][1], sq[1][1])),
        "mismatch": ((_rand(25, (2, 2, 3), 4, 1.0)[0],
                      _rand(26, (2, 2), 4, 1.0)[0]),
                     (_rand(25, (2, 2, 3), 4, 1.0)[1],
                      _rand(26, (2, 2), 4, 1.0)[1])),
        "one": ((rt,), (t,)),
        "foreign": ((rt, np.zeros((12, 12))), (t, np.zeros((12, 12)))),
    }
    refs, ports = cases[ops]
    with pytest.raises(err, match=match):
        RT.contract(spec, *refs)
    with pytest.raises(err, match=match):
        T.contract(spec, *ports)


# ---------------------------------------------------------------------------
# sharded contraction on a mesh of ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["gather", "cannon", "twofive"])
def test_sharded_contract_stays_sharded(engine):
    """Both operands sharded: the product stays sharded under its natural
    (ij | l) split and feeds the next contraction without a gather; every
    result equals the single-device contraction and the einsum oracle."""
    mesh = make_spgemm_mesh(p=2, device="cpu")
    (_, t), (_, m) = _pair(seed=31, nb=4, bs=3)
    _, m2 = _rand(33, (4, 4), 3, 0.6)
    st = T.shard_tensor(t, mesh, (0, 1), (2,))
    sm = T.shard_tensor(m, mesh, (0,), (1,))
    sm2 = T.shard_tensor(m2, mesh, (0,), (1,))
    assert st.sharded and "sharded" in repr(st)
    got = T.contract("ijk,kl->ijl", st, sm, mesh=mesh, engine=engine)
    assert isinstance(got, T.MatricizedTensor) and got.sharded
    assert (got.row_axes, got.col_axes) == ((0, 1), (2,))
    single = T.contract("ijk,kl->ijl", t, m)
    dense = got.to_tensor()
    np.testing.assert_array_equal(dense.mask.numpy(), single.mask.numpy())
    np.testing.assert_allclose(dense.to_dense().numpy(),
                               single.to_dense().numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        dense.to_dense().numpy(), T.contract_reference("ijk,kl->ijl", t, m),
        rtol=TOL, atol=TOL)
    chained = T.contract("ijl,lm->ijm", got, sm2, mesh=mesh, engine=engine)
    assert chained.sharded
    np.testing.assert_allclose(
        chained.to_tensor().to_dense().numpy(),
        T.contract_reference("ijk,kl,lm->ijm", t, m, m2), rtol=1e-4,
        atol=1e-4)
    with pytest.raises(ValueError, match="needs a gather"):
        T.contract("ijk,kl->lij", st, sm, mesh=mesh, engine=engine)
    with pytest.raises(ValueError, match="re-shard"):
        T.contract("ijl,jm->ilm", got, sm2, mesh=mesh, engine=engine)


# ---------------------------------------------------------------------------
# the tuner corpus's three-center entry
# ---------------------------------------------------------------------------


def test_corpus_three_center_build_contracts():
    import importlib

    PC = importlib.import_module("repro_torch.tuner.corpus")
    e = next(x for x in PC.corpus(smoke=True) if x.kind == "three_center")
    t, b = e.build_tensor(device="cpu")
    a, b2 = e.build(device="cpu")
    ma, mb = e.masks()
    np.testing.assert_array_equal(a.mask.numpy(), ma)
    np.testing.assert_array_equal(b.mask.numpy(), mb)
    assert torch.equal(b.blocks, b2.blocks)
    np.testing.assert_array_equal(t.mask.reshape(-1, e.nb).numpy(), ma)
    bt = T.BlockSparseTensor(b.blocks, b.mask, b.norms)
    out = T.contract("ijk,kl->ijl", t, bt, backend="stacks")
    np.testing.assert_allclose(out.to_dense().numpy(),
                               T.contract_reference("ijk,kl->ijl", t, bt),
                               rtol=1e-4, atol=1e-4)
