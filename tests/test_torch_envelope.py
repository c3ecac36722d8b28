"""The port's pattern envelopes against the reference's
``repro.core.envelope`` (both numpy float64, so exact): ``forecast_chain``
(its cube, operand-mask unions and per-sweep masks, past the symbolic fixed
point included) and ``union_envelope``, the envelope's capacities and
transport against the reference's plan layer on a duck-typed mesh.  Then
the port's chains under an envelope on the CPU: bit for bit the plain
chain's P (single device and on meshes of ranks, with compressed panels
too), every realized sweep mask inside the forecast, and a pattern outside
its envelope runs the exact path and counts a drift re-derivation.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import envelope as RE
from repro.core import plan as RP
from repro.core import transport as RT
from repro_torch.core import bsm as B
from repro_torch.core import commvolume as PC
from repro_torch.core import engine as E
from repro_torch.core import envelope as PE
from repro_torch.core import plan as PP
from repro_torch.core import signiter as PS
from repro_torch.core import transport as T
from repro_torch.launch.mesh import make_mesh, make_spgemm_mesh

from test_torch_plan_schedule import DuckMesh

THR, EPS = 1e-9, 1e-8  # the purification launchers' thresholds


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small operations per rank: with several test workers on the
    machine, torch's intra-op threads would only spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pattern(kind: str, nb: int, seed: int):
    """A symmetric entering (mask, norms) pair, unit-scaled as a chain's."""
    rng = np.random.default_rng(seed)
    if kind == "decay":
        d = np.abs(np.arange(nb)[:, None] - np.arange(nb)[None, :])
        m = rng.random((nb, nb)) < np.exp(-d / 1.5)
    elif kind == "banded":
        d = np.abs(np.arange(nb)[:, None] - np.arange(nb)[None, :])
        m = d <= 1
    else:
        m = rng.random((nb, nb)) < 0.2
    m = m | m.T | np.eye(nb, dtype=bool)
    n = np.where(m, rng.random((nb, nb)) + 0.05, 0.0).astype(np.float32)
    n = 0.5 * (n + n.T)
    return m, n / np.sqrt((n.astype(np.float64) ** 2).sum())


def _assert_same_envelope(got, want):
    for f in ("mask_a", "mask_b", "cube"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(
            getattr(want, f)))
    assert len(got.sweep_masks) == len(want.sweep_masks)
    for g, w in zip(got.sweep_masks, want.sweep_masks):
        np.testing.assert_array_equal(g, w)
    assert (got.threshold, got.filter_eps, got.margin) == (
        want.threshold, want.filter_eps, want.margin)
    assert got.signature == want.signature


@pytest.mark.parametrize("thr,eps", [(0.0, 0.0), (THR, EPS), (1e-3, 1e-3)])
@pytest.mark.parametrize("sweeps", [1, 3, 30])
@pytest.mark.parametrize("kind", ["decay", "banded", "random"])
def test_forecast_chain_matches_reference(kind, sweeps, thr, eps):
    """Equal cubes, unions and sweep masks, also for 30 sweeps: the port
    stops at the symbolic fixed point and repeats its mask."""
    m, n = _pattern(kind, 12, sweeps)
    kw = dict(sweeps=sweeps, threshold=thr, filter_eps=eps, bs=4)
    got = PE.forecast_chain(m, n, **kw)
    _assert_same_envelope(got, RE.forecast_chain(m, n, **kw))
    if sweeps == 30:  # the fixed point was reached and its mask repeated
        assert got.sweep_masks[-1] is got.sweep_masks[-2]


def test_forecast_validates_inputs():
    m, n = np.eye(4, dtype=bool), np.ones((4, 4), np.float32)
    with pytest.raises(ValueError, match="sweeps"):
        PE.forecast_chain(m, n, sweeps=0)
    with pytest.raises(ValueError, match="margin"):
        PE.forecast_chain(m, n, sweeps=1, margin=-0.1)
    with pytest.raises(ValueError, match="square"):
        PE.forecast_chain(np.ones((2, 3), bool), np.ones((2, 3)), sweeps=1)


@pytest.mark.parametrize("seed", [0, 1])
def test_union_envelope_and_capacities_match_reference(seed):
    """``union_envelope``, ``covers``, ``local_capacity``,
    ``device_capacity`` and ``transport`` equal the reference's (its plan
    layer on a duck-typed mesh of the same shape)."""
    rng = np.random.default_rng(seed)
    masks = [rng.random((16, 16)) < 0.1 for _ in range(3)]
    bmask = rng.random((16, 16)) < 0.15
    for args in ((masks,), (masks, [bmask])):
        got, want = PE.union_envelope(*args), RE.union_envelope(*args)
        _assert_same_envelope(got, want)
        assert got.local_capacity() == want.local_capacity()
        assert got.covers(masks[0]) and want.covers(masks[0])
        assert got.covers(masks[0], ~bmask) == want.covers(masks[0], ~bmask)
        for engine, sizes, l in (("cannon", (2, 2), None),
                                 ("onesided", (2, 4), None),
                                 ("twofive", (4, 4), 4),
                                 ("twofive", (2, 2, 2), None)):
            axes = ("r", "c") if len(sizes) == 2 else ("l", "r", "c")
            mesh = make_mesh(sizes, axes, device="cpu")
            duck = DuckMesh(sizes, axes)
            assert got.device_capacity(mesh, engine) == \
                want.device_capacity(duck, engine)
            for mode in ("auto", "compressed"):
                assert got.transport(mesh, engine, l, mode).key == \
                    want.transport(duck, engine, l, mode).key
    with pytest.raises(ValueError, match="do not chain"):
        PE.union_envelope([np.ones((2, 3), bool)], [np.ones((2, 3), bool)])
    RP.clear_cache()


def test_get_envelope_counts_hits_and_misses():
    m, n = _pattern("decay", 8, 0)
    PP.clear_cache()
    first = PP.get_envelope(m, n, sweeps=3, threshold=THR, filter_eps=EPS,
                            bs=4)
    assert PP.get_envelope(m, n, sweeps=3, threshold=THR, filter_eps=EPS,
                           bs=4) is first
    PP.get_envelope(m, n, sweeps=4, threshold=THR, filter_eps=EPS, bs=4)
    s = PP.cache_stats()
    assert (s["envelope_hits"], s["envelope_misses"]) == (1, 2)


def test_dispatch_cache_is_the_tuners():
    """The serving dispatch cache keys its buckets with the tuner's
    ``mask_bucket`` and records its decisions in the tuner's database
    under the deciding device's tag."""
    from repro_torch import tuner
    from repro_torch.tuner.db import TuningDB, device_tag
    from repro_torch.tuner.features import mask_bucket

    eye = np.eye(4, dtype=bool)
    mask = np.zeros((2, 4), bool)
    mask[:, :2] = True
    cache = PE.DispatchCache(eye, device="cpu")
    assert cache.bucket_of(mask) == mask_bucket(mask)
    PP.clear_cache()
    db = tuner.set_default_db(TuningDB())
    try:
        _, dec = cache.resolve(mask)
        rec = db.lookup(cache._db_key(cache.bucket_of(mask)),
                        device_tag("cpu"))
        assert rec is not None and rec["capacity"] == dec["capacity"]
        assert dec["backend"] in ("dense", "stacks")
    finally:
        PP.clear_cache()


def _hamiltonian(nb: int = 16):
    return B.random_bsm(11, nb=nb, bs=4, occupancy=0.3, pattern="decay",
                        symmetric=True, device="cpu")


CHAIN = dict(threshold=THR, filter_eps=EPS, max_iter=100, tol=1e-6,
             sync_every=3)


def _same(p, q) -> bool:
    p, q = B.unshard_bsm(p), B.unshard_bsm(q)
    return all(torch.equal(getattr(p, f), getattr(q, f))
               for f in ("blocks", "mask", "norms"))


@pytest.mark.parametrize("backend", ["stacks", "cuda", "dense"])
def test_single_device_chain_under_an_envelope_is_bitwise(backend):
    h = _hamiltonian()
    want, ws = PS.density_matrix(h, 0.0, backend=backend, **CHAIN)
    got, gs = PS.density_matrix(h, 0.0, backend=backend, envelope="auto",
                                **CHAIN)
    assert gs.envelope and not ws.envelope and gs.forecast_s > 0.0
    assert gs.iterations == ws.iterations and _same(got, want)


@pytest.mark.parametrize("transport", ["auto", "compressed", "dense"])
@pytest.mark.parametrize("mk,engine", [
    (dict(p=2, l=2), "twofive"), (dict(p=2), "cannon"),
    (dict(p_r=2, p_c=4), "twofive"), (dict(p=2), "gather")], ids=str)
def test_sharded_chain_under_an_envelope_is_bitwise(mk, engine, transport):
    """On a mesh, with each transport: P equal to the plain chain's bit for
    bit, the same sweeps, one sweep program, and each sweep's bytes equal
    two multiplies' ``plan_volume`` at the envelope's transport plus the
    psum of the three convergence partials."""
    mesh = make_spgemm_mesh(**mk, device="cpu")
    h = B.shard_bsm(_hamiltonian(), mesh)
    want, ws = PS.density_matrix(h, 0.0, engine=engine, backend="cuda",
                                 **CHAIN)
    PP.clear_cache()
    T.reset_bytes()
    got, gs = PS.density_matrix(h, 0.0, engine=engine, backend="cuda",
                                envelope="auto", transport=transport, **CHAIN)
    assert gs.iterations == ws.iterations and gs.retraces == 1
    assert _same(got, want)
    env = next(iter(PP._envelope_cache.values()))
    tr = env.transport(mesh, engine, None, transport) \
        if transport != "dense" else T.DENSE
    assert tr.compressed == (transport == "compressed" or tr.compressed)
    vol = PC.plan_volume(PP.plan_multiply(mesh, engine), 16, 4, itemsize=4,
                         transport=tr).total
    n = mesh.shape["r"] * mesh.shape["c"]
    psum = 2.0 * (n - 1) / n * 3 * 4
    assert T.bytes_moved() == pytest.approx(gs.iterations * (2 * vol + psum))


def test_realized_sweeps_stay_inside_the_forecast():
    """Sweep by sweep, the realized masks (and every multiply's operands)
    lie inside the forecast envelope."""
    mesh = make_spgemm_mesh(p=2, l=2, device="cpu")
    x = B.shard_bsm(_hamiltonian(), mesh)
    x = x.scale(1.0 / x.frobenius_norm())
    env = PP.get_envelope(B.host_mask(x), B.host_array(x.gather(x.norms)),
                          sweeps=20, threshold=THR, filter_eps=EPS, bs=4)
    sweep = PS.get_sweep_program(x, mesh, threshold=THR, filter_eps=EPS,
                                 backend="stacks", envelope=env,
                                 transport="compressed")
    ident = B.sharded_identity(16, 4, mesh)
    xb, xm, xn = x.blocks, x.mask, x.norms
    for s in range(20):
        assert env.covers(B.host_mask(B.ShardedBSM(xb, xm, xn, mesh)))
        xb, xm, xn, _, _ = sweep(xb, xm, xn, ident.blocks, ident.mask)
        realized = B.host_mask(B.ShardedBSM(xb, xm, xn, mesh))
        assert not (realized & ~env.sweep_masks[s]).any(), s


def test_non_covering_envelope_falls_back_exact():
    """A pattern outside the envelope runs on its own pattern's
    capacities (same result as no envelope) and counts a drift
    re-derivation, on one device and on a mesh."""
    a = B.random_bsm(0, nb=8, bs=4, occupancy=0.4, pattern="decay",
                     device="cpu")
    b = B.random_bsm(1, nb=8, bs=4, occupancy=0.4, device="cpu")
    tiny = PE.union_envelope([np.eye(8, dtype=bool)])
    assert not tiny.covers(B.host_mask(a))
    mesh = make_spgemm_mesh(p=2, device="cpu")
    for m in (None, mesh):
        PP.clear_cache()
        got = E.multiply(a, b, m, backend="stacks", envelope=tiny,
                         threshold=1e-8, filter_eps=1e-7,
                         transport="compressed")
        want = E.multiply(a, b, m, backend="stacks", threshold=1e-8,
                          filter_eps=1e-7, transport="compressed")
        assert torch.equal(got.blocks, want.blocks)
        assert PP.cache_stats()["drift_retunes"] == 1
    # a covering envelope: capacities from the envelope, no drift
    wide = PE.union_envelope([np.ones((8, 8), bool)])
    PP.clear_cache()
    got = E.multiply(a, b, mesh, backend="stacks", envelope=wide,
                     threshold=1e-8, filter_eps=1e-7, transport="compressed")
    assert torch.equal(got.blocks, want.blocks)
    assert PP.cache_stats()["drift_retunes"] == 0
    with pytest.raises(ValueError, match="under-cover"):
        # the full envelope's capacities would cover; a hand-made one not
        E.multiply(a, b, mesh, backend="stacks", envelope=wide,
                   transport=T.PanelTransport("compressed", 1, 1))
    assert RT.MIN_CAPACITY == T.MIN_CAPACITY
