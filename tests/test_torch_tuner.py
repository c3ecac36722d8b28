"""The port's tuner (``repro_torch.tuner``) against the reference's
``repro.tuner`` on the CPU.

The analytic stage is held to the reference on a duck-typed mesh (the
reference's model reads only a mesh's ``shape`` and ``axis_names``): the
same features and buckets, corpus masks bit for bit, the same candidates
in the same order with the same capacities, the same estimates under the
reference's constants, and the same ``measure=False`` decisions, with and
without a chain and an envelope.  The backend names differ by design
(``jnp`` is ``dense`` here; the compacted flavour on the CPU is ``stacks``
on both sides).  The measured stage runs on the port's own mesh of ranks
on the CPU: its decisions must give the reference's ``multiply_reference``
and ``density_matrix`` results on the same inputs, a warm database runs
no trial, and ``plan.clear_cache`` drops every level.
"""
from __future__ import annotations

import importlib
import json

import jax
import numpy as np
import pytest
import torch

from repro import tuner as RT
from repro.core import bsm as RB
from repro.core import engine as RE
from repro.core import envelope as REnv
from repro.core import plan as RP
from repro.core import signiter as RS
from repro.tuner import features as RF
from repro.tuner import model as RM
from repro_torch import interop
from repro_torch import tuner as PT
from repro_torch.core import bsm as B
from repro_torch.core import engine as E
from repro_torch.core import envelope as PEnv
from repro_torch.core import plan as PP
from repro_torch.core import signiter as PS
from repro_torch.kernels import block_spgemm as K
from repro_torch.launch import purify
from repro_torch.launch.mesh import make_spgemm_mesh
from repro_torch.tuner import db as PDB
from repro_torch.tuner import features as PF
from repro_torch.tuner import model as PM

from test_torch_plan_schedule import DuckMesh

# the packages export a ``corpus`` function over their module of that name
RC = importlib.import_module("repro.tuner.corpus")
PC = importlib.import_module("repro_torch.tuner.corpus")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Rank loops run many small operations: with several test workers on
    the machine, torch's intra-op threads would only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_caches():
    RP.clear_cache()
    PP.clear_cache()
    yield
    PP.clear_cache()


def _duck(sizes):
    return DuckMesh(sizes, ("r", "c") if len(sizes) == 2 else ("l", "r", "c"))


def _pair(nb=16, bs=4, occupancy=0.2, seed=0, symmetric=True,
          pattern="decay"):
    """(reference pair, port pair): the reference's random_bsm, carried
    across through numpy.  A symmetric pair is H . H (one matrix)."""
    ra = RB.random_bsm(jax.random.key(seed), nb=nb, bs=bs,
                       occupancy=occupancy, pattern=pattern,
                       symmetric=symmetric)
    rb = ra if symmetric else RB.random_bsm(
        jax.random.key(seed + 1), nb=nb, bs=bs, occupancy=occupancy,
        pattern=pattern)

    def port(m):
        return interop.bsm_from_arrays(np.asarray(m.blocks),
                                       np.asarray(m.mask),
                                       np.asarray(m.norms), device="cpu")

    pa = port(ra)
    return (ra, rb), (pa, pa if symmetric else port(rb))


def _ported(label: str) -> str:
    """A reference label in the port's backend names."""
    return label.replace("/jnp", "/dense")


def _assert_reference_c(c, ra, rb, threshold):
    """C against the reference's single-device oracle on the same
    operands: the mask exactly, the values within 1e-5."""
    want = RE.multiply_reference(ra, rb, threshold=threshold)
    if isinstance(c, B.ShardedBSM):
        c = c.unshard()
    np.testing.assert_array_equal(c.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(c.blocks.numpy(), np.asarray(want.blocks),
                               rtol=1e-5, atol=1e-5)


def _ok(a, b, threshold=0.0):
    from repro.kernels.stacks import pair_cube

    return pair_cube(a.mask, b.mask, a.norms, b.norms, threshold)


# ---- features ----------------------------------------------------------------


@pytest.mark.parametrize("nb,occ,symmetric,pattern", [
    (16, 0.2, True, "decay"), (12, 0.5, False, "random"),
    (8, 1.0, True, "decay"), (16, 0.05, False, "banded"),
])
def test_features_and_buckets_equal_reference(nb, occ, symmetric, pattern):
    (ra, rb), (pa, pb) = _pair(nb=nb, occupancy=occ, symmetric=symmetric,
                               pattern=pattern, seed=nb)
    want = RF.featurize(ra, rb, 0.0)
    got = PF.featurize(pa, pb, 0.0)
    assert got.as_dict() == want.as_dict()
    assert PF.feature_bucket(got) == RF.feature_bucket(want)
    m = np.asarray(ra.mask)
    assert PF.mask_bucket(m, 4, 4) == RF.mask_bucket(m, 4, 4)
    np.testing.assert_array_equal(PF.mask_product(m, m), RF.mask_product(m, m))
    np.testing.assert_array_equal(PF.mask_union([m, m.T]),
                                  RF.mask_union([m, m.T]))


def test_featurize_a_sharded_operand():
    """A ShardedBSM featurizes from its gathered home layout."""
    _, (pa, _) = _pair(nb=8)
    mesh = make_spgemm_mesh(p=2, device="cpu")
    sa = B.shard_bsm(pa, mesh)
    assert PF.featurize(sa, sa) == PF.featurize(pa, pa)


# ---- corpus ------------------------------------------------------------------


@pytest.mark.parametrize("kind", PC.KINDS)
@pytest.mark.parametrize("seed", [0, 7])
def test_corpus_masks_bit_equal(kind, seed):
    """Given a jax key's two data words, the port draws the reference's
    masks bit for bit."""
    key = jax.random.key(seed)
    words = np.asarray(jax.random.key_data(key)).ravel()[:2]
    for nb, occ in ((16, 0.1), (24, 0.3)):
        want = RC.make_mask(kind, nb, key, occupancy=occ, bandwidth=3)
        got = PC.make_mask(kind, nb, words, occupancy=occ, bandwidth=3)
        np.testing.assert_array_equal(got, want)
    want = RC.three_center_mask(6, key, occupancy=0.2)
    np.testing.assert_array_equal(PC.three_center_mask(6, words,
                                                       occupancy=0.2), want)


def test_corpus_entries():
    """Entries build reproducible operands whose masks are ``masks()``;
    three_center builds its matricized (nb^2, nb) tensor operand."""
    entries = PC.corpus(smoke=True)
    assert [e.name for e in entries] == [e.name for e in
                                         RC.corpus(smoke=True)]
    for e in entries:
        ma, mb = e.masks()
        if e.kind == "three_center":
            assert ma.shape == (e.nb * e.nb, e.nb) and mb.shape == (e.nb,) * 2
            t, _ = e.build_tensor(device="cpu")
            assert t.nbs == (e.nb,) * 3 and t.bss == (e.bs,) * 3
        a, b = e.build(device="cpu")
        np.testing.assert_array_equal(a.mask.numpy(), ma)
        np.testing.assert_array_equal(b.mask.numpy(), mb)
        a2, _ = e.build(device="cpu")
        assert torch.equal(a.blocks, a2.blocks)
    z = PC.CorpusEntry("zipf_hub", "zipf", 32, 8, occupancy=0.15, seed=15)
    assert z.imbalance(4, 4) > 2.0
    with pytest.raises(ValueError, match="three_center"):
        PC.CorpusEntry("x", "uniform", 8, 4).build_tensor()


# ---- candidates, estimates, analytic decisions --------------------------------

MESHES = [(2, 2), (2, 4), (3, 3), (2, 2, 2)]
PINS = [
    {},
    dict(engines=("gather", "twofive")),
    dict(backends=("stacks",), transports=("compressed",)),
    dict(assigns=("identity",), l=4),
]


def _port_pins(pins: dict) -> dict:
    return {k: (tuple("dense" if x == "jnp" else x for x in v)
                if k == "backends" else v) for k, v in pins.items()}


@pytest.mark.parametrize("sizes", MESHES)
@pytest.mark.parametrize("pins", PINS)
def test_enumerate_candidates_equal_reference(sizes, pins):
    mesh = _duck(sizes)
    (ra, rb), (pa, pb) = _pair(nb=12, occupancy=0.3, seed=3)
    f = PF.featurize(pa, pb)
    ok = _ok(ra, rb)
    counts = RF.mask_product(ra.mask, rb.mask)
    want = RM.enumerate_candidates(mesh, RF.featurize(ra, rb), ok=ok,
                                   counts=counts, **pins)
    got = PM.enumerate_candidates(mesh, f, ok=ok, counts=counts,
                                  device="cpu", **_port_pins(pins))
    assert [c.label for c in got] == [_ported(c.label) for c in want]
    assert [c.stack_capacity for c in got] == [c.stack_capacity
                                               for c in want]
    # every case exercises something, but a depth pin on a stacked mesh
    # (whose depth is its l axis) leaves nothing on either side
    assert want or (len(sizes) == 3 and "l" in pins)


def test_group_layouts_fan_out_on_cuda_only():
    """The cuda backend ranks the kernel's default group only (smaller
    groups lost on the card); a smaller layout, as a database record may
    carry, is labelled /g<r>x<c> and priced above the default by its
    operand re-reads.  The other backends never carry a layout."""
    import dataclasses

    _, (pa, pb) = _pair(nb=8, bs=23, occupancy=0.3)
    f = PF.featurize(pa, pb)
    ok = E._host_pair_filter(pa, pb, 0.0)
    cands = PM.enumerate_candidates(_duck((2, 2)), f, ok=ok,
                                    engines=("gather",), backends=("cuda",),
                                    transports=("dense",))
    assert [c.tile for c in cands] == K.tile_candidates(23, 23) == [None]
    smaller = [dataclasses.replace(cands[0], tile=g)
               for g in ((2, 2), (1, 1))]
    assert [c.label for c in cands + smaller] == [
        "gather/cuda", "gather/cuda/g2x2", "gather/cuda/g1x1"]
    assert PM.default_backends("cpu") == ("dense", "stacks")
    ests = [PM.estimate_candidate(c, _duck((2, 2)), f)
            for c in cands + smaller]
    assert ests[0].compute_s < ests[1].compute_s < ests[2].compute_s
    dense = PM.enumerate_candidates(_duck((2, 2)), f, ok=ok,
                                    engines=("gather",), backends=("dense",))
    assert all(c.tile is None for c in dense)


def test_ranks_sharing_a_device_are_priced_in_turn():
    """Every rank of a mesh on one device (the card, or here the CPU):
    the summed local work whatever the balance, the copy rate shared by
    the ranks, a compressed panel at its dense bytes plus its packed ones,
    and identity the only assignment left open.  A duck-typed mesh and a
    mesh of distinct devices keep the reference's formulas."""
    import types

    from repro_torch.core import commvolume as CV
    from repro_torch.core.local_mm import local_stage_cost

    _, (pa, _) = _pair(nb=8, occupancy=0.3, seed=3)
    f = PF.featurize(pa, pa)
    ok = E._host_pair_filter(pa, pa, 0.0)
    counts = PF.mask_product(pa.mask.numpy(), pa.mask.numpy())
    mesh = make_spgemm_mesh(p=2, device="cpu")
    assert PM.ranks_per_device(mesh) == 4
    assert PM.ranks_per_device(_duck((2, 2))) == 1
    assert PM.ranks_per_device(types.SimpleNamespace(
        devices=tuple(torch.device("cuda", i) for i in range(4)))) == 1
    cands = PM.enumerate_candidates(mesh, f, ok=ok, counts=counts,
                                    engines=("gather",))
    assert cands and all(c.assign == "identity" for c in cands)
    pinned = PM.enumerate_candidates(mesh, f, ok=ok, counts=counts,
                                     engines=("gather",),
                                     assigns=("nnz_greedy",))
    assert {c.assign for c in pinned} == {"nnz_greedy"}
    assert any(c.assign != "identity" for c in PM.enumerate_candidates(
        _duck((2, 2)), f, ok=ok, counts=counts, engines=("gather",)))

    stacks = next(c for c in cands if c.backend == "stacks")
    lc = local_stage_cost(8, 8, 8, 4, 4, 4, fill=f.product_fill,
                          backend="stacks", dtype=torch.float32,
                          capacity=stacks.stack_capacity)
    for imb in (1.0, 3.0):
        est = PM.estimate_candidate(stacks, mesh, f, imbalance=imb)
        assert _close(est.compute_s, lc.effective / PM.PEAK_FLOPS)
    plan = PP.plan_multiply(mesh, "gather")
    dense_vol = CV.plan_volume(plan, 8, 4, itemsize=4.0).total
    packed_vol = CV.plan_volume(plan, 8, 4, itemsize=4.0,
                                transport="compressed", occ_a=f.occ_a,
                                occ_b=f.occ_b).total
    ticks = plan.ticks * PM.TICK_OVERHEAD_S
    dense = PM.Candidate("gather")
    packed = PM.Candidate("gather", transport="compressed")
    assert _close(PM.estimate_candidate(dense, mesh, f).comm_s,
                  dense_vol / PM.COPY_BW + ticks)  # 4 ranks: as measured
    assert _close(PM.estimate_candidate(packed, mesh, f).comm_s,
                  (dense_vol + packed_vol) / PM.COPY_BW + ticks)
    duck = _duck((2, 2))
    assert PM.estimate_candidate(packed, duck, f).comm_s < \
        PM.estimate_candidate(dense, duck, f).comm_s
    # eight ranks on the device: the copy rate halves
    mesh8 = make_spgemm_mesh(p=2, l=2, device="cpu")
    plan8 = PP.plan_multiply(mesh8, "twofive")
    vol8 = CV.plan_volume(plan8, 8, 4, itemsize=4.0).total
    assert _close(
        PM.estimate_candidate(PM.Candidate("twofive"), mesh8, f).comm_s,
        vol8 * 8 / (PM.COPY_RANKS * PM.COPY_BW)
        + plan8.ticks * PM.TICK_OVERHEAD_S)


@pytest.fixture
def reference_constants(monkeypatch):
    """The port's model priced with the reference's (TPU) constants."""
    from repro import roofline

    monkeypatch.setattr(PM, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(PM, "COPY_BW", roofline.ICI_BW)
    monkeypatch.setattr(PM, "TICK_OVERHEAD_S", RM.TICK_OVERHEAD_S)


def _close(x, y):
    return x == pytest.approx(y, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("sizes", MESHES)
@pytest.mark.parametrize("budget", [None, 3e5])
def test_rank_candidates_equal_reference(sizes, budget,
                                         reference_constants):
    mesh = _duck(sizes)
    (ra, rb), (pa, pb) = _pair(nb=12, occupancy=0.3, seed=5,
                               symmetric=False, pattern="random")
    ok = _ok(ra, rb, 0.05)
    counts = RF.mask_product(ra.mask, rb.mask)
    kw = dict(ok=ok, counts=counts, budget_bytes=budget)
    try:
        want = RM.rank_candidates(mesh, RF.featurize(ra, rb), **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match="memory budget"):
            PM.rank_candidates(mesh, PF.featurize(pa, pb), device="cpu",
                               **kw)
        assert "memory budget" in str(e)
        return
    got = PM.rank_candidates(mesh, PF.featurize(pa, pb), device="cpu", **kw)
    assert [e.candidate.label for e in got.ranked] == [
        _ported(e.candidate.label) for e in want.ranked]
    for g, w in zip(got.ranked + got.pruned, want.ranked + want.pruned):
        assert _close(g.comm_s, w.comm_s) and _close(g.compute_s,
                                                     w.compute_s)
        assert _close(g.mem_bytes, w.mem_bytes)
        assert g.feasible == w.feasible and g.reason == w.reason
    assert [e.candidate.label for e in got.pruned] == [
        _ported(e.candidate.label) for e in want.pruned]
    assert got.n_candidates == len(got.ranked) + len(got.pruned)


def test_model_helpers_equal_reference():
    assert PM.valid_square_depths(6) == RM.valid_square_depths(6)
    mesh = _duck((2, 2))
    assert PM.mesh_signature(mesh) == RM.mesh_signature(mesh)
    m = RC.make_mask("zipf", 16, jax.random.key(1), occupancy=0.2)
    counts = RF.mask_product(m, m)
    assert PM.assignment_imbalances(counts, mesh) == \
        RM.assignment_imbalances(counts, mesh)
    for fill in (0.0, 0.05, 0.3, 1.0):
        want = RM.choose_local_backend(8, 8, 8, 4, 4, 4, fill)
        got = PM.choose_local_backend(8, 8, 8, 4, 4, 4, fill, device="cpu")
        assert got == {"jnp": "dense"}.get(want, want)
    assert PM.chain_safe(PM.Candidate("gather"))
    assert not PM.chain_safe(PM.Candidate("gather", backend="stacks"))
    assert PM.chain_safe(PM.Candidate("gather", transport="compressed"),
                         envelope=True)
    assert PM.device_memory_budget(mesh) == 0.9 * 16e9


def _decision_fields(d, ported: bool):
    backend = d.backend if ported else {"jnp": "dense"}.get(d.backend,
                                                              d.backend)
    return (d.engine, d.l, backend, d.stack_capacity, d.transport, d.assign,
            d.source)


def _envelopes(m: np.ndarray):
    """The same stream envelope on both sides."""
    return REnv.union_envelope([m]), PEnv.union_envelope([m])


@pytest.mark.parametrize("sizes", [(2, 2), (2, 4), (2, 2, 2)])
@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("enveloped", [False, True])
def test_analytic_decisions_equal_reference(sizes, chain, enveloped,
                                            reference_constants):
    mesh = _duck(sizes)
    (ra, _), (pa, _) = _pair(nb=16, occupancy=0.2, seed=2)
    renv = penv = None
    if enveloped:
        renv, penv = _envelopes(np.asarray(ra.mask))
    kw = dict(measure=False, chain=chain, threshold=1e-3)
    want = RT.autotune(ra, ra, mesh, envelope=renv, **kw)
    got = PT.autotune(pa, pa, mesh, envelope=penv, **kw)
    assert _decision_fields(got, True) == _decision_fields(want, False)
    assert got.tile is None
    # pinned parts of the decision stay pinned
    want = RT.autotune(ra, ra, mesh, envelope=renv, engines=("twofive",),
                       assign="identity", **kw)
    got = PT.autotune(pa, pa, mesh, envelope=penv, engines=("twofive",),
                      assign="identity", **kw)
    assert _decision_fields(got, True) == _decision_fields(want, False)


def test_analytic_decision_at_nb16_on_2x2(reference_constants):
    """An anchor decision: the reference's analytic winner at nb 16 on a
    2 x 2 mesh is the compacted gather with compressed panels and the
    nnz-greedy layout; the port reaches it with the reference's
    constants."""
    (ra, _), (pa, _) = _pair(nb=16, occupancy=0.2)
    mesh = _duck((2, 2))
    want = RT.autotune(ra, ra, mesh, measure=False)
    assert want.label == "gather/stacks+ct@nnz[analytic]"
    got = PT.autotune(pa, pa, mesh, measure=False)
    assert got.label == want.label
    s = PP.cache_stats()
    assert (s["tuner_misses"], s["tuner_trials"]) == (1, 0)
    run = PT.last_run()
    assert run.winner == "gather/stacks+ct@nnz" and run.analytic_s >= 0.0


# ---- the database ----------------------------------------------------------


def _key(feats, mesh, constraints=("mult", "*", "*", 0)):
    return PDB.make_key(PF.feature_bucket(feats), PM.mesh_signature(mesh),
                        constraints, feats.dtype)


def test_db_keys_equal_reference(tmp_path):
    (ra, _), (pa, _) = _pair(nb=8)
    mesh = _duck((2, 2))
    rf, pf = RF.featurize(ra, ra), PF.featurize(pa, pa)
    from repro.tuner.db import make_key as ref_key

    for cons in (("mult", "*", "*", 0), ("chain", "gather", "jnp", 4,
                                         "dense", "assign:identity", "env")):
        assert PDB.make_key(PF.feature_bucket(pf), PM.mesh_signature(mesh),
                            cons, pf.dtype) == ref_key(
            RF.feature_bucket(rf), RM.mesh_signature(mesh), cons, rf.dtype)
    assert PT._constraints(("gather",), ("dense",), 4, True, "dense",
                           "identity", True) == RT._constraints(
        ("gather",), ("dense",), 4, True, "dense", "identity", True)
    db = PDB.TuningDB(str(tmp_path / "db.json"))
    db.record("k", {"engine": "gather", "device": "cpu"})
    again = PDB.TuningDB.load(str(tmp_path / "db.json"))
    assert again.lookup("k")["engine"] == "gather"
    assert again.lookup("k", device="cpu") is not None
    assert len(PDB.TuningDB.load_or_create(str(tmp_path / "none.json"))) == 0


def test_db_refuses_other_schemas(tmp_path):
    """A file the reference wrote (its own schema) and an unknown one are
    refused at load."""
    from repro.tuner.db import TuningDB as RefDB

    ref_path = str(tmp_path / "ref.json")
    RefDB(ref_path).record("k", {"engine": "gather"})
    with pytest.raises(ValueError, match="schema"):
        PDB.TuningDB.load(ref_path)
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": "something-else", "records": {}}')
    with pytest.raises(ValueError, match="schema"):
        PDB.TuningDB.load(str(bad))
    assert json.loads(open(ref_path).read())["schema"] != PDB.SCHEMA


def test_db_record_from_another_device_is_a_miss():
    """A record another device measured never answers here."""
    _, (pa, _) = _pair(nb=16)
    mesh = _duck((2, 2))
    f = PF.featurize(pa, pa)
    db = PDB.TuningDB()
    rec = {"engine": "cannon", "l": None, "backend": "dense",
           "device": "cuda:NVIDIA H100 80GB HBM3", "measured_s": 1e-4}
    db.record(_key(f, mesh), rec)
    dec = PT.autotune(pa, pa, mesh, db=db, measure=False)
    assert dec.source == "analytic"
    assert db.lookup(_key(f, mesh), device="cpu") is None
    PP.clear_cache()
    db.record(_key(f, mesh), {**rec, "device": "cpu"})
    dec = PT.autotune(pa, pa, mesh, db=db, measure=False)
    assert dec.source == "db" and dec.engine == "cannon"


def test_db_pre_field_records_warm_hit():
    """Records without the transport / tile / assign fields read as dense,
    the default layout and identity, and still answer measurement-free."""
    _, (pa, _) = _pair(nb=16)
    mesh = _duck((2, 2))
    f = PF.featurize(pa, pa)
    db = PDB.TuningDB()
    db.record(_key(f, mesh), {"engine": "gather", "l": None,
                              "backend": "dense", "device": "cpu",
                              "measured_s": 1e-4})
    dec = PT.autotune(pa, pa, mesh, db=db)
    assert dec.source == "db" and dec.engine == "gather"
    assert (dec.transport, dec.tile, dec.assign) == ("dense", None,
                                                     "identity")
    s = PP.cache_stats()
    assert (s["tuner_hits"], s["tuner_trials"]) == (1, 0)


def test_db_records_revalidated_per_topology():
    """A record is re-run through the enumeration's validity gates: an
    engine or depth the mesh excludes, a compacted backend on an empty
    pattern or of another device are misses; an underivable assignment or
    an invalid group layout drops to identity / the default."""
    (ra, _), (pa, _) = _pair(nb=8, occupancy=0.3)
    f = PF.featurize(pa, pa)
    ok = E._host_pair_filter(pa, pa, 0.0)
    counts = PF.mask_product(pa.mask.numpy(), pa.mask.numpy())
    mesh = _duck((2, 4))
    base = {"engine": "gather", "l": None, "backend": "dense"}
    assert PT._db_candidate({**base, "engine": "cannon"}, ok, mesh, f) is None
    assert PT._db_candidate({**base, "engine": "twofive", "l": 3}, ok, mesh,
                            f) is None
    assert PT._db_candidate({**base, "backend": "stacks"},
                            np.zeros_like(ok), mesh, f) is None
    assert PT._db_candidate({**base, "backend": "cuda"}, ok, mesh, f) is None
    assert PT._db_candidate({**base, "backend": "jnp"}, ok, mesh, f) is None
    assert PT._db_candidate({**base, "transport": "zstd"}, ok, mesh,
                            f) is None
    good = PT._db_candidate(base, ok, mesh, f, counts)
    assert good.engine == "gather" and good.assign == "identity"
    sq = _duck((2, 2))
    cand = PT._db_candidate({**base, "assign": "nnz_greedy"}, ok, sq, f,
                            counts)
    assert cand.assign == "nnz_greedy"
    for bad in ("zigzag", None):
        assert PT._db_candidate({**base, "assign": bad}, ok, sq, f,
                                counts).assign == "identity"
    assert PT._db_candidate({**base, "assign": "nnz_greedy"}, ok, sq, f,
                            None).assign == "identity"
    # the compacted capacity comes from the PERMUTED cube
    from repro_torch.core.distribute import assignment_for, permute_cube

    cand = PT._db_candidate({**base, "backend": "stacks",
                             "assign": "nnz_greedy"}, ok, sq, f, counts)
    asg = assignment_for("nnz_greedy", counts, (2, 2))
    assert cand.stack_capacity == PP.get_device_capacity(
        permute_cube(ok, asg.perm), sq, "gather")
    # group layouts: kept where the kernel takes them, else the default
    cuda = {**base, "backend": "cuda"}
    f23 = PF.PairFeatures(**{**f.as_dict(), "bs_r": 23, "bs_k": 23,
                             "bs_c": 23})
    assert PT._db_tile([2, 2], f23, "cuda") == (2, 2)
    for raw in ([5, 5], [2, 2, 2], "64x64", [0, 1]):
        assert PT._db_tile(raw, f23, "cuda") is None
    assert PT._db_tile([2, 2], f23, "stacks") is None
    assert PT._db_candidate(cuda, ok, sq, f, device="cuda:0") is not None
    kept = PT._db_candidate({**cuda, "tile": [2, 2]}, ok, sq, f23,
                            device="cuda:0")
    assert kept.tile == (2, 2) and kept.label == "gather/cuda/g2x2"
    # end to end: a poisoned record falls through to a fresh decision
    db = PDB.TuningDB()
    db.record(_key(f, mesh), {**base, "engine": "cannon", "device": "cpu"})
    dec = PT.autotune(pa, pa, mesh, db=db, measure=False)
    assert dec.engine != "cannon" and dec.source == "analytic"
    del ra


def test_decision_cache_keys_on_budget():
    _, (pa, _) = _pair(nb=16)
    mesh = _duck((2, 2))
    PT.autotune(pa, pa, mesh, budget_bytes=1e9, measure=False)
    PT.autotune(pa, pa, mesh, budget_bytes=5e5, measure=False)
    s = PP.cache_stats()
    assert (s["tuner_misses"], s["tuner_hits"]) == (2, 0)
    PT.autotune(pa, pa, mesh, budget_bytes=5e5, measure=False)
    assert PP.cache_stats()["tuner_hits"] == 1


# ---- measured decisions on a CPU mesh of ranks --------------------------------


def test_measured_auto_multiply_and_warm_db(tmp_path):
    """Measured ``engine="auto"`` at nb 8 on a 2 x 2 mesh of CPU ranks
    gives the oracle's C; the record carries every mode and the device; a
    warm database runs no trial and answers the same candidate."""
    (ra, rb), (pa, pb) = _pair(nb=8, bs=4, occupancy=0.3, seed=9,
                               symmetric=False, pattern="random")
    mesh = make_spgemm_mesh(p=2, device="cpu")
    path = str(tmp_path / "db.json")
    PT.set_default_db(path)
    c = E.multiply(pa, pb, mesh, engine="auto", threshold=1e-6)
    _assert_reference_c(c, ra, rb, 1e-6)
    want = E.multiply_reference(pa, pb, threshold=1e-6)
    assert torch.equal(c.mask, want.mask)
    torch.testing.assert_close(c.blocks, want.blocks, rtol=1e-5, atol=1e-5)
    s = PP.cache_stats()
    assert s["tuner_misses"] == 1 and 1 <= s["tuner_trials"] <= 3
    run = PT.last_run()
    assert all(not err for _, _, err in run.trials)
    rec = next(iter(PT.get_default_db().records.values()))
    assert rec["device"] == "cpu" and rec["backend"] in ("dense", "stacks")
    for field in ("transport", "tile", "assign", "trials"):
        assert field in rec
    # the same call again: a decision-cache hit, no trial
    E.multiply(pa, pb, mesh, engine="auto", threshold=1e-6)
    s2 = PP.cache_stats()
    assert s2["tuner_hits"] == s["tuner_hits"] + 1
    assert s2["tuner_trials"] == s["tuner_trials"]
    # a new process: clear_cache drops the binding; the file answers
    PP.clear_cache()
    assert PT.get_default_db() is None
    PT.set_default_db(path)
    c2 = E.multiply(pa, pb, mesh, engine="auto", threshold=1e-6)
    s3 = PP.cache_stats()
    assert (s3["tuner_trials"], s3["tuner_misses"], s3["tuner_hits"]) == (
        0, 0, 1)
    _assert_reference_c(c2, ra, rb, 1e-6)


def _card_backends(monkeypatch, kernel):
    """Rank the card's backends on CPU operands, with ``kernel`` in place
    of the block-SpGEMM wrapper the ``cuda`` backend calls."""
    from repro_torch.kernels import ops as kops

    monkeypatch.setattr(PM, "default_backends",
                        lambda device=None: ("dense", "cuda"))
    monkeypatch.setattr(kops, "block_spgemm", kernel)


def test_a_kernel_that_fails_fails_the_decision(monkeypatch):
    """A kernel that fails to build or launch is not a losing candidate:
    the error propagates out of ``autotune``, and nothing is cached or
    recorded, so no later call settles on a candidate without it."""
    def broken(*args, **kwargs):
        raise RuntimeError("nvcc not found")

    _card_backends(monkeypatch, broken)
    _, (pa, _) = _pair(nb=8, occupancy=0.3, seed=6)
    mesh = make_spgemm_mesh(p=2, device="cpu")
    db = PDB.TuningDB()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            PT.autotune(pa, pa, mesh, threshold=1e-6, db=db, top_k=100)
    assert not db.records and not PT._decision_cache
    assert any("/cuda" in label for label in PT.last_run().ranked)


def test_a_candidate_out_of_memory_leaves_the_race(monkeypatch):
    """Running out of memory is the one failure a trial survives (the
    candidate does not fit): kept with its error, another candidate
    wins, and the database records both."""
    def too_big(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory")

    _card_backends(monkeypatch, too_big)
    (ra, _), (pa, _) = _pair(nb=8, occupancy=0.3, seed=6)
    mesh = make_spgemm_mesh(p=2, device="cpu")
    db = PDB.TuningDB()
    dec = PT.autotune(pa, pa, mesh, threshold=1e-6, db=db, top_k=100)
    trials = PT.last_run().trials
    assert dec.backend == "dense" and dec.source == "measured"
    assert any("/cuda" in label and "OutOfMemoryError" in err
               for label, _, err in trials)
    rec = next(iter(db.records.values()))
    assert rec["backend"] == "dense" and any(
        t["error"] for t in rec["trials"])
    c = E.multiply(pa, pa, mesh, engine=dec.engine, backend=dec.backend,
                   l=dec.l, transport=dec.transport, threshold=1e-6)
    _assert_reference_c(c, ra, ra, 1e-6)


def test_auto_on_sharded_operands_pins_identity():
    """Sharded operands: the tuner keeps their layout (identity pinned) and
    C stays sharded, equal to the oracle."""
    (ra, _), (pa, _) = _pair(nb=8, occupancy=0.3, seed=4)
    mesh = make_spgemm_mesh(p=2, device="cpu")
    sa = B.shard_bsm(pa, mesh, assignment="nnz_greedy")
    c = E.multiply(sa, sa, engine="auto", threshold=1e-6, filter_eps=0.0)
    assert isinstance(c, B.ShardedBSM)
    _assert_reference_c(c, ra, ra, 1e-6)
    assert PT.last_run().trials
    assert all("@" not in label for label, _, _ in PT.last_run().trials)


def test_clear_cache_drops_every_level(tmp_path):
    _, (pa, _) = _pair(nb=8, occupancy=0.3, seed=6)
    mesh = make_spgemm_mesh(p=2, device="cpu")
    PT.set_default_db(str(tmp_path / "db.json"))
    E.multiply(pa, pa, mesh, engine="auto", threshold=1e-6)
    PS.sign_iteration(pa, mesh=mesh, engine="onesided", max_iter=2, tol=0.0)
    s = PP.cache_stats()
    assert s["tuner_misses"] == 1 and s["chain_misses"] == 1
    assert PT._decision_cache and PT._bucket_cache and PT._stream_last_bucket
    PP.clear_cache()
    assert all(v == 0 for v in PP.cache_stats().values())
    assert not (PT._decision_cache or PT._bucket_cache
                or PT._stream_last_bucket)
    assert PT.get_default_db() is None and PT.last_run() is None
    E.multiply(pa, pa, mesh, engine="auto", threshold=1e-6)
    assert PP.cache_stats()["tuner_misses"] == 1


def test_drift_between_buckets_counts_a_retune():
    """One decision stream whose pattern moves to another bucket counts
    ``drift_retunes``, as in the reference."""
    _, (pa, _) = _pair(nb=16, occupancy=0.1, seed=1)
    _, (pb, _) = _pair(nb=16, occupancy=0.9, seed=1, pattern="random")
    mesh = _duck((2, 2))
    PT.autotune(pa, pa, mesh, measure=False)
    PT.autotune(pb, pb, mesh, measure=False)
    assert PP.cache_stats()["drift_retunes"] == 1


@pytest.mark.parametrize("sizes", [(2, 2), (2, 2, 2)])
def test_density_matrix_auto_names_its_engine(sizes):
    """``density_matrix(engine="auto")`` on a mesh: one chain decision,
    P equal to the reference's single-device ``density_matrix`` on the
    same H, and to the chain run with the chosen engine named."""
    (rh, _), (h, _) = _pair(nb=8, occupancy=0.3, seed=8)
    kw = dict(threshold=1e-6, filter_eps=1e-6, max_iter=30, tol=1e-5)
    l = 1 if len(sizes) == 2 else sizes[0]
    mesh = make_spgemm_mesh(p=sizes[-1], l=l, device="cpu")
    p, st = PS.density_matrix(h, 0.0, mesh=mesh, engine="auto", **kw)
    assert st.engine in E.ENGINES and st.converged
    want, want_st = RS.density_matrix(rh, 0.0, **kw)
    assert want_st.converged and st.iterations == want_st.iterations
    np.testing.assert_array_equal(p.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(p.to_dense().numpy(),
                               np.asarray(want.to_dense()), rtol=1e-5,
                               atol=1e-5)
    s = PP.cache_stats()
    assert s["tuner_misses"] == 1 and s["tuner_trials"] >= 1
    # a chain without an envelope trials chain-safe candidates only
    assert all("/dense" in label and "+ct" not in label
               for label, _, _ in PT.last_run().trials)
    p2, st2 = PS.density_matrix(h, 0.0, mesh=mesh, engine=st.engine,
                                l=st.l, **kw)
    assert st2.iterations == st.iterations
    assert torch.equal(p.blocks, p2.blocks)


def test_envelope_auto_backend_is_the_tuners():
    """``backend="auto"`` under an envelope: the tuner's analytic
    crossover on the envelope's fill, the device's compacted flavour."""
    _, (h, _) = _pair(nb=8, occupancy=0.3, seed=8)
    mesh = make_spgemm_mesh(p=2, device="cpu")
    kw = dict(threshold=1e-6, filter_eps=1e-6, max_iter=4, tol=0.0)
    x, st = PS.sign_iteration(h, mesh=mesh, envelope="auto", backend="auto",
                              **kw)
    env = PP.get_envelope(B.host_mask(h), B.host_array(h.norms), sweeps=4,
                          threshold=1e-6, filter_eps=1e-6, bs=4)
    want = PM.choose_local_backend(8, 8, 8, 4, 4, 4,
                                   fill=float(env.cube.mean()),
                                   device="cpu")
    y, _ = PS.sign_iteration(h, mesh=mesh, envelope="auto", backend=want,
                             **kw)
    assert st.envelope and torch.equal(x.blocks, y.blocks)


def test_purify_tuning_db_cold_then_warm(tmp_path, capsys):
    """``launch.purify --engine auto --tuning-db``: the cold run measures
    (one decision), the warm run answers from the file with no trial and
    the same engine."""
    path = str(tmp_path / "db.json")
    argv = ["--device", "cpu", "--nb", "8", "--p", "2", "--l", "1",
            "--engine", "auto", "--tuning-db", path, "--repeats", "2"]
    cold = purify.run(argv)
    assert cold["ok"] and cold["tuner"]["tuner_misses"] == 1
    assert 1 <= cold["tuner"]["tuner_trials"] <= 3
    assert cold["engine"] in E.ENGINES
    warm = purify.run(argv)
    assert warm["ok"] and warm["tuner"]["tuner_trials"] == 0
    assert warm["tuner"]["tuner_misses"] == 0
    assert warm["engine"] == cold["engine"]
    out = capsys.readouterr().out
    assert "tuning db: 1 record(s)" in out and "tuner 0h/1m/" in out
