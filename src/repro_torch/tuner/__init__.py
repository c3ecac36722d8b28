"""Pattern-aware autotuning — the torch twin of ``repro/tuner``.

The decision layer above the plan cache: given a concrete operand pair and
a mesh of ranks, pick ``(engine, L, backend, stack_capacity, transport,
group layout, assignment)`` — the choices the paper shows depend on the
workload (2D or 2.5D, the depth L, the local backend, dense or compressed
panels, the block->rank layout) — instead of every caller naming them.

Decision flow (each stage short-circuits the ones after it):

    features -> decision cache -> tuning DB -> bucket cache -> analytic
    (features.py) (exact pattern)  (db.py)     (same bucket)   prune and
                                                               rank
                                                               (model.py)
                                                               -> trials
                                                               (measure.py)

* the decision cache re-hits the exact pattern (digests of the masks, and
  of the norms under a threshold) on the same device, mesh and
  constraints;
* the persisted ``TuningDB`` re-hits the feature bucket for records the
  same device measured, revalidated for this exact pattern and mesh
  (``_db_candidate``: engine and depth, ``_db_tile``, ``_db_assign``;
  capacities re-derived);
* the bucket cache does the same for a new pattern of a bucket this
  process already resolved; a known decision stream whose bucket changes
  counts ``drift_retunes``;
* the analytic model ranks every feasible candidate, and short timed
  trials of the top ``top_k`` decide.

Each decision copies the operands' masks and norms to the host once; the
filter cube, the features and the mask product come from that copy.
Counters join ``plan.cache_stats()``: ``tuner_hits`` (decisions served
without trials), ``tuner_misses`` (decisions that needed the model),
``tuner_trials`` (candidates timed).  ``plan.clear_cache()`` drops every
level and unbinds the default DB.  ``last_run()`` reports the last
decision that ran the model.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.tuner.corpus import CorpusEntry, corpus, make_mask  # noqa: F401
from repro_torch.tuner.db import TuningDB, device_tag, make_key
from repro_torch.tuner.features import (  # noqa: F401
    PairFeatures,
    dtype_name,
    feature_bucket,
    featurize,
)
from repro_torch.tuner.measure import best_trial, measure_candidates
from repro_torch.tuner.model import (
    _label,
    Candidate,
    ModelReport,
    assignment_space,
    chain_safe,
    choose_local_backend,  # noqa: F401
    default_backends,
    device_memory_budget,
    enumerate_candidates,  # noqa: F401
    estimate_candidate,
    mesh_signature,
    rank_candidates,
)

__all__ = [
    "Decision", "autotune", "resolve_multiply", "set_default_db",
    "get_default_db", "last_run", "TuningDB", "Candidate", "PairFeatures",
    "featurize", "feature_bucket", "rank_candidates", "corpus",
]


@dataclass(frozen=True)
class Decision:
    """A resolved (engine, L, backend, capacity, transport, group layout,
    assignment) choice and where it came from: "cache" | "db" | "bucket"
    | "measured" | "analytic"."""

    engine: str
    l: int | None
    backend: str
    stack_capacity: int | None
    source: str
    measured_s: float | None = None
    transport: str = "dense"  # panel transport mode for this pattern
    tile: tuple[int, int] | None = None  # cuda group layout (None: default)
    assign: str = "identity"  # block->rank assignment mode

    @property
    def label(self) -> str:
        return (_label(self.engine, self.l, self.backend, self.tile,
                       self.transport, self.assign) + f"[{self.source}]")


@dataclass
class TuningRun:
    """What the last model-and-trials decision did: the candidates it
    enumerated and pruned, the analytic stage's host seconds, and every
    trial (label, seconds, error)."""

    candidates: int = 0
    pruned: int = 0
    ranked: tuple = ()
    analytic_s: float = 0.0
    trials: list = field(default_factory=list)
    winner: str = ""


_CACHE_MAXSIZE = 128
_decision_cache: OrderedDict[tuple, Decision] = OrderedDict()
# decisions re-usable while the coarse feature bucket holds, keyed on the
# full DB key, the budget and the device; revalidated like a DB hit
_bucket_cache: OrderedDict[tuple, Decision] = OrderedDict()
# last bucket seen per decision stream (everything but the pattern): a
# known stream changing bucket is drift -> drift_retunes
_stream_last_bucket: OrderedDict[tuple, tuple] = OrderedDict()
_default_db: TuningDB | None = None
_last_run: TuningRun | None = None


def set_default_db(db: TuningDB | str | None) -> TuningDB | None:
    """Bind the process-wide tuning DB (a ``TuningDB`` or a path,
    warm-started when the file exists).  ``None`` unbinds."""
    global _default_db
    _default_db = TuningDB.load_or_create(db) if isinstance(db, str) else db
    return _default_db


def get_default_db() -> TuningDB | None:
    return _default_db


def last_run() -> TuningRun | None:
    """The last decision that ran the analytic model (and its trials)."""
    return _last_run


def _reset() -> None:
    """Drop all tuner state (registered with ``plan.clear_cache``)."""
    global _default_db, _last_run
    _decision_cache.clear()
    _bucket_cache.clear()
    _stream_last_bucket.clear()
    _default_db = None
    _last_run = None


plan_mod.register_cache(_reset)


def _constraints(engines, backends, l, chain: bool,
                 transport: str | None, assign: str | None = None,
                 envelope: bool = False) -> tuple:
    """Constraint part of the decision/DB key, the reference's: the
    transport and assign elements only when the caller pinned a mode, the
    ``env`` marker only under an envelope (envelope decisions never answer
    for exact-pattern ones)."""
    base = (
        "chain" if chain else "mult",
        ",".join(engines) if engines else "*",
        ",".join(backends) if backends else "*",
        0 if l is None else int(l),
    )
    return (base + ((transport,) if transport else ())
            + (("assign:" + assign,) if assign else ())
            + (("env",) if envelope else ()))


def _operand_key(am, an, bm, bn, dtype: str, mesh, constraints: tuple,
                 threshold: float, budget: float, measure: bool, tdb,
                 device: str, extra: bytes | None = None) -> tuple:
    """Decision-cache key from the operand masks and norms (not the
    O(nb^3) filter cube), the device, the budget, the mode and the DB
    binding: a decision made under one of them never answers for another.
    ``extra`` joins the digest (an envelope's signature)."""
    from repro_torch.kernels.stacks import pattern_signature

    h = hashlib.sha1(pattern_signature(am))
    h.update(pattern_signature(bm))
    if threshold > 0.0:  # the filter cube depends on norms too
        h.update(an.tobytes())
        h.update(bn.tobytes())
    if extra is not None:
        h.update(extra)
    return (h.digest(), mesh_signature(mesh), constraints, dtype, device,
            float(threshold), float(budget), bool(measure),
            id(tdb) if tdb is not None else None)


def _capacity_for(cand: Candidate, ok, mesh) -> int | None:
    """Compacted capacities always come from the concrete cube: a DB or
    bucket hit never carries a stale bound."""
    if cand.backend == "dense":
        return None
    return plan_mod.get_device_capacity(ok, mesh, cand.engine)


def _db_candidate(rec: dict, ok, mesh, feats, counts=None,
                  device=None) -> Candidate | None:
    """A DB record as a candidate VALID for this exact (mesh, pattern,
    device), else None (a miss): the same validity gates as
    ``enumerate_candidates``.  ``transport`` (absent: dense), ``tile``
    (``_db_tile``) and ``assign`` (``_db_assign``) are modes; capacities
    are re-derived, from the permuted cube under an assignment."""
    backend = rec.get("backend")
    if backend not in default_backends(device):
        return None  # another device's backend, or schema drift
    cand = Candidate(rec["engine"], rec["l"], backend,
                     transport=rec.get("transport", "dense"),
                     tile=_db_tile(rec.get("tile"), feats, backend),
                     assign=_db_assign(rec.get("assign"), mesh, counts))
    if cand.transport not in ("dense", "compressed"):
        return None  # schema drift: unknown mode is a miss, not a crash
    try:
        plan = plan_mod.plan_multiply(mesh, cand.engine, cand.l)
        plan.validate_blocks(feats.nb_r, feats.nb_c, feats.nb_k)
    except ValueError:
        return None
    if cand.backend == "dense":
        return cand
    ok_m = ok
    if cand.assign != "identity":
        from repro_torch.core.distribute import permute_cube

        asg = assignment_space(counts, mesh,
                               assigns=(cand.assign,)).get(cand.assign)
        ok_m = permute_cube(ok, asg.perm)
    cap = _capacity_for(cand, ok_m, mesh)
    if not cap:
        return None  # empty pattern: the compacted path has no work
    return Candidate(cand.engine, cand.l, cand.backend, cap, cand.transport,
                     cand.tile, cand.assign)


def _db_assign(raw, mesh, counts) -> str:
    """A persisted assignment mode, if derivable on this exact (pattern,
    mesh), else "identity" (records without one read as identity)."""
    if raw in (None, "identity"):
        return "identity"
    try:
        space = assignment_space(counts, mesh, assigns=(str(raw),))
    except (ValueError, TypeError, KeyError):
        return "identity"
    return str(raw) if space.get(str(raw)) is not None else "identity"


def _db_tile(raw, feats, backend: str) -> tuple[int, int] | None:
    """A persisted group layout, if the CUDA kernel takes it for this
    block shape and dtype, else None (the default layout): JSON gives
    lists, and a record may come from another block-shape class."""
    if raw is None or backend != "cuda":
        return None
    from repro_torch.kernels.block_spgemm import validate_tile

    try:
        if len(raw) != 2:
            return None
        return validate_tile(feats.bs_r, feats.bs_c,
                             (int(raw[0]), int(raw[1])),
                             getattr(torch, feats.dtype))
    except (ValueError, TypeError, IndexError, KeyError, AttributeError):
        return None


def _decision(cand: Candidate, source: str,
              measured_s: float | None = None) -> Decision:
    return Decision(
        engine=cand.engine, l=cand.l, backend=cand.backend,
        stack_capacity=cand.stack_capacity, source=source,
        measured_s=measured_s, transport=cand.transport, tile=cand.tile,
        assign=cand.assign,
    )


def autotune(
    a,
    b,
    mesh,
    *,
    threshold: float = 0.0,
    engines: tuple[str, ...] | None = None,
    backend: str | None = None,
    l: int | None = None,
    chain: bool = False,
    top_k: int = 3,
    reps: int = 2,
    budget_bytes: float | None = None,
    db: TuningDB | None = None,
    measure: bool = True,
    transport: str | None = None,
    assign: str | None = None,
    envelope=None,
) -> Decision:
    """Resolve ``(engine, L, backend, stack_capacity, transport, group
    layout, assignment)`` for one operand pair on one mesh.

    ``backend`` / ``l`` / ``engines`` / ``transport`` / ``assign`` pin
    parts of the decision (the tuner chooses only what the caller left
    open); ``assign="identity"`` is what the sharded path pins.
    ``chain=True`` keeps to chain-safe candidates (dense stage, dense
    panels, identity layout), unless ``envelope`` (an
    ``envelope.Envelope``) supplies capacities covering every pattern of
    the chain: then capacities and the ranking's fill come from the
    envelope's union cube and the whole space is ranked.
    ``measure=False`` stops after the analytic ranking (no device work:
    usable on a mesh without devices).  The operands' device sets the
    backends and the device a DB record must name.
    """
    global _last_run
    if mesh is None:
        raise ValueError("autotune requires a mesh (the decision space is "
                         "the distributed engine/depth/backend choice)")
    from repro_torch.core.bsm import host_mask, host_norms
    from repro_torch.core.distribute import product_counts
    from repro_torch.core.engine import _host_pair_filter

    dev = a.device
    tag = device_tag(dev)
    enveloped = envelope is not None
    backends = (backend,) if backend else (
        ("dense",) if chain and not enveloped else None)
    transports = (transport,) if transport else (
        ("dense",) if chain and not enveloped else None)
    assigns = (assign,) if assign else (("identity",) if chain else None)
    constraints = _constraints(engines, backends, l, chain, transport,
                               assign, envelope=enveloped)
    budget = device_memory_budget(mesh) if budget_bytes is None \
        else budget_bytes
    tdb = db if db is not None else _default_db
    dtype = dtype_name(a.dtype)
    am, an = host_mask(a), host_norms(a)
    bm, bn = (am, an) if b is a else (host_mask(b), host_norms(b))
    key = _operand_key(am, an, bm, bn, dtype, mesh, constraints, threshold,
                       budget, measure, tdb, tag,
                       extra=envelope.signature if enveloped else None)

    hit = _decision_cache.get(key)
    if hit is not None:
        plan_mod._stats.tuner_hits += 1
        _decision_cache.move_to_end(key)
        return hit

    feats = featurize(a, b, threshold, masks=(am, bm))
    # every capacity below comes from this cube: the concrete pattern's
    # filter cube, or the envelope's union cube (sound for the stream)
    ok = np.asarray(envelope.cube) if enveloped else _host_pair_filter(
        a, b, threshold, host=(am, an, bm, bn))
    counts = product_counts(envelope.mask_a, envelope.mask_b) if enveloped \
        else product_counts(am, bm)
    db_key = make_key(feature_bucket(feats), mesh_signature(mesh),
                      constraints, feats.dtype)

    # a known decision stream (everything but the pattern) whose bucket
    # changed is drift: whatever level answers, modes are revalidated
    stream = key[1:]
    last = _stream_last_bucket.get(stream)
    if last is not None and last != db_key:
        plan_mod.note_drift_retune()
    _stream_last_bucket[stream] = db_key
    if len(_stream_last_bucket) > _CACHE_MAXSIZE:
        _stream_last_bucket.popitem(last=False)

    bucket_key = (db_key, float(budget), tag)

    def finish(dec: Decision) -> Decision:
        _decision_cache[key] = dec
        if len(_decision_cache) > _CACHE_MAXSIZE:
            _decision_cache.popitem(last=False)
        _bucket_cache[bucket_key] = dec
        _bucket_cache.move_to_end(bucket_key)
        if len(_bucket_cache) > _CACHE_MAXSIZE:
            _bucket_cache.popitem(last=False)
        return dec

    def revalidated(rec: dict) -> Candidate | None:
        cand = _db_candidate(rec, ok, mesh, feats, counts, device=dev)
        if (
            cand is not None
            and estimate_candidate(cand, mesh, feats,
                                   budget_bytes=budget).feasible
            and (not chain or chain_safe(cand, envelope=enveloped))
        ):
            return cand
        return None

    if tdb is not None:
        rec = tdb.lookup(db_key, device=tag)
        if rec is not None:
            cand = revalidated(rec)
            if cand is not None:
                plan_mod._stats.tuner_hits += 1
                return finish(_decision(cand, "db", rec.get("measured_s")))
            # invalid here / stale (budget, constraints): fall through

    bucket_hit = _bucket_cache.get(bucket_key)
    if bucket_hit is not None:
        # a new exact pattern in a bucket this stream already resolved:
        # the remembered modes, revalidated like a DB record
        cand = revalidated({
            "engine": bucket_hit.engine, "l": bucket_hit.l,
            "backend": bucket_hit.backend,
            "transport": bucket_hit.transport,
            "tile": (list(bucket_hit.tile)
                     if bucket_hit.tile is not None else None),
            "assign": bucket_hit.assign,
        })
        if cand is not None:
            plan_mod._stats.tuner_hits += 1
            return finish(_decision(cand, "bucket", bucket_hit.measured_s))

    report = rank_candidates(
        mesh, feats, ok=ok, counts=counts, engines=engines,
        backends=backends, l=l, transports=transports, assigns=assigns,
        budget_bytes=budget, top_k=top_k if measure else 1, device=dev,
    )
    if chain:
        ranked = tuple(e for e in report.ranked
                       if chain_safe(e.candidate, envelope=enveloped))
        if not ranked:
            raise ValueError("no chain-safe candidate survives the prune")
        report = ModelReport(ranked=ranked, pruned=report.pruned,
                             n_candidates=report.n_candidates,
                             host_s=report.host_s)
    run = TuningRun(candidates=report.n_candidates,
                    pruned=len(report.pruned),
                    ranked=tuple(e.candidate.label for e in report.ranked),
                    analytic_s=report.host_s)
    _last_run = run
    plan_mod._stats.tuner_misses += 1

    if not measure:
        best = report.ranked[0].candidate
        run.winner = best.label
        return finish(_decision(best, "analytic"))

    trials = measure_candidates(
        a, b, mesh, [e.candidate for e in report.ranked],
        threshold=threshold, reps=reps,
    )
    plan_mod._stats.tuner_trials += len(trials)
    run.trials = [(t.candidate.label, t.seconds, t.error) for t in trials]
    win = best_trial(trials)
    cand = win.candidate
    run.winner = cand.label
    if tdb is not None:
        tdb.record(db_key, {
            "engine": cand.engine, "l": cand.l, "backend": cand.backend,
            "transport": cand.transport,
            "tile": list(cand.tile) if cand.tile is not None else None,
            "assign": cand.assign,
            "device": tag,
            "measured_s": win.seconds,
            "trials": [
                {"label": t.candidate.label, "seconds": t.seconds,
                 "error": t.error}
                for t in trials
            ],
        })
    return finish(_decision(cand, "measured", win.seconds))


def resolve_multiply(a, b, mesh, **kw) -> tuple[str, dict]:
    """``engine="auto"`` for ``engine.multiply`` and ``plan.execute`` /
    ``plan.execute_sharded``: the concrete engine, and the caller's
    keyword arguments (``threshold``, ``backend``, ``l``,
    ``stack_capacity``, ``tile``, ``transport``, ``assignment`` and, for
    ``engine.multiply``, ``envelope``) with the tuner's choices filled in
    where the caller left them open, ready to pass on with ``**kw``.  The
    caller's explicit choices are constraints; ``envelope``, if given, is
    the decision's.  Sharded operands keep the layout ``shard_bsm`` gave
    them: the decision pins identity and ``assignment`` stays the
    caller's."""
    from repro_torch.core.bsm import ShardedBSM
    from repro_torch.core.engine import _assign_pin, _transport_pin

    kw = dict(kw)
    backend = kw.get("backend")
    tr = kw.get("transport")
    asg_spec = kw.get("assignment")
    sharded = isinstance(a, ShardedBSM)
    dec = autotune(
        a, b, mesh,
        threshold=kw.get("threshold", 0.0),
        backend=None if backend in (None, "auto") else backend,
        l=kw.get("l"),
        transport=_transport_pin(tr),
        assign="identity" if sharded else _assign_pin(asg_spec),
        envelope=kw.get("envelope"),
    )
    kw["backend"] = dec.backend
    kw["l"] = dec.l
    if kw.get("stack_capacity") is None:
        kw["stack_capacity"] = dec.stack_capacity
    if kw.get("tile") is None:
        kw["tile"] = dec.tile
    if tr is None or tr == "auto":
        # the tuner's measured mode; capacities are derived from the
        # concrete pattern in plan.resolve_transport
        kw["transport"] = dec.transport
    if asg_spec is None and not sharded:
        # the tuner's layout; the permutation is re-derived by
        # plan.resolve_assignment
        kw["assignment"] = dec.assign
    return dec.engine, kw
