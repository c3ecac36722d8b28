"""Parity of the port's serving dispatch cache
(``repro_torch.core.envelope.DispatchCache``) with the reference's, on the
reference's five ``test_dispatch_cache_*`` scenarios: the same masks give
the same buckets, envelopes, capacities and ``plan.cache_stats()``
counters on both sides, and the same decisions up to the backend's name
(the reference's dense path is ``jnp``, the port's ``dense``; its
compacted path on the CPU is ``stacks`` on both sides, and the port names
it ``cuda`` for a CUDA device).
"""
from __future__ import annotations

import numpy as np
import pytest

import repro.tuner as rtuner
from repro.core import envelope as RE
from repro.core import plan as RP
from repro_torch import tuner as ptuner
from repro_torch.core import envelope as PE
from repro_torch.core import plan as PP

COUNTERS = ("dispatch_hits", "dispatch_misses", "drift_retunes")
# the reference's local backend names against the port's (CPU operands)
BACKEND = {"jnp": "dense", "stacks": "stacks"}


def _routing_mask(nb, e, experts):
    m = np.zeros((nb, e), bool)
    for i in range(nb):
        for x in experts:
            m[i, (i + x) % e] = True
    return m


def _stats(mod) -> tuple:
    st = mod.cache_stats()
    return tuple(st[k] for k in COUNTERS)


def _same(got, want) -> None:
    """Envelope and decision of one resolve, port against reference."""
    (genv, gdec), (wenv, wdec) = got, want
    for f in ("mask_a", "mask_b", "cube"):
        np.testing.assert_array_equal(getattr(genv, f), getattr(wenv, f))
    assert gdec["capacity"] == wdec["capacity"]
    assert gdec["source"] == wdec["source"]
    assert gdec["backend"] == BACKEND.get(wdec["backend"], wdec["backend"])


@pytest.fixture(autouse=True)
def _clean():
    RP.clear_cache()
    PP.clear_cache()
    yield
    RP.clear_cache()
    PP.clear_cache()


def _pair(eye, **kw):
    return RE.DispatchCache(eye, **kw), PE.DispatchCache(eye, device="cpu",
                                                         **kw)


def test_dispatch_cache_warm_then_all_hits():
    rng = np.random.default_rng(0)
    eye = np.eye(8, dtype=bool)
    masks = [rng.random((8, 8)) < 0.4 for _ in range(6)]
    ref, port = _pair(eye)
    ref.warm(masks)
    port.warm(masks)
    assert port.stats() == ref.stats()
    for m in masks:
        _same(port.resolve(m), ref.resolve(m))
    assert _stats(PP) == _stats(RP) == (6, 0, 0)
    assert port.stats() == ref.stats()


def test_dispatch_cache_miss_then_widen_then_hit():
    eye = np.eye(8, dtype=bool)
    m1 = _routing_mask(8, 8, (0, 1))
    m2 = _routing_mask(8, 8, (2, 3))
    ref, port = _pair(eye)
    assert port.bucket_of(m1) == ref.bucket_of(m1) == port.bucket_of(m2)
    for m in (m1, m2, m2):
        _same(port.resolve(m), ref.resolve(m))
        assert _stats(PP) == _stats(RP)
    assert _stats(PP) == (1, 1, 1)
    assert port.stats() == ref.stats() and len(port) == 1


def test_dispatch_cache_new_bucket_per_regime():
    eye = np.eye(8, dtype=bool)
    sparse = _routing_mask(8, 8, (0,))
    dense = _routing_mask(8, 8, range(7))
    ref, port = _pair(eye)
    for m in (sparse, dense):
        _same(port.resolve(m), ref.resolve(m))
    assert _stats(PP) == _stats(RP) == (0, 2, 0)
    assert len(port) == len(ref) == 2


def test_dispatch_cache_db_roundtrip_capacity_monotone(tmp_path):
    """A persisted decision warm-starts a relaunch (source "db") only
    while its capacity covers the launch's envelope; both databases hold
    the same capacity at every step."""
    eye = np.eye(8, dtype=bool)
    mask = _routing_mask(8, 8, (1, 4))
    rtuner.set_default_db(str(tmp_path / "ref.json"))
    ptuner.set_default_db(str(tmp_path / "port.json"))
    decs = []
    for _ in range(2):  # launch, then relaunch on the same database
        ref, port = _pair(eye)
        got, want = port.resolve(mask), ref.resolve(mask)
        _same(got, want)
        decs.append(got[1]["source"])
    assert decs == ["analytic", "db"]
    key = port._db_key(port.bucket_of(mask))
    assert key == ref._db_key(ref.bucket_of(mask))
    for db in (rtuner.get_default_db(), ptuner.get_default_db()):
        rec = db.lookup(key)
        db.record(key, dict(rec, capacity=1))  # stale: covers nothing
    ref, port = _pair(eye)
    got, want = port.resolve(mask), ref.resolve(mask)
    _same(got, want)
    assert got[1]["source"] == "analytic"
    assert ptuner.get_default_db().lookup(key)["capacity"] == \
        rtuner.get_default_db().lookup(key)["capacity"] == got[1]["capacity"]


def test_dispatch_cache_decision_fn_override():
    eye = np.eye(8, dtype=bool)
    pin = {"backend": "dense", "capacity": 64, "source": "pinned"}
    ref = RE.DispatchCache(eye, decision_fn=lambda env: dict(
        pin, backend="jnp"))
    port = PE.DispatchCache(eye, decision_fn=lambda env: pin, device="cpu")
    m = _routing_mask(8, 8, (0, 5))
    _same(port.resolve(m), ref.resolve(m))
    assert port.resolve(m)[1] == pin


@pytest.mark.parametrize("nb,e", [(2, 64), (2, 8), (64, 64)])
def test_analytic_decision_names_the_devices_backend(nb, e):
    """The dense / compacted choice and the capacity are the reference's;
    the compacted backend is ``cuda`` for CUDA operands, ``stacks`` on the
    CPU.  On deepseek-moe-16b's decode grid (nb 2, E 64) that is the
    compacted path at capacity 128."""
    full = np.ones((nb, e), bool)
    env = PE.union_envelope([full], [np.eye(e, dtype=bool)])
    renv = RE.union_envelope([full], [np.eye(e, dtype=bool)])
    want = RE._analytic_dispatch_decision(renv, 4, 2048, 1408, "bfloat16")
    cpu = PE._analytic_dispatch_decision(env, 4, 2048, 1408, "bfloat16",
                                         "cpu")
    card = PE._analytic_dispatch_decision(env, 4, 2048, 1408, "bfloat16",
                                          "cuda")
    assert cpu["capacity"] == card["capacity"] == want["capacity"]
    assert cpu["backend"] == BACKEND[want["backend"]]
    assert card["backend"] == ("cuda" if want["backend"] == "stacks"
                               else "dense")
    if (nb, e) == (2, 64):
        assert want["backend"] == "stacks" and want["capacity"] == 128
