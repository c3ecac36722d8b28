"""Shared test fixtures.

NOTE: XLA_FLAGS / device counts are deliberately NOT set here — smoke tests
run on the real single CPU device.  Multi-device tests go through
``tests/_dist.py`` subprocesses which set ``xla_force_host_platform_device_count``
before importing jax (see test_distributed.py).
"""
from __future__ import annotations

import os
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


# ---------------------------------------------------------------------------
# hypothesis fallback: when the real package is missing, install a tiny
# fixed-example substitute so the property tests still collect and run.
# Each strategy exposes a short list of representative examples (its bounds
# plus a midpoint); ``@given`` runs the test once per example tuple, cycling
# shorter example lists — deterministic, no shrinking, no randomness.
# ---------------------------------------------------------------------------

try:  # pragma: no cover - exercised only when hypothesis is installed
    import hypothesis  # noqa: F401
except ImportError:

    class _Strategy:
        def __init__(self, examples):
            self.examples = list(examples)

    def _integers(min_value=0, max_value=100):
        mid = (min_value + max_value) // 2
        return _Strategy(dict.fromkeys([min_value, mid, max_value]))

    def _floats(min_value=0.0, max_value=1.0, **_kw):
        mid = 0.5 * (min_value + max_value)
        return _Strategy(dict.fromkeys([min_value, mid, max_value]))

    def _sampled_from(elements):
        return _Strategy(list(elements))

    def _booleans():
        return _Strategy([False, True])

    def _just(value):
        return _Strategy([value])

    def _given(*_args, **strategies):
        names = list(strategies)
        rounds = max(len(strategies[n].examples) for n in names)

        def deco(fn):
            def wrapper(*a, **kw):
                for i in range(rounds):
                    kw2 = dict(kw)
                    for n in names:
                        ex = strategies[n].examples
                        kw2[n] = ex[i % len(ex)]
                    fn(*a, **kw2)

            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.hypothesis_fallback = True
            return wrapper

        return deco

    def _settings(*_a, **_kw):
        return lambda fn: fn

    def _assume(condition):
        if not condition:
            raise pytest.skip.Exception("hypothesis-fallback assume() false")
        return True

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.assume = _assume
    _hyp.HealthCheck = types.SimpleNamespace(too_slow=None, data_too_large=None)
    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.sampled_from = _sampled_from
    _st.booleans = _booleans
    _st.just = _just
    _st.composite = lambda fn: fn
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; skips without one (run on the card)",
    )
