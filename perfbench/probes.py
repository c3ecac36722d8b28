"""Records of the inputs the program's layers saw in the traced window, for
the work counts: a probe wraps one function of the program (looked up by
module and name at call time), passes every call through unchanged, and
keeps what the counts need while the window's profiler runs.  Probes are
installed only in traced runs; the timed runs call the program bare.
"""
from __future__ import annotations

import contextlib
import importlib


@contextlib.contextmanager
def probe(module: str, name: str, record, window):
    """Wrap ``module.name``: ``record(result, *args, **kwargs)`` after each
    call made while ``window`` is active."""
    mod = importlib.import_module(module)
    orig = getattr(mod, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        if window.active:
            record(out, *args, **kwargs)
        return out

    setattr(mod, name, wrapped)
    try:
        yield
    finally:
        setattr(mod, name, orig)
