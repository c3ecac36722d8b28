"""Spans at the port's layer boundaries, for whoever profiles it.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler runs in this process, and one shared no-op context otherwise: no
flag, no environment variable.  Spans then sit on the profiler's clock,
the one the device kernels are stamped on, so a trace can put each kernel
down to the span that launched it.  Names start with ``repro.``.  A span
changes no computation.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler runs, else a
    shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
