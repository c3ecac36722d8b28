"""Activation-sharding context — the part of ``repro/parallel/ctx.py`` the
MoE layer needs.

Model code stays mesh-agnostic: it calls ``shard_act(x, name)`` at the
canonical cut points and reads ``tp_reduce_dtype()`` for its
tensor-parallel contractions.  Inside ``with sharding_rules(rules):`` the
reference turns each name into a GSPMD sharding constraint; outside, both
are no-ops, which is what a single device sees.  The port runs one process
with no GSPMD, so ``shard_act`` is the identity with no rules installed
and raises with rules installed: resharding activations across devices
comes with ``parallel/sharding.py`` (ROADMAP.md Queue A item 15b, the
sharded training slice).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field

import torch

_STATE = threading.local()

_NO_GSPMD = ("activation resharding (shard_act under sharding rules) needs "
             "parallel/sharding.py, ROADMAP.md Queue A item 15b")


@dataclass(frozen=True)
class ShardingRules:
    """Name -> partition spec table for activation constraints (the specs
    are opaque here), and ``reduce_dtype``: when set, tensor-parallel
    contractions produce their partials in this dtype."""

    table: dict = field(default_factory=dict)
    reduce_dtype: torch.dtype | None = None

    def spec(self, name: str):
        return self.table.get(name)


@contextlib.contextmanager
def sharding_rules(rules: ShardingRules | None):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def current_rules() -> ShardingRules | None:
    return getattr(_STATE, "rules", None)


def shard_act(x: torch.Tensor, name: str) -> torch.Tensor:
    """Constrain activation ``x`` per the active rule set: the identity
    without one (one device, as in the reference); with one, resharding
    is not ported yet and raises."""
    if current_rules() is None:
        return x
    raise NotImplementedError(f"{name}: {_NO_GSPMD}")


def tp_reduce_dtype() -> torch.dtype | None:
    """Output dtype of tensor-parallel contractions (None: the inputs')."""
    rules = current_rules()
    return None if rules is None else rules.reduce_dtype
