"""Activation-sharding context — the twin of ``repro/parallel/ctx.py``.

Model code stays mesh-agnostic: it calls ``shard_act(x, name)`` at the
canonical cut points and reads ``tp_reduce_dtype()`` for its
tensor-parallel contractions.  Inside ``with sharding_rules(rules):`` the
reference turns each name into a GSPMD sharding constraint; outside, both
are no-ops, which is what a single device sees.

The port has no GSPMD: a sharded activation is a list of per-rank tensors,
and the sharded decoder (``parallel/runtime.py``) reads the table of the
installed rules (``parallel/sharding.activation_rules``) at the
reference's cut points and runs the collectives each entry implies
(``parallel/collectives.py``).  So ``shard_act`` on one plain tensor stays
the identity without rules and raises under installed rules: one tensor
cannot be resharded, and a silent no-op would hide a path that skipped
the runtime.  ``tp_reduce_dtype`` gives the rules' ``reduce_dtype`` (bf16
partials of the tensor-parallel products under ``bf16_reduce``).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field

import torch

_STATE = threading.local()

_NO_GSPMD = ("one tensor cannot be resharded under sharding rules: sharded "
             "activations are per-rank lists, laid out by parallel/runtime.py "
             "for the dense family (the MoE family's sharded step, whose "
             "layers cut here, is ROADMAP.md Queue A item 15c; the other "
             "families' 15d-15g)")


@dataclass(frozen=True)
class ShardingRules:
    """Name -> partition spec table for activation constraints
    (``sharding.P`` specs, which ``parallel/runtime.py`` reads), and
    ``reduce_dtype``: when set, tensor-parallel contractions produce their
    partials in this dtype."""

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
    without one (one device, as in the reference); with one, a plain
    tensor raises (the runtime lays out per-rank lists itself)."""
    if current_rules() is None:
        return x
    raise NotImplementedError(f"{name}: {_NO_GSPMD}")


def tp_reduce_dtype() -> torch.dtype | None:
    """Output dtype of tensor-parallel contractions (None: the inputs')."""
    rules = current_rules()
    return None if rules is None else rules.reduce_dtype
