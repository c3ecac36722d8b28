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
             "(whose MoE layers run these cut points themselves, on every "
             "rank's buffer)")


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


def wider(dt: torch.dtype, than: torch.dtype) -> bool:
    return torch.finfo(dt).bits > torch.finfo(than).bits


_OUT_DTYPE: dict = {}  # device type -> whether mm / bmm take out_dtype


def _wide_out(t: torch.Tensor) -> bool:
    """Whether a product of ``t`` can write a wider output itself
    (``out_dtype``, on CUDA and ``meta`` tensors where this PyTorch has
    it; the inputs stay as they are, no cast copy of a weight);
    elsewhere the inputs are cast."""
    kind = t.device.type
    if kind not in ("cuda", "meta") or type(t) is not torch.Tensor:
        return False
    if kind not in _OUT_DTYPE:
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes():  # no trace sees the probe
            a = torch.zeros((2, 2), dtype=t.dtype, device=t.device)
            try:
                torch.mm(a, a, out_dtype=torch.float32)
                torch.bmm(a[None], a[None], out_dtype=torch.float32)
                _OUT_DTYPE[kind] = True
            except (RuntimeError, TypeError, NotImplementedError):
                _OUT_DTYPE[kind] = False
    return _OUT_DTYPE[kind]


def tp_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a tensor-parallel contraction, its output in the
    rules' reduce dtype (the reference's ``preferred_element_type``):
    computed in it where it is wider than the inputs' (f32 partials of a
    bf16 model, rounded once after their sum), else computed in the
    inputs' dtype and cast."""
    dt = tp_reduce_dtype()
    if dt is None:
        return x @ w
    if not wider(dt, x.dtype):
        return (x @ w).to(dt)
    if _wide_out(x):
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=dt)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.to(dt) @ w.to(dt)


def tp_bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...ecf,efd->...ecd", x, w)``, the experts' down
    projection, its output in the reduce dtype as ``tp_matmul``'s."""
    dt = tp_reduce_dtype()
    if dt is None:
        return torch.einsum("...ecf,efd->...ecd", x, w)
    if not wider(dt, x.dtype):  # the product in f32, then cast
        return torch.einsum("...ecf,efd->...ecd", x.float(),
                            w.float()).to(dt)
    if not _wide_out(x):
        return torch.einsum("...ecf,efd->...ecd", x.to(dt), w.to(dt))
    lead, (e, c, f) = x.shape[:-3], x.shape[-3:]
    xb = x.reshape(-1, e, c, f).transpose(0, 1).reshape(e, -1, f)
    y = torch.bmm(xb, w, out_dtype=dt)  # (e, rows x c, d)
    return y.reshape(e, -1, c, w.shape[-1]).transpose(0, 1).reshape(
        *lead, e, c, w.shape[-1])
