"""GPipe-style pipeline schedule over a mesh axis — the twin of
``repro/parallel/pipeline.py`` on a mesh of ranks.

The schedule is the classic fill/drain microbatch stream:

    T = n_micro + n_stages - 1 ticks; at tick t, stage s computes
    microbatch t - s (when in range); activations hop stage -> stage + 1
    by one permute per tick.

As in the reference every stage computes at every tick (the fill and
drain bubbles run on zeros or a repeated microbatch and are discarded),
the last stage banks microbatch t - (n_stages - 1), and a psum over the
stage axis broadcasts the banked outputs.  Bubble fraction
(n_stages - 1) / T.
"""
from __future__ import annotations

import torch

from repro_torch.core import transport as TR


def pipeline(mesh, stage_fn, stage_params, xs, *, axis: str = "pod") -> list:
    """Run ``stage_fn(params, x)`` as a pipeline over ``axis``.

    ``stage_params[r]``: rank r's stage parameters (its stage is its
    coordinate on ``axis``); ``xs[r]``: the (n_micro, ...) microbatch
    stream (replicated over ``axis``).  Returns each rank's (n_micro, ...)
    outputs, the last stage's broadcast to every stage."""
    n_stages = mesh.shape[axis]
    ai = mesh.axis_names.index(axis)
    stage = [mesh.coords(r)[ai] for r in range(mesh.size)]
    n_micro = xs[0].shape[0]
    t_total = n_micro + n_stages - 1
    fwd = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    ys = [stage_fn(stage_params[r], xs[r][0]) for r in range(mesh.size)]
    outs = [torch.zeros((n_micro,) + tuple(y.shape), dtype=y.dtype,
                        device=y.device) for y in ys]
    recv = [torch.zeros_like(y) for y in ys]
    for t in range(t_total):
        mb = t - (n_stages - 1)
        ys = []
        for r in range(mesh.size):
            x = xs[r][min(t, n_micro - 1)] if stage[r] == 0 else recv[r]
            y = stage_fn(stage_params[r], x.to(xs[r].dtype))
            if stage[r] == n_stages - 1 and 0 <= mb < n_micro:
                outs[r][mb] = y
            ys.append(y)
        (recv,) = TR.permute(mesh, (ys,), axis, fwd)
    # broadcast the last stage's banked outputs to every stage
    outs = [o if stage[r] == n_stages - 1 else torch.zeros_like(o)
            for r, o in enumerate(outs)]
    return TR.psum(mesh, outs, axis)


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    b = x.shape[0]
    assert b % n_micro == 0, (b, n_micro)
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
