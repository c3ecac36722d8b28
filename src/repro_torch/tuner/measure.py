"""Measured trials: the tuner's ground truth — the torch twin of
``repro/tuner/measure.py``.

The analytic model ranks; short timed trials decide.  Every trial runs
through the ordinary ``engine.multiply`` path, so what it fills (product
lists, transports, assignments in the plan layer's caches) is what the
application's own multiply reuses.

Timing discipline, as in the reference: one untimed warm-up call per
candidate (it fills the caches and, on a card, builds the kernel), then
``reps`` interleaved rounds — each round times every candidate once — and
the minimum per candidate.  Each timed call blocks on the full output
triple: ``torch.cuda.synchronize`` on every CUDA device of the mesh's
ranks, not only the first, before the clock stops.

A candidate that runs out of memory is kept with its error and leaves
the race, as the reference keeps a failing candidate: it does not fit.
Any other error propagates — a kernel that fails to build or launch
fails the decision, which is then neither cached nor recorded, rather
than let a candidate without the kernel win.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.tuner.model import Candidate

# the one failure a trial survives: the candidate does not fit
_DOES_NOT_FIT = (torch.OutOfMemoryError, MemoryError)


@dataclass(frozen=True)
class Trial:
    candidate: Candidate
    seconds: float  # min over interleaved timed rounds of one multiply
    error: str = ""  # non-empty when the trial ran out of memory

    @property
    def ok(self) -> bool:
        return not self.error


def measure_candidates(
    a,
    b,
    mesh,
    candidates,
    *,
    threshold: float = 0.0,
    reps: int = 2,
) -> list[Trial]:
    """Time one multiply per candidate through ``engine.multiply``.

    Operands may be replicated ``BlockSparseMatrix`` (the mesh passed
    through, the trial run under the candidate's assignment) or
    ``ShardedBSM`` (already on the mesh, in their own layout — the trial
    times exactly the path the application runs)."""
    from repro_torch.core.bsm import ShardedBSM
    from repro_torch.core.engine import multiply

    sharded = isinstance(a, ShardedBSM)
    cuda = [d for d in dict.fromkeys(mesh.devices) if d.type == "cuda"]

    def make_run(c):
        def run():
            return multiply(
                a, b, None if sharded else mesh,
                engine=c.engine, threshold=threshold, backend=c.backend,
                l=c.l, stack_capacity=c.stack_capacity, tile=c.tile,
                transport=c.transport,
                assignment=None if sharded else c.assign,
            )

        return run

    def wait(out):
        # the full output triple, on every rank's device
        del out
        for d in cuda:
            torch.cuda.synchronize(d)

    runners: dict[int, object] = {}
    best: dict[int, float] = {}
    errors: dict[int, str] = {}
    for i, cand in enumerate(candidates):
        run = make_run(cand)
        try:
            wait(run())  # warm-up: caches, kernel build
            runners[i] = run
            best[i] = float("inf")
        except _DOES_NOT_FIT as e:
            errors[i] = repr(e)
    for _ in range(reps):  # interleaved rounds (see the module docstring)
        for i, run in list(runners.items()):
            try:
                wait(None)
                t0 = time.perf_counter()
                wait(run())
                best[i] = min(best[i], time.perf_counter() - t0)
            except _DOES_NOT_FIT as e:
                errors[i] = repr(e)
                del runners[i]  # a failed candidate is out of the race
                del best[i]
    return [
        Trial(candidate=cand, seconds=best.get(i, float("inf")),
              error=errors.get(i, ""))
        for i, cand in enumerate(candidates)
    ]


def best_trial(trials) -> Trial:
    ok = [t for t in trials if t.ok]
    if not ok:
        raise ValueError(
            "every measured candidate failed: "
            + "; ".join(f"{t.candidate.label}: {t.error}" for t in trials)
        )
    return min(ok, key=lambda t: t.seconds)
