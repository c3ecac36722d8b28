"""Cannon's algorithm (the paper's PTP baseline, Algorithm 1) as an
executor of a ``MultiplyPlan`` — the twin of ``repro/core/cannon.py``.

* pre-shift A row-wise by i, B column-wise by j (one static permutation
  over the flattened (r, c) ranks, from the plan),
* V = p ticks of C += A_comp . B_comp, each followed by a ring shift of A
  (left along c) and B (up along r); the last tick does not shift.

The body runs over rank lists (``launch/mesh.py``): every collective moves
one list per operand (``core/transport.py``), and every rank's local stage
runs in turn on its own device.  As in the reference, the hop feeding tick
t+1 is issued before the products of tick t; on one card the copies and
the kernels share one stream, so they do not overlap.

The one-sided OS1 engine (``onesided``) is the L = 1 case of the pull
executor in ``core/twofive.py``.  Both communicate V (S_A + S_B) per rank
under dense transport (PTP adds the pre-shift): Table 2's PTP == OS1.
Under compressed transport each hop carries a packed panel
(``transport.ingest``) and each tick unpacks what it received
(``transport.dense_view``).
"""
from __future__ import annotations

import torch

from repro_torch.core import transport as T
from repro_torch.core.bsm import BlockSparseMatrix
from repro_torch.core.local_mm import local_filtered_mm


def local_stage(pa, pb, acc=None, *, threshold: float, ranks=None,
                **mm_kw):
    """C += A . B on every rank of ``ranks`` (default all) in turn: the
    filtered local multiply of each rank's (blocks, mask) panels, norms
    recomputed from the received blocks.  ``acc`` is the (cb, cm) lists
    to add to; a rank whose entry is None (or every rank, for
    ``acc=None``) takes this product as its C.  Returns the new (cb, cm)
    lists; ranks left out keep theirs."""
    (xb, xm), (yb, ym) = pa, pb
    n = len(xb)
    cb, cm = ([None] * n, [None] * n) if acc is None else map(list, acc)
    for r in range(n) if ranks is None else ranks:
        dcb, dcm = local_filtered_mm(
            xb[r], xm[r], T.panel_norms(xb[r], threshold),
            yb[r], ym[r], T.panel_norms(yb[r], threshold),
            threshold=threshold, **mm_kw,
        )
        if cb[r] is None:
            cb[r], cm[r] = dcb, dcm
        else:
            cb[r] = cb[r] + dcb
            cm[r] = cm[r] | dcm
    return cb, cm


def zero_fill(cb, cm, ab, bb) -> tuple[list, list]:
    """Zero C shards (blocks, mask; ``transport.zeros``, no memory) for the
    ranks of ``cb`` still None: those that computed no product."""
    cb, cm = list(cb), list(cm)
    for r, (a, b) in enumerate(zip(ab, bb)):
        if cb[r] is None:
            shape = (a.shape[0], b.shape[1])
            cb[r] = T.zeros(shape + (a.shape[2], b.shape[3]), a.dtype,
                            a.device)
            cm[r] = T.zeros(shape, torch.bool, a.device)
    return cb, cm


def ring_ticks(plan, pa, pb, compute):
    """The double-buffered ring of the ring and stacked plans: ``compute(
    pa, pb, t)`` per tick, the hop for tick t+1 in flight before tick t's
    products, no trailing shift.  ``pa`` / ``pb`` are pre-shifted panel
    states; one permute per operand per tick after the first."""
    mesh, ticks = plan.mesh, plan.ticks
    if ticks == 1:
        compute(pa, pb, 0)
        return
    na = T.permute(mesh, pa, "c", plan.shift_a)
    nb_ = T.permute(mesh, pb, "r", plan.shift_b)
    for t in range(ticks - 2):
        fa = T.permute(mesh, na, "c", plan.shift_a)
        fb = T.permute(mesh, nb_, "r", plan.shift_b)
        compute(pa, pb, t)
        pa, pb, na, nb_ = na, nb_, fa, fb
    # last two ticks: compute only (paper: no shift when itick == nticks)
    compute(pa, pb, ticks - 2)
    compute(na, nb_, ticks - 1)


def ring_body(
    plan,
    *,
    threshold: float = 0.0,
    backend: str = "dense",
    stack_capacity: int | None = None,
    transport: T.PanelTransport = T.DENSE,
    tile: tuple[int, int] | None = None,
):
    """The PTP Cannon body over rank lists (shards in, C shards out)."""
    mm_kw = dict(threshold=threshold, backend=backend,
                 stack_capacity=stack_capacity, tile=tile)
    mesh, tr = plan.mesh, transport

    def body(ab, am, an, bb, bm, bn):
        del an, bn  # norms never ride the ring (recomputed at compute time)
        adt, bdt = ab[0].dtype, bb[0].dtype
        sa, sb = am[0].shape, bm[0].shape
        acc = None

        def compute(pa, pb, t):
            nonlocal acc
            acc = local_stage(T.dense_view(tr, pa, *sa, dtype=adt),
                              T.dense_view(tr, pb, *sb, dtype=bdt), acc,
                              **mm_kw)

        # pre-shift (Algorithm 1): A_ij <- A_{i,(j+i)}, B_ij <- B_{(i+j),j}
        pa = T.permute(mesh, T.ingest(tr, tr.cap_a, ab, am), plan.axes,
                       plan.pre_a)
        pb = T.permute(mesh, T.ingest(tr, tr.cap_b, bb, bm), plan.axes,
                       plan.pre_b)
        ring_ticks(plan, pa, pb, compute)
        return acc

    return body


def ring_executor(plan, **kw):
    """The PTP Cannon engine as a function of two replicated operands
    (shard, body, gather): the counterpart of the reference's shard_map
    executor."""
    from repro_torch.core import plan as plan_mod

    body = ring_body(plan, **kw)
    return lambda a, b: plan_mod.run_body(plan, body, a, b)


def multiply_2d(
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    mesh,
    *,
    engine: str = "cannon",
    threshold: float = 0.0,
    backend: str = "dense",
) -> BlockSparseMatrix:
    """Distributed C = A . B on a 2D (r, c) mesh (``cannon`` or
    ``onesided``)."""
    from repro_torch.core import plan as plan_mod

    return plan_mod.execute(a, b, mesh, engine, threshold=threshold,
                            backend=backend)
