"""2.5D communication-reducing SpGEMM engine (the paper's OSL, Algorithm 2)
— the twin of ``repro/core/twofive.py``.

Two bodies over rank lists, both executors of a ``MultiplyPlan``:

``pull_body``    — Algorithm 2 on the 2D (r, c) grid with the depth axis
    virtual, as in the paper: the 2D layout of A, B, C is kept, every rank
    pulls the panels of ``group_products`` from their home ranks (each
    one-sided rget a static partial permutation of the plan), performs
    its L pairwise products per tick group, and the L-1 partial-C panels
    go to their owners at the end.  Non-square grids (forced L = mx/mn),
    L = 1 (= OS1, the ``onesided`` engine) and square grids with a square L.

``stacked_body`` — the mesh formulation on an (l, r, c) mesh: A and B
    replicated over ``l``; layer l runs a Cannon schedule over its k-chunk
    ``Topology.chunk(l)`` and the partial C panels are summed over ``l``
    (psum, or psum-scatter for ``c_layout="scatter"``).  Uneven chunks (L
    does not divide the grid side): a rank runs only the ticks of its
    layer's chunk (the reference masks the products past it; the rank-list
    form knows each rank's layer statically and skips them).

As in the reference, tick group g+1's pulls are issued before group g's
products, and the stacked ring is double-buffered like Cannon's.

Per-rank volume under dense transport: the pull body moves Eq. (7), (V /
sqrt(L)) (S_A + S_B) panel pulls plus (L-1) S_C partial sends; the stacked
body (s/L)(S_A + S_B) panels plus the reduction over ``l``
(``commvolume.plan_volume``).  Under compressed transport every A / B
panel travels packed (``transport.ingest`` / ``dense_view``); the partial
C panels are accumulator state and stay dense.
"""
from __future__ import annotations

import torch

from repro_torch.core import transport as T
from repro_torch.core.bsm import BlockSparseMatrix
from repro_torch.core.cannon import local_stage, ring_ticks, zero_fill


def _accumulate(pan, state):
    """Add a received (blocks, mask) state to a slot's panel lists."""
    if pan is None:
        return state
    (pb, pm), (rb, rm) = pan, state
    return [x + y for x, y in zip(pb, rb)], [x | y for x, y in zip(pm, rm)]


def pull_body(
    plan,
    *,
    threshold: float = 0.0,
    backend: str = "dense",
    stack_capacity: int | None = None,
    transport: T.PanelTransport = T.DENSE,
    tile: tuple[int, int] | None = None,
):
    """The Algorithm-2 pull body over rank lists (shards in, C shards
    out)."""
    mm_kw = dict(threshold=threshold, backend=backend,
                 stack_capacity=stack_capacity, tile=tile)
    topo = plan.topo
    l_r, l_c, depth, s = topo.l_r, topo.l_c, topo.l, topo.side3d
    mesh, axes, tr = plan.mesh, plan.axes, transport
    n = mesh.size
    # each rank's own layer == its own panel slot, a static value per rank
    # (the reference reads it from lax.axis_index)
    lay = [(j // s) * l_r + (i // s) for i, j in map(mesh.coords, range(n))]

    def body(ab, am, an, bb, bm, bn):
        del an, bn  # norms are not pulled (recomputed per received panel)
        wa = ab[0].shape[1] // plan.ca  # A subpanel width (block cols)
        wb = bb[0].shape[0] // plan.cb  # B subpanel height (block rows)
        ar, bc = ab[0].shape[0], bb[0].shape[1]
        adt, bdt = ab[0].dtype, bb[0].dtype

        def pull_group(g):
            """Issue every one-sided pull of tick group ``g``: the summed
            (blocks, mask) lists per slot (a round delivers zeros to the
            ranks it does not address)."""
            a_pan, b_pan = [None] * l_r, [None] * l_c
            for rd in plan.a_pulls[g]:
                sl = slice(rd.q * wa, (rd.q + 1) * wa)
                st = T.ingest(tr, tr.cap_a, [x[:, sl] for x in ab],
                              [x[:, sl] for x in am])
                got = T.dense_view(tr, T.permute(mesh, st, axes, rd.pairs),
                                   ar, wa, dtype=adt)
                a_pan[rd.slot] = _accumulate(a_pan[rd.slot], got)
            for rd in plan.b_pulls[g]:
                sl = slice(rd.q * wb, (rd.q + 1) * wb)
                st = T.ingest(tr, tr.cap_b, [x[sl] for x in bb],
                              [x[sl] for x in bm])
                got = T.dense_view(tr, T.permute(mesh, st, axes, rd.pairs),
                                   wb, bc, dtype=bdt)
                b_pan[rd.slot] = _accumulate(b_pan[rd.slot], got)
            return a_pan, b_pan

        # partial C per target panel slot t = j3 * L_R + i3
        c_acc = [None] * depth
        cur = pull_group(0)
        for g in range(plan.ticks):
            nxt = pull_group(g + 1) if g + 1 < plan.ticks else None
            a_pan, b_pan = cur
            active = [r for r in range(n)
                      if g < topo.layer_groups(lay[r])]
            # ---- the L pairwise panel products of this group -----------
            for i3 in range(l_r):
                for j3 in range(l_c):
                    t = j3 * l_r + i3
                    c_acc[t] = local_stage(a_pan[i3], b_pan[j3], c_acc[t],
                                           ranks=active, **mm_kw)
            cur = nxt
        c_acc = [zero_fill(*(acc or ([None] * n, [None] * n)), ab, bb)
                 for acc in c_acc]
        if depth == 1:
            return c_acc[0]

        # ---- the L-1 partial-C sends to the panel owners ---------------
        total_b = [c_acc[lay[r]][0][r] for r in range(n)]
        total_m = [c_acc[lay[r]][1][r] for r in range(n)]
        for d, perm in enumerate(plan.c_rounds, start=1):
            send = [c_acc[(lay[r] + d) % depth] for r in range(n)]
            rb, rm = T.permute(mesh, ([c[0][r] for r, c in enumerate(send)],
                                      [c[1][r] for r, c in enumerate(send)]),
                               axes, perm)
            total_b = [x + y for x, y in zip(total_b, rb)]
            total_m = [x | y for x, y in zip(total_m, rm)]
        return total_b, total_m

    return body


def stacked_body(
    plan,
    *,
    threshold: float = 0.0,
    backend: str = "dense",
    c_layout: str = "2d",
    stack_capacity: int | None = None,
    transport: T.PanelTransport = T.DENSE,
    tile: tuple[int, int] | None = None,
):
    """The (l, r, c)-mesh 2.5D body over rank lists.

    c_layout:
      "2d"      — C summed over l (psum), every layer holding the (r, c)
                  shard: the paper's layout, so chained multiplies compose.
      "scatter" — C reduce-scattered over l along block rows (r-major,
                  l-minor): distributed over all ranks, (L-1)/L instead of
                  2(L-1)/L reduction traffic.
    """
    if c_layout not in ("2d", "scatter"):
        raise ValueError(f"unknown c_layout {c_layout!r}")
    mm_kw = dict(threshold=threshold, backend=backend,
                 stack_capacity=stack_capacity, tile=tile)
    mesh, tr = plan.mesh, transport
    n = mesh.size
    l_axis = mesh.axis_names.index("l")
    my_groups = [plan.layer_groups[mesh.coords(r)[l_axis]] for r in range(n)]

    def body(ab, am, an, bb, bm, bn):
        del an, bn  # norms never ride the ring (recomputed at compute time)
        adt, bdt = ab[0].dtype, bb[0].dtype
        sa, sb = am[0].shape, bm[0].shape
        acc = None

        def compute(pa, pb, t):
            nonlocal acc
            # only the ticks of each rank's k-chunk (uneven L)
            acc = local_stage(T.dense_view(tr, pa, *sa, dtype=adt),
                              T.dense_view(tr, pb, *sb, dtype=bdt), acc,
                              ranks=[r for r in range(n) if t < my_groups[r]],
                              **mm_kw)

        # pre-shift with per-layer chunk offset: A_ij <- A_{i, j+i+start_l},
        # B_ij <- B_{i+j+start_l, j}; one static flattened permutation
        pa = T.permute(mesh, T.ingest(tr, tr.cap_a, ab, am), plan.axes,
                       plan.pre_a)
        pb = T.permute(mesh, T.ingest(tr, tr.cap_b, bb, bm), plan.axes,
                       plan.pre_b)
        ring_ticks(plan, pa, pb, compute)
        cb, cm = zero_fill(*acc, ab, bb)

        # --- partial-C reduction over the depth axis (the L-1 sends)
        cmi = [m.to(torch.int32) for m in cm]
        if c_layout == "2d":
            return (T.psum(mesh, cb, "l"),
                    [m > 0 for m in T.psum(mesh, cmi, "l")])
        return (T.psum_scatter(mesh, cb, "l", dim=0),
                [m > 0 for m in T.psum_scatter(mesh, cmi, "l", dim=0)])

    return body


def multiply_25d(
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    mesh,
    *,
    threshold: float = 0.0,
    backend: str = "dense",
    c_layout: str = "2d",
) -> BlockSparseMatrix:
    """Distributed C = A . B with the 2.5D engine: the stacked body on an
    (l, r, c) mesh, the pull body on a 2D one."""
    from repro_torch.core import plan as plan_mod

    return plan_mod.execute(a, b, mesh, "twofive", threshold=threshold,
                            backend=backend, c_layout=c_layout)
