"""Communication-volume and memory model of the paper (Eq. (6), (7)) — a
copy of ``repro/core/commvolume.py`` (jax-free), kept by the port so it
imports nothing of the reference.

All quantities are *per process*, per multiplication, in units of the panel
sizes ``s_a``, ``s_b``, ``s_c`` (bytes or elements — caller's choice).

Paper Eq. (7): total requested data per process

    (V / sqrt(L)) * (S_A + S_B)   +   (L - 1) * S_C

giving O(1/sqrt(P*L)) scaling for the communicated volume, while the memory
footprint grows by O(L) (Eq. (6)).

In the port, ``plan_volume`` of the resolved transport (dense, or
compressed with its capacities) is what the byte counter of
``core/transport.py`` is held to: every collective of an engine adds its
per-rank bytes under the conventions below, and the sum over one multiply
equals the plan's volume.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.topology import Topology, make_topology


@dataclass(frozen=True)
class VolumeReport:
    engine: str
    p_r: int
    p_c: int
    l: int
    ticks: int
    ab_volume: float  # A+B panel traffic per process
    c_volume: float  # partial-C reduction traffic per process
    total: float


def ptp_volume(topo: Topology, s_a: float, s_b: float) -> VolumeReport:
    """Cannon + point-to-point (Algorithm 1): V shifts of A and B panels,
    plus the pre-shift (2 extra panel transfers)."""
    v = topo.v
    ab = v * (s_a + s_b) + (s_a + s_b)  # ticks + pre-shift
    return VolumeReport("ptp", topo.p_r, topo.p_c, 1, v, ab, 0.0, ab)


def osl_volume(topo: Topology, s_a: float, s_b: float, s_c: float) -> VolumeReport:
    """One-sided 2.5D (Algorithm 2), paper Eq. (7). L=1 gives OS1 (no
    pre-shift, same tick volume as PTP)."""
    v, l = topo.v, topo.l
    ab = (v / math.sqrt(l)) * (s_a + s_b)
    c = (l - 1) * s_c
    return VolumeReport(
        f"os{l}", topo.p_r, topo.p_c, l, v // l, ab, c, ab + c
    )


def memory_factor(topo: Topology, s_a: float, s_b: float, s_c: float) -> float:
    """Eq. (6): temporary-buffer memory growth of OSL relative to OS1."""
    l = topo.l
    if l == 1:
        return 1.0
    base = s_c / (3.0 * (s_a + s_b)) * l
    if topo.square:
        return base + (math.isqrt(l) + 4.0) / 6.0
    return base + 1.0


def volume_ratio_os1_over_osl(
    topo: Topology, s_a: float, s_b: float, s_c: float
) -> float:
    """Figure 3 of the paper: OS1 volume / OSL volume (>1 == OSL wins)."""
    os1 = osl_volume(make_topology(topo.p_r, topo.p_c, 1), s_a, s_b, s_c)
    osl = osl_volume(topo, s_a, s_b, s_c)
    return os1.total / osl.total


def scaling_per_process(p: int, l: int, n_elems: float) -> float:
    """O(1/sqrt(P*L)) communicated-volume scaling law (for plots): the
    communicated A+B volume per process for an n x n matrix on P processes
    re-factored with depth L (square topology)."""
    return 2.0 * n_elems / math.sqrt(p * l)


def _panel_bytes(rows: int, cols: int, bs: int, itemsize: float,
                 bs2: int | None = None) -> float:
    """Wire bytes of one (rows x cols)-block panel as the engines move it
    under dense transport: blocks (itemsize) + occupation mask (1 byte).
    Norms never ride the wire any more — they are recomputed from the
    received blocks (``transport.panel_norms``).  ``bs2`` (default ``bs``)
    is the second atomic-block dim of a rectangular-block panel."""
    return rows * cols * (bs * (bs if bs2 is None else bs2) * itemsize + 1.0)


def _packed_bytes(entries: float, bs: int, itemsize: float,
                  bs2: int | None = None) -> float:
    """Wire bytes of one compressed panel: ``entries`` packed blocks plus
    the one-based int32 index array (``transport.pack_panel``)."""
    return entries * (bs * (bs if bs2 is None else bs2) * itemsize + 4.0)


# bytes per element of the reduced wire formats (numpy has no bfloat16 or
# float8 dtype to ask)
_WIRE_ITEMSIZE = {"bfloat16": 2.0, "float8_e4m3fn": 1.0}


def _transport_spec(
    transport,
) -> tuple[str, float | None, float | None, float | None]:
    """Normalize a transport argument for the volume model: mode plus
    exact per-panel capacities when available (a resolved
    ``PanelTransport``), or None capacities for the occupancy-scaled
    analytic flavor (mode given as the string "compressed").  The fourth
    element is the wire itemsize a non-native wire format pins (None =
    charge the caller's storage ``itemsize``) — index and mask overheads
    always stay at their own fixed widths."""
    if transport is None or transport == "dense":
        return "dense", None, None, None
    if transport == "compressed":
        return "compressed", None, None, None
    if getattr(transport, "mode", None) in ("dense", "compressed"):
        wire = getattr(transport, "wire", "native")
        w = None if wire == "native" else _WIRE_ITEMSIZE[wire]
        if transport.mode == "dense":
            return "dense", None, None, w
        return ("compressed", float(transport.cap_a),
                float(transport.cap_b), w)
    raise ValueError(f"unknown transport spec {transport!r}")


def plan_volume(
    plan,
    nb: int,
    bs: int,
    *,
    itemsize: float = 4.0,
    c_layout: str = "2d",
    transport=None,
    occ_a: float = 1.0,
    occ_b: float = 1.0,
    nb_k: int | None = None,
    nb_c: int | None = None,
    bs_k: int | None = None,
    bs_c: int | None = None,
) -> VolumeReport:
    """Predicted per-device collective wire bytes of one multiplication
    executed from ``plan`` — the paper's volume model evaluated on the
    *actual compiled schedule*, valid for non-square grids too.

    Sparsity-aware: under compressed transport each A/B hop ships packed
    blocks + indices instead of the dense panel, so the Eq. (7) A/B term
    scales with panel occupancy.  ``transport`` may be a resolved
    ``transport.PanelTransport`` (exact bucketed capacities — what
    ``benchmarks/measure_comm.py`` asserts against the compiled HLO) or
    the string ``"compressed"`` with ``occ_a``/``occ_b`` (the tuner's
    analytic flavor: entries ~= occupancy x panel blocks, no bucketing).

    Mirrors the accounting conventions of ``roofline.hlo_cost.analyze_hlo``
    so ``benchmarks/measure_comm.py`` can compare measured vs. modeled:
    collective-permute costs its full payload; all-gather (n-1)/n of the
    gathered output; all-reduce 2(n-1)/n; reduce-scatter (n-1) x output.

    ``nb_k``/``nb_c``/``bs_k``/``bs_c`` (default: square) price a
    rectangular matricized product: A panels are (nb x nb_k) grids of
    bs x bs_k blocks, B (nb_k x nb_c) of bs_k x bs_c, C (nb x nb_c) of
    bs x bs_c.  Square callers' numbers are unchanged.
    """
    topo = plan.topo
    p_r, p_c, depth = plan.p_r, plan.p_c, topo.l
    nb_k = nb if nb_k is None else nb_k
    nb_c = nb if nb_c is None else nb_c
    bs_k = bs if bs_k is None else bs_k
    bs_c = bs if bs_c is None else bs_c
    ar, ac = nb // p_r, nb_k // p_c  # A home shard (block rows, cols)
    br, bc = nb_k // p_r, nb_c // p_c  # B home shard
    cr, cc = nb // p_r, nb_c // p_c  # C home shard
    mode, cap_a, cap_b, wire_item = _transport_spec(transport)
    # A/B panel payloads travel at the WIRE width (bf16 wire on f32
    # storage halves them; bf16 storage halves them natively via the
    # caller's itemsize); partial-C traffic is accumulator state and
    # always moves at storage width.
    ab_item = itemsize if wire_item is None else wire_item

    def hop_a(rows: int, cols: int) -> float:
        if mode == "compressed":
            n = cap_a if cap_a is not None else occ_a * rows * cols
            return _packed_bytes(n, bs, ab_item, bs_k)
        return _panel_bytes(rows, cols, bs, ab_item, bs_k)

    def hop_b(rows: int, cols: int) -> float:
        if mode == "compressed":
            n = cap_b if cap_b is not None else occ_b * rows * cols
            return _packed_bytes(n, bs_k, ab_item, bs_c)
        return _panel_bytes(rows, cols, bs_k, ab_item, bs_c)

    if plan.kind == "pull":
        wa = ac // plan.ca  # A subpanel block-cols (= nb_k / V)
        wb = br // plan.cb  # B subpanel block-rows
        ab = 0.0
        for g in range(plan.ticks):
            ab += len(plan.a_pulls[g]) * hop_a(ar, wa)
            ab += len(plan.b_pulls[g]) * hop_b(wb, bc)
        # L-1 partial-C sends: blocks + mask (always dense — the partial
        # panels are accumulator state, not home panels with known bounds)
        c = len(plan.c_rounds) * (cr * cc * bs * bs_c * itemsize + cr * cc)
        name = f"pull-os{depth}"
    elif plan.kind == "ring":
        # pre-shift + (ticks - 1) double-buffered hops of A and B
        ab = plan.ticks * (hop_a(ar, ac) + hop_b(br, bc))
        c = 0.0
        name = "ring-ptp"
    elif plan.kind == "gather":
        if mode == "compressed":
            # untiled all-gather of each shard's packed buffer + indices:
            # (p-1)/p of the gathered (p, capacity, ...) output
            na = cap_a if cap_a is not None else occ_a * ar * ac
            nb_e = cap_b if cap_b is not None else occ_b * br * bc
            ga = (p_c - 1) * _packed_bytes(na, bs, ab_item, bs_k)
            gb = (p_r - 1) * _packed_bytes(nb_e, bs_k, ab_item, bs_c)
        else:
            ga = _panel_bytes(ar, nb_k, bs, ab_item, bs_k) * (p_c - 1) / p_c
            gb = _panel_bytes(nb_k, bc, bs_k, ab_item, bs_c) * (p_r - 1) / p_r
        ab, c = ga + gb, 0.0
        name = "gather"
    elif plan.kind == "stacked":
        ab = plan.ticks * (hop_a(ar, ac) + hop_b(br, bc))
        cb = cr * cc * bs * bs_c * itemsize + cr * cc * 4.0  # blocks + i32 mask
        if c_layout == "2d":
            c = 2.0 * cb * (depth - 1) / depth  # all-reduce over l
        else:
            c = (depth - 1) * cb / depth  # reduce-scatter: (n-1) x output
        name = f"stacked-l{depth}"
    else:
        raise ValueError(plan.kind)
    if mode == "compressed":
        name += "+ct"
    return VolumeReport(
        name, p_r, p_c, depth, plan.ticks, ab, c, ab + c
    )


def device_memory_bytes(
    plan,
    nb: int,
    bs: int,
    *,
    itemsize: float = 4.0,
    c_layout: str = "2d",
    stack_capacity: int = 0,
    nb_k: int | None = None,
    nb_c: int | None = None,
    bs_k: int | None = None,
    bs_c: int | None = None,
) -> float:
    """Eq. (6) rendered in bytes: per-device memory footprint of one
    multiplication executed from ``plan``.

    Three terms, mirroring the paper's accounting:

    * the home shards of A, B and C (the O(1) baseline);
    * temporary panel buffers, counted with the paper's §3 buffer model
      (``Topology.total_buffers``: 4 for PTP, 6 for OS1, L+6 / L+sqrt(L)+4
      for OSL — the O(L) growth of Eq. (6)) at the panel granularity the
      plan actually moves, PLUS the extra in-flight panel generation the
      double-buffered pipelining keeps (three generations per operand on
      the ring engines, one prefetched tick group for the pull
      formulation — DESIGN.md §3), plus the L-1 partial-C accumulators
      of the pull formulation; the gather plan instead stages the full
      gathered row/column panels;
    * the compacted-backend stack arrays when ``stack_capacity`` > 0:
      gathered A/B operands, the product buffer (f32) and the seven
      int32 index arrays of ``kernels.stacks.ProductStacks``.

    The tuner prunes every candidate whose footprint exceeds the
    per-device budget — the one decision the measured trials must never
    be allowed to make (an OOM trial is not a data point).

    Panel temporaries are counted at their dense size regardless of
    transport: compressed buffers are strictly smaller (packed blocks +
    indices, unpacked transiently for the GEMM), so the dense accounting
    stays a sound upper bound for the prune.

    ``nb_k``/``nb_c``/``bs_k``/``bs_c`` (default: square) account a
    rectangular matricized product; square callers' numbers are unchanged.
    """
    topo = plan.topo
    nb_k = nb if nb_k is None else nb_k
    nb_c = nb if nb_c is None else nb_c
    bs_k = bs if bs_k is None else bs_k
    bs_c = bs if bs_c is None else bs_c
    ar, ac = nb // plan.p_r, nb_k // plan.p_c
    br, bc = nb_k // plan.p_r, nb_c // plan.p_c
    cr, cc = nb // plan.p_r, nb_c // plan.p_c
    shard_a = _panel_bytes(ar, ac, bs, itemsize, bs_k)
    shard_b = _panel_bytes(br, bc, bs_k, itemsize, bs_c)
    shard_c = _panel_bytes(cr, cc, bs, itemsize, bs_c)
    total = shard_a + shard_b + shard_c  # A, B, C home shards
    if plan.kind == "ring":
        # pipelined ring: three panel generations per operand in flight
        # (current / next / prefetched hop — cannon.ring_body)
        total += 3.0 * (shard_a + shard_b)
    elif plan.kind == "gather":
        # gathered A row panel / B col panel
        total += _panel_bytes(ar, nb_k, bs, itemsize, bs_k)
        total += _panel_bytes(nb_k, bc, bs_k, itemsize, bs_c)
    elif plan.kind == "pull":
        sub = max(
            _panel_bytes(ar, ac // plan.ca, bs, itemsize, bs_k),  # A subpanel
            _panel_bytes(br // plan.cb, bc, bs_k, itemsize, bs_c),  # B subpanel
        )
        total += topo.total_buffers * sub
        # the prefetched next tick group's panel set (pull pipelining)
        total += (topo.l_r + topo.l_c) * sub
        total += (topo.l - 1) * shard_c  # partial C panels of the L targets
    elif plan.kind == "stacked":
        # pipelined ring panels: three generations per operand
        total += 3.0 * (shard_a + shard_b)
        # reduction buffer over the depth axis
        total += shard_c if c_layout == "2d" else shard_c / topo.l
    else:
        raise ValueError(plan.kind)
    if stack_capacity > 0:
        # gathered a, b + f32 product per entry
        gemm = (bs * bs_k + bs_k * bs_c + bs * bs_c) * 4.0
        total += stack_capacity * (gemm + 7 * 4.0)
    return total


def device_product_loads(
    counts: np.ndarray, p_r: int, p_c: int, perm=None
) -> np.ndarray:
    """Per-device product load over a (p_r, p_c) grid: the mask-product
    ``counts`` (A_mask @ B_mask as integers — surviving block products per
    C block) summed over each device's (row panel, col panel).  ``perm``
    optionally views the grid under a symmetric block assignment
    (``core.distribute``) without materializing the permuted matrices.
    """
    counts = np.asarray(counts, np.int64)
    if perm is not None:
        p = np.asarray(perm)
        counts = counts[p][:, p]
    nb_r, nb_c = counts.shape
    if nb_r % p_r or nb_c % p_c:
        raise ValueError(
            f"block grid {nb_r}x{nb_c} does not divide mesh {p_r}x{p_c}"
        )
    return counts.reshape(
        p_r, nb_r // p_r, p_c, nb_c // p_c
    ).sum(axis=(1, 3))


def load_imbalance(
    counts: np.ndarray, p_r: int, p_c: int, perm=None
) -> float:
    """Max/mean per-device product load (1.0 = perfectly balanced).  The
    slowest device gates every tick barrier, so compacted local compute —
    priced at mean load by ``local_mm.local_stage_cost`` — stretches by
    exactly this factor; the tuner's model multiplies it in
    (``tuner/model.py``) and the scheduler's job is to drive it back
    toward 1 by choosing an assignment."""
    loads = device_product_loads(counts, p_r, p_c, perm=perm)
    mean = float(loads.mean())
    if mean <= 0.0:
        return 1.0
    return float(loads.max()) / mean


def mesh25d_volume(
    s: int, l: int, s_a: float, s_b: float, s_c: float
) -> VolumeReport:
    """Volume model for the *mesh formulation* used by the JAX engine
    (`repro.core.twofive`): an (L, s, s) device mesh where every layer runs
    s/L Cannon ticks over its k-slice and partial C is reduce-scattered over
    the L axis.  Panel sizes here are the (N/s)^2-block panels.

    Equivalent asymptotics to Eq. (7): AB volume = (s/L)(S_A+S_B) panels =
    2 N^2 / (s L) elements = O(1/sqrt(P L)) with P = L s^2.
    """
    ticks = s // l
    ab = (ticks - 1 + 1) * (s_a + s_b) + (s_a + s_b)  # ticks + pre-shift
    c = (l - 1) / l * s_c  # reduce-scatter bytes over the depth axis
    return VolumeReport(f"mesh25d-l{l}", s, s, l, ticks, ab, c, ab + c)
