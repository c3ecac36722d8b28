"""Process-topology logic of the paper (Algorithm 2) — a copy of
``repro/core/topology.py`` (jax-free), kept by the port so it imports
nothing of the reference.

This module reproduces, exactly and testably, the paper's:

* validity rules for the 2.5D depth factor ``L`` (section 3):
    - non-square grid (P_R != P_C): with mn=min, mx=max, require mx % mn == 0
      and mx <= mn^2; then L is *determined*: L = mx/mn, topology mn x mx/L x L.
    - square grid: L any square integer with sqrt(L) dividing P_R,
      topology (P_R/sqrt(L)) x (P_C/sqrt(L)) x L.
* buffer-count model (section 3): PTP needs 4 temporaries, OS1 needs 6,
  non-square OSL needs L+6, square OSL needs L+sqrt(L)+4.
* the one-sided fetch/compute schedule of Algorithm 2 and its 3D coordinates
  (i3D, j3D, l, side3D).

Note on fidelity: the published pseudocode's inline fetch-index expression
``k = (j + ((i*(V div P_R) + l + t)*P_C) div V) mod P_C`` is not
self-consistent for square topologies with L > 1 (the A- and B-panel
contraction indices evaluate at different loop iterations and misalign; the
float was evidently garbled in typesetting).  We therefore derive the
schedule from the paper's *stated invariants*, which pin it down uniquely up
to a skew:

  1. the loop advances in groups of L iterations ("ticks" of V/L total);
  2. within one group a process fetches L_R A panels and L_C B panels and
     performs all L = L_R*L_C pairwise products into its L target C panels
     (this amortization IS the sqrt(L) communication reduction);
  3. a valid product requires a single contraction index k per group;
  4. across the L processes sharing a C panel, the k ranges must partition
     [0, V): process layer l takes the contiguous chunk l*V/L + [0, V/L).

The Cannon-style skew (im + jn) spreads the pulls of a given panel across
source processes within a group (no hot spots), as in the paper.  The
pure-numpy ``simulate_algorithm2`` executes this schedule with real data and
is property-tested against ``A @ B`` for square and non-square grids.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def is_square_int(x: int) -> bool:
    r = math.isqrt(x)
    return r * r == x


@dataclass(frozen=True)
class Topology:
    """Resolved 2.5D topology for a (P_R, P_C) grid and depth L."""

    p_r: int
    p_c: int
    l: int
    l_r: int
    l_c: int
    side3d: int
    v: int  # number of virtual steps, lcm(P_R, P_C)
    nbuffers_a: int
    nbuffers_b: int

    @property
    def square(self) -> bool:
        return self.p_r == self.p_c

    @property
    def ticks(self) -> int:
        """Tick groups per multiplication: V for Cannon/OS1, ~V/L for OSL
        (exact for L | V; otherwise the max over layers of the uneven
        k-partition)."""
        return max(self.layer_groups(l) for l in range(self.l))

    def chunk(self, l: int) -> tuple[int, int]:
        """Layer l's slice of the virtual k-range [0, V): the L co-owners of
        a C panel partition the contraction index range."""
        return (l * self.v) // self.l, ((l + 1) * self.v) // self.l

    def layer_groups(self, l: int) -> int:
        lo, hi = self.chunk(l)
        return hi - lo

    @property
    def total_buffers(self) -> int:
        """Temporary-buffer count (section 3 of the paper)."""
        if self.l == 1:
            return 6  # one-sided L=1
        if not self.square:
            return self.l + 6
        return self.l + math.isqrt(self.l) + 4

    def fetch_counts(self, l: int = 0) -> tuple[int, int]:
        """(A fetches, B fetches) for a layer-l process over one multiply.

        L_R per group for A, L_C per group for B: V/sqrt(L) each on square
        topologies — the Eq. (7) reduction."""
        g = self.layer_groups(l)
        return g * self.l_r, g * self.l_c


def validate_l(p_r: int, p_c: int, l: int) -> bool:
    """Paper's validity rule for L on a (p_r, p_c) grid."""
    if l == 1:
        return True
    if p_r != p_c:
        mn, mx = min(p_r, p_c), max(p_r, p_c)
        return mx % mn == 0 and mx <= mn * mn and l == mx // mn
    return is_square_int(l) and p_r % math.isqrt(l) == 0


def make_topology(p_r: int, p_c: int, l: int) -> Topology:
    """Resolve the 3D topology; falls back to L=1 when invalid (as Alg. 2)."""
    if not validate_l(p_r, p_c, l):
        l = 1
    l_r, l_c = 1, 1
    nbuffers_a = 2
    if l > 1:
        if p_r > p_c:
            l_r = l
        elif p_r < p_c:
            l_c = l
        else:
            l_r = l_c = math.isqrt(l)
            nbuffers_a = max(2, l_r)
    side3d = max(p_r, p_c) // max(l_r, l_c)
    return Topology(
        p_r=p_r,
        p_c=p_c,
        l=l,
        l_r=l_r,
        l_c=l_c,
        side3d=side3d,
        v=lcm(p_r, p_c),
        nbuffers_a=nbuffers_a,
        nbuffers_b=2,
    )


def coords3d(topo: Topology, i: int, j: int) -> tuple[int, int, int]:
    """(i3D, j3D, l) of 2D process (i, j) — Algorithm 2."""
    i3d = i // topo.side3d
    j3d = j // topo.side3d
    l = j3d * topo.l_r + i3d
    return i3d, j3d, l


def group_k(topo: Topology, i: int, j: int, g: int) -> int:
    """Contraction (virtual) index consumed by process (i, j) in group g."""
    _, _, l = coords3d(topo, i, j)
    im, jn = i % topo.side3d, j % topo.side3d
    lo, _ = topo.chunk(l)
    return (im + jn + lo + g) % topo.v


def group_products(topo: Topology, i: int, j: int, g: int):
    """All (m, k, n) panel products performed by (i, j) in tick group g.

    A panels pulled from virtual grid position (m, k) — L_R of them;
    B panels from (k, n) — L_C of them; L pairwise products.
    """
    im, jn = i % topo.side3d, j % topo.side3d
    k = group_k(topo, i, j, g)
    out = []
    for i3 in range(topo.l_r):
        for j3 in range(topo.l_c):
            m = i3 * topo.side3d + im
            n = j3 * topo.side3d + jn
            out.append((m, k, n))
    return out


# ---------------------------------------------------------------------------
# Pure-numpy simulator of Algorithm 2 (fidelity oracle)
# ---------------------------------------------------------------------------


def simulate_algorithm2(
    a: np.ndarray, b: np.ndarray, p_r: int, p_c: int, l: int
) -> np.ndarray:
    """Execute the one-sided 2.5D schedule with real data (numpy).

    Panels stay in their *home* 2D positions (A on the (P_R x V) virtual
    grid, B on (V x P_C), both backed by the unchanged 2D layout — the
    paper's "no 3D redistribution"); every process pulls what it needs and
    partial C panels are accumulated at their owners at the end.
    """
    topo = make_topology(p_r, p_c, l)
    n = a.shape[0]
    if n % topo.v or n % p_r or n % p_c:
        raise ValueError("matrix size must divide grid dims and V")
    hr, hc, hv = n // p_r, n // p_c, n // topo.v

    def a_virtual(m, k):
        return a[m * hr : (m + 1) * hr, k * hv : (k + 1) * hv]

    def b_virtual(k, nn):
        return b[k * hv : (k + 1) * hv, nn * hc : (nn + 1) * hc]

    c = np.zeros((n, b.shape[1]))
    fetches_a = fetches_b = 0
    expect_a = expect_b = 0
    for i in range(p_r):
        for j in range(p_c):
            _, _, l = coords3d(topo, i, j)
            ea, eb = topo.fetch_counts(l)
            expect_a += ea
            expect_b += eb
            for g in range(topo.layer_groups(l)):
                prods = group_products(topo, i, j, g)
                fetches_a += topo.l_r
                fetches_b += topo.l_c
                for m, k, nn in prods:
                    c[m * hr : (m + 1) * hr, nn * hc : (nn + 1) * hc] += (
                        a_virtual(m, k) @ b_virtual(k, nn)
                    )
    assert fetches_a == expect_a
    assert fetches_b == expect_b
    return c
