"""Plan layer — the torch twin of ``repro/core/plan.py``: the schedule
layer of the distributed engines and the pattern and chain caches.

A ``MultiplyPlan`` compiles a ``core.topology.Topology`` (the paper's
Algorithm 2 coordinates) into the static communication schedule an engine
body executes over a mesh of ranks: pre-shift permutations, per-tick ring
shifts or one-sided pulls, per-layer k-chunks, and the partial-C
reduction.  Plan kinds, as in the reference:

``ring``     Cannon / PTP (Algorithm 1): pre-shift + V ring shifts, square
             2D meshes.
``pull``     Algorithm 2 on the 2D (r, c) grid with a virtual depth
             (non-square grids with forced L = mx/mn, and L = 1 = OS1):
             every one-sided rget is a static partial permutation.
``stacked``  The (l, r, c) mesh formulation: A/B replicated over ``l``,
             layer l runs Cannon over its k-chunk, partial C summed over
             ``l`` (uneven chunks by per-layer tick masks).
``gather``   Fused all-gather pull-from-home (OS1), any grid.

``build_shard_body`` returns an engine's body over rank lists, and
``execute`` / ``execute_sharded`` run one multiply from replicated or
sharded operands.

The resolution layer, LRU-cached on pattern signatures and counted in
``cache_stats()`` as in the reference:

* ``get_transport`` / ``resolve_transport`` — the panel transport of one
  (pattern pair, mesh, engine): sound bucketed packing capacities from the
  concrete masks and the ``auto`` crossover (``transport_*`` counters).
* ``get_assignment`` / ``resolve_assignment`` — the block->rank
  assignment (``core/distribute.py``; ``assign_*``).  Every capacity is
  derived from the PERMUTED pattern (``_permuted_mask_views``).
* ``get_device_capacity`` — the per-rank product-list bound of a cube.
* ``get_envelope`` — the forecast pattern envelope of a purification
  chain (``core/envelope.py``; ``envelope_*``), ``note_drift_retune``
  for a pattern that escaped its envelope (``drift_retunes``), and
  ``note_dispatch_lookup`` for the serving dispatch cache's bucket
  lookups (``dispatch_hits`` / ``dispatch_misses``).

``get_product_stacks`` caches compacted product lists per sparsity-pattern
signature, so a repeated pattern skips compaction; ``get_chain_program``
caches the fused sign-iteration sweep per key.  The reference's
jit-program cache (``get_compiled``) has no twin: PyTorch runs eagerly.

``engine="auto"`` in ``execute`` / ``execute_sharded`` resolves through
the tuner (``repro_torch.tuner.resolve_multiply``), whose decision caches
join ``clear_cache`` through ``register_cache`` and whose counters
(``tuner_hits`` / ``tuner_misses`` / ``tuner_trials``) join
``cache_stats()``.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import asdict, dataclass
from functools import lru_cache

import numpy as np

from repro_torch.core.topology import (
    Topology,
    coords3d,
    group_k,
    make_topology,
)
from repro_torch.kernels.stacks import (
    bucket_capacity,
    compact_pair_mask,
    pattern_signature,
    product_count,
)


@dataclass
class CacheStats:
    pattern_hits: int = 0  # compacted product-list reuse (same signature)
    pattern_misses: int = 0
    chain_hits: int = 0  # fused sweep reuse (sign iteration)
    chain_misses: int = 0
    evictions: int = 0
    transport_hits: int = 0  # panel-transport resolutions served from cache
    transport_misses: int = 0  # resolutions that derived capacities
    transport_dense: int = 0  # fresh resolutions that chose dense panels
    transport_compressed: int = 0  # ... that chose compressed panels
    assign_hits: int = 0  # block-assignment resolutions served from cache
    assign_misses: int = 0  # resolutions that derived a permutation
    envelope_hits: int = 0  # chain-envelope forecasts served from cache
    envelope_misses: int = 0  # forecasts that ran the symbolic propagation
    drift_retunes: int = 0  # patterns that escaped their envelope
    tuner_hits: int = 0  # engine="auto" decisions served without trials
    tuner_misses: int = 0  # decisions that needed the analytic rank / trials
    tuner_trials: int = 0  # candidates the tuner actually timed
    dispatch_hits: int = 0  # serving-dispatch bucket lookups served warm
    dispatch_misses: int = 0  # ... that warmed a new bucket


_CACHE_MAXSIZE = 128
# a product list of a full 512^3 cube holds 3.8 GB of index arrays, so the
# pattern cache is bounded by bytes as well as by entries
_PATTERN_CACHE_MAX_BYTES = 4 * 2**30
_pattern_cache: OrderedDict[bytes, tuple] = OrderedDict()
_chain_cache: OrderedDict[tuple, object] = OrderedDict()
_bound_cache: OrderedDict[tuple, int] = OrderedDict()
_transport_cache: OrderedDict[tuple, object] = OrderedDict()
_assign_cache: OrderedDict[tuple, object] = OrderedDict()
_envelope_cache: OrderedDict[tuple, object] = OrderedDict()
_stats = CacheStats()
# clear functions of the layers above (the tuner's decision caches)
_extra_caches: list = []


def register_cache(clear_fn) -> None:
    """Have ``clear_cache()`` also call ``clear_fn`` (a layer above the
    plan, such as the tuner, registers its own state here)."""
    if clear_fn not in _extra_caches:
        _extra_caches.append(clear_fn)


def cache_stats() -> dict:
    """Pattern / chain / resolution / tuner cache counters."""
    return asdict(_stats)


def clear_cache() -> None:
    """Drop every plan-layer cache and every registered one, and zero
    every counter."""
    global _stats
    for cache in (_pattern_cache, _chain_cache, _bound_cache,
                  _transport_cache, _assign_cache, _envelope_cache):
        cache.clear()
    plan_multiply.cache_clear()
    for fn in _extra_caches:
        fn()
    _stats = CacheStats()


def _lru(cache: OrderedDict, key, hit: str, miss: str, make):
    """``cache[key]``, made by ``make()`` on a miss; counts ``hit`` /
    ``miss`` in the stats and evicts the oldest entry past the bound."""
    val = cache.get(key)
    if val is not None:
        setattr(_stats, hit, getattr(_stats, hit) + 1)
        cache.move_to_end(key)
        return val
    setattr(_stats, miss, getattr(_stats, miss) + 1)
    val = make()
    cache[key] = val
    if len(cache) > _CACHE_MAXSIZE:
        cache.popitem(last=False)
        _stats.evictions += 1
    return val


def _stacks_bytes(entry) -> int:
    stacks, _n = entry
    return sum(t.numel() * t.element_size() for t in stacks)


def get_product_stacks(pair_ok):
    """Compacted product list of a (ni, nk, nj) filter cube.

    Returns ``(stacks, n_products)``: a ``ProductStacks`` on the cube's
    device, padded to the power-of-two bucket of the surviving count and
    LRU-cached on the pattern signature.  A repeated pattern is a cache
    hit: no compaction.
    """
    sig = pattern_signature(pair_ok)
    hit = _pattern_cache.get(sig)
    if hit is not None:
        _stats.pattern_hits += 1
        _pattern_cache.move_to_end(sig)
        return hit
    _stats.pattern_misses += 1
    n = product_count(pair_ok)
    entry = (compact_pair_mask(pair_ok, capacity=bucket_capacity(n)), n)
    _pattern_cache[sig] = entry
    while len(_pattern_cache) > 1 and (
        len(_pattern_cache) > _CACHE_MAXSIZE
        or sum(map(_stacks_bytes, _pattern_cache.values()))
        > _PATTERN_CACHE_MAX_BYTES
    ):
        _pattern_cache.popitem(last=False)
        _stats.evictions += 1
    return entry


def get_chain_program(key: tuple, make_program):
    """Fused chain-step program (a whole sign-iteration sweep), cached per
    key and counted by ``chain_hits`` / ``chain_misses``."""
    return _lru(_chain_cache, ("chain",) + tuple(key), "chain_hits",
                "chain_misses", make_program)


# ---------------------------------------------------------------------------
# the resolution layer: capacities, transports, assignments, envelopes
# ---------------------------------------------------------------------------


def _mesh_key(mesh) -> tuple:
    return tuple((n, int(mesh.shape[n])) for n in mesh.axis_names)


def device_stack_bound(ok, mesh, engine: str) -> int:
    """Sound per-call product-count bound for the distributed engines (a
    numpy cube): the own-C-panel engines (cannon / onesided / gather) see
    one rank's C panel's triples per local multiply; the twofive
    formulations compute partial panels for other owners, so the total
    count bounds them."""
    ok = np.asarray(ok, bool)
    if engine == "twofive":
        return int(ok.sum())
    p_r, p_c = mesh.shape["r"], mesh.shape["c"]
    nb_r, _, nb_c = ok.shape
    rr, cc = nb_r // p_r, nb_c // p_c
    return max(int(ok[r * rr:(r + 1) * rr, :, c * cc:(c + 1) * cc].sum())
               for r in range(p_r) for c in range(p_c))


def get_device_capacity(ok, mesh, engine: str) -> int:
    """Bucketed distributed product-list capacity of a cube, cached on
    (pattern signature, partition class) and counted as a pattern hit or
    miss."""
    key = (
        pattern_signature(ok), mesh.shape["r"], mesh.shape["c"],
        "twofive" if engine == "twofive" else "own-panel",
    )
    return _lru(_bound_cache, key, "pattern_hits", "pattern_misses",
                lambda: bucket_capacity(device_stack_bound(ok, mesh, engine)))


def get_transport(mask_a, mask_b, mesh, engine: str, l: int | None = None,
                  mode: str = "auto"):
    """The panel transport of one (pattern pair, mesh, engine): the sound
    bucketed per-panel capacities of the host masks — the largest occupied
    count over every A / B panel the plan's schedule ships — and the
    ``auto`` crossover (``transport.resolve_mode``).  Cached on the
    pattern signatures; counted by the ``transport_*`` fields."""
    from repro_torch.core import transport as T

    am = np.asarray(mask_a, bool)
    bm = np.asarray(mask_b, bool)
    key = ("transport", pattern_signature(am), pattern_signature(bm),
           _mesh_key(mesh), engine, l, mode)

    def make():
        plan = plan_multiply(mesh, engine, l)
        cap_a, cap_b, blocks_a, blocks_b = T.capacities_for(am, bm, plan)
        if T.resolve_mode(mode, cap_a, cap_b, blocks_a,
                          blocks_b) == "compressed":
            _stats.transport_compressed += 1
            return T.PanelTransport("compressed", cap_a, cap_b)
        _stats.transport_dense += 1
        return T.DENSE

    return _lru(_transport_cache, key, "transport_hits", "transport_misses",
                make)


def resolve_transport(spec, a, b, mesh, engine: str, l: int | None = None):
    """A transport spec as a ``PanelTransport``.

    ``spec`` is a ``PanelTransport`` (a compressed one is checked against
    the raw per-panel bounds of THIS plan and pattern: ``pack_panel``
    drops what does not fit, so under-capacity must raise here, never give
    a wrong C), a mode string (``"auto"`` / ``"dense"`` /
    ``"compressed"``), or None — the configured default
    (``config.transport_mode``, ``REPRO_TRANSPORT``).  Modes other than
    dense read the operands' masks on the host (one copy each).
    """
    from repro_torch.core import transport as T
    from repro_torch.core.bsm import host_mask

    if isinstance(spec, T.PanelTransport):
        if spec.compressed:
            (ar, ac), (br, bc) = T.plan_panel_parts(
                plan_multiply(mesh, engine, l))
            need_a = T.panel_nnz_bound(host_mask(a), ar, ac)
            need_b = T.panel_nnz_bound(host_mask(b), br, bc)
            if spec.cap_a < need_a or spec.cap_b < need_b:
                raise ValueError(
                    f"transport capacities ({spec.cap_a}, {spec.cap_b}) "
                    f"under-cover the {engine!r} plan's panels "
                    f"(need >= ({need_a}, {need_b})): packing would "
                    "drop blocks"
                )
        return spec
    if spec is None:
        from repro_torch.config import transport_mode

        spec = transport_mode()
    if spec == "dense":
        return T.DENSE
    if spec not in ("auto", "compressed"):
        raise ValueError(
            f"unknown transport {spec!r}; a PanelTransport or one of "
            "auto | dense | compressed"
        )
    return get_transport(host_mask(a), host_mask(b), mesh, engine, l, spec)


def get_assignment(mask_a, mask_b, mesh, mode: str):
    """The block->rank assignment of one (pattern pair, mesh, mode):
    ``distribute.assignment_for`` on the integer mask product of the host
    masks, cached on the pattern signatures (``assign_*`` counters)."""
    from repro_torch.core import distribute as D

    am = np.asarray(mask_a, bool)
    bm = np.asarray(mask_b, bool)
    p_r, p_c = mesh.shape["r"], mesh.shape["c"]
    key = ("assign", pattern_signature(am), pattern_signature(bm), p_r, p_c,
           mode)
    return _lru(_assign_cache, key, "assign_hits", "assign_misses",
                lambda: D.assignment_for(mode, D.product_counts(am, bm),
                                         (p_r, p_c)))


def resolve_assignment(spec, a, b, mesh):
    """An assignment spec as a ``distribute.Assignment`` or None (the
    identity layout): None / ``"identity"``, a mode string
    (``"randomized"`` / ``"nnz_greedy"``, derived from the operands' host
    masks by :func:`get_assignment`) or a ready ``Assignment`` (validated
    against both block grids; an identity permutation becomes None)."""
    if spec is None:
        return None
    from repro_torch.core import distribute as D
    from repro_torch.core.bsm import host_mask

    if isinstance(spec, str):
        if spec == "identity":
            return None
        if spec not in D.MODES:
            raise ValueError(
                f"unknown assignment {spec!r}; an Assignment or one of "
                f"{D.MODES}"
            )
        asg = get_assignment(host_mask(a), host_mask(b), mesh, spec)
    elif isinstance(spec, D.Assignment):
        asg = spec
    else:
        raise TypeError(
            f"assignment must be None, a mode string {D.MODES}, or a "
            f"distribute.Assignment; got {type(spec).__name__}"
        )
    asg.validate(a.nb_r, a.nb_c)
    asg.validate(b.nb_r, b.nb_c)
    return None if asg.is_identity else asg


def _permuted_mask_views(a, b, asg):
    """Stand-ins carrying the PERMUTED host masks of ``a`` and ``b``, for
    deriving transport capacities in the layout the engine will run in."""
    import types

    from repro_torch.core.bsm import host_mask

    p = np.asarray(asg.perm)
    return tuple(types.SimpleNamespace(mask=host_mask(m)[p][:, p])
                 for m in (a, b))


def get_envelope(mask, norms, *, sweeps: int, threshold: float = 0.0,
                 filter_eps: float = 0.0, bs: int = 1,
                 margin: float | None = None):
    """Forecast (or fetch) the pattern envelope of a purification chain:
    ``envelope.forecast_chain`` cached on a digest of the entering pattern
    (mask bits and norm bytes) and the chain spec (``envelope_*``
    counters)."""
    import hashlib

    from repro_torch.core import envelope as E

    if margin is None:
        margin = E.DEFAULT_MARGIN
    am = np.ascontiguousarray(np.asarray(mask, bool))
    an = np.ascontiguousarray(np.asarray(norms, np.float32))
    h = hashlib.sha1(np.packbits(am).tobytes())
    h.update(an.tobytes())
    key = ("envelope", h.digest(), am.shape, int(sweeps), float(threshold),
           float(filter_eps), int(bs), float(margin))
    return _lru(_envelope_cache, key, "envelope_hits", "envelope_misses",
                lambda: E.forecast_chain(
                    am, an, sweeps=sweeps, threshold=threshold,
                    filter_eps=filter_eps, bs=bs, margin=margin))


def note_drift_retune() -> None:
    """Count one drift-forced re-derivation (``drift_retunes``): a
    concrete pattern escaped its envelope and the multiply ran on
    capacities derived from its own pattern."""
    _stats.drift_retunes += 1


def note_dispatch_lookup(hit: bool) -> None:
    """Count one serving-dispatch bucket lookup (``dispatch_hits`` /
    ``dispatch_misses``): ``core.envelope.DispatchCache`` resolved a
    per-batch dispatch mask from a warmed bucket, or warmed a new one."""
    if hit:
        _stats.dispatch_hits += 1
    else:
        _stats.dispatch_misses += 1


# ---------------------------------------------------------------------------
# the schedule layer (plans of the four engines)
# ---------------------------------------------------------------------------

Perm = tuple[tuple[int, int], ...]


@dataclass(frozen=True)
class PullRound:
    """One partial permutation of one home-shard subpanel.

    ``slot``  — which of the rank's L_R A panels / L_C B panels this
                round feeds (the i3 / j3 coordinate of ``group_products``).
    ``q``     — subpanel index within the home shard (virtual index modulo
                the shard's subpanel count); selects a static slice.
    ``pairs`` — (home, requester) flattened-mesh index pairs; a valid
                partial permutation (unique sources, unique destinations).
    """

    slot: int
    q: int
    pairs: Perm


@dataclass(frozen=True)
class MultiplyPlan:
    """Static communication schedule for one (mesh, engine) pair."""

    engine: str
    kind: str  # "ring" | "pull" | "stacked" | "gather"
    mesh: object  # the mesh the schedule was compiled for
    axes: tuple[str, ...]  # mesh axes of the flattened permutation domain
    p_r: int
    p_c: int
    topo: Topology
    ticks: int
    # --- ring (cannon) ---
    pre_a: Perm = ()
    pre_b: Perm = ()
    shift_a: Perm = ()  # one ring hop of A (along c)
    shift_b: Perm = ()  # one ring hop of B (along r)
    # --- pull (Algorithm 2 on the 2D grid) ---
    a_pulls: tuple[tuple[PullRound, ...], ...] = ()  # [tick][round]
    b_pulls: tuple[tuple[PullRound, ...], ...] = ()
    c_rounds: tuple[Perm, ...] = ()  # L-1 partial-C sends
    ca: int = 1  # A subpanels per home shard (= V / P_C)
    cb: int = 1  # B subpanels per home shard (= V / P_R)
    # --- stacked ((l, r, c) mesh) ---
    layer_groups: tuple[int, ...] = ()  # ticks of each layer
    chunk_starts: tuple[int, ...] = ()  # k-chunk offset of each layer

    @property
    def l(self) -> int:
        return self.topo.l

    def validate_blocks(
        self, nb_r: int, nb_c: int, nb_k: int | None = None
    ) -> None:
        """Check the product's block grids divide this plan's topology.

        ``(nb_r, nb_c)`` is the output grid; ``nb_k`` is the contracted
        block count (A is ``nb_r x nb_k``, B is ``nb_k x nb_c``).  With
        ``nb_k=None`` the square contract applies (``nb_k`` equal to
        both).  A's column panels shard over ``p_c``, B's row panels over
        ``p_r``, and the pull formulation cuts k into V virtual subpanels.
        """
        v = self.topo.v
        if nb_r % self.p_r or nb_c % self.p_c:
            raise ValueError(
                f"block grid {nb_r}x{nb_c} does not divide the "
                f"{self.p_r}x{self.p_c} process grid"
            )
        if nb_k is None:
            if self.kind == "pull" and (nb_r % v or nb_c % v):
                raise ValueError(
                    f"block grid {nb_r}x{nb_c} does not divide the virtual "
                    f"grid V={v} (required for one-sided panel pulls)"
                )
            return
        if nb_k % self.p_c or nb_k % self.p_r:
            raise ValueError(
                f"contracted block count nb_k={nb_k} does not divide the "
                f"{self.p_r}x{self.p_c} process grid (A column panels "
                f"shard over p_c={self.p_c}, B row panels over "
                f"p_r={self.p_r})"
            )
        if self.kind == "pull" and nb_k % v:
            raise ValueError(
                f"contracted block count nb_k={nb_k} does not divide the "
                f"virtual grid V={v} (required for one-sided k-subpanel "
                f"pulls)"
            )


def _ring_perm(p: int, shift: int = 1) -> Perm:
    """Receive from (k + shift) % p: the Cannon ring hop."""
    return tuple((src, (src - shift) % p) for src in range(p))


def _partition_rounds(pairs: list[tuple[int, int]]) -> list[Perm]:
    """Split (src, dst) pairs into valid partial permutations.

    A source that must multicast (same panel requested by several ranks in
    one tick — the sqrt(L) amortization of the paper) is serialized over
    rounds; each round has unique sources and unique destinations.
    """
    rounds: list[list[tuple[int, int]]] = []
    used: list[tuple[set[int], set[int]]] = []
    for src, dst in pairs:
        for r, (srcs, dsts) in zip(rounds, used):
            if src not in srcs and dst not in dsts:
                r.append((src, dst))
                srcs.add(src)
                dsts.add(dst)
                break
        else:
            rounds.append([(src, dst)])
            used.append(({src}, {dst}))
    return [tuple(r) for r in rounds]


def _pull_schedule(topo: Topology):
    """Per-tick pull rounds + C-reduction rounds from Algorithm 2.

    Per tick group ``g`` a rank at (i, j) pulls the L_R A panels (m, k) and
    L_C B panels (k, n) of ``group_products`` from their *home* 2D
    positions: virtual A panel (m, k) lives on rank (m, k // ca) as
    subpanel k % ca (ca = V / P_C), B panel (k, n) on (k // cb, n) as
    subpanel k % cb.
    """
    p_r, p_c, v, s = topo.p_r, topo.p_c, topo.v, topo.side3d
    ca, cb = v // p_c, v // p_r

    def flat(i: int, j: int) -> int:
        return i * p_c + j

    a_ticks: list[tuple[PullRound, ...]] = []
    b_ticks: list[tuple[PullRound, ...]] = []
    for g in range(topo.ticks):
        a_classes: dict[tuple[int, int], list[tuple[int, int]]] = {}
        b_classes: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for i in range(p_r):
            for j in range(p_c):
                _, _, lay = coords3d(topo, i, j)
                if g >= topo.layer_groups(lay):
                    continue  # this layer's k-chunk is exhausted
                k = group_k(topo, i, j, g)
                im, jn = i % s, j % s
                for i3 in range(topo.l_r):
                    m = i3 * s + im
                    a_classes.setdefault((i3, k % ca), []).append(
                        (flat(m, k // ca), flat(i, j))
                    )
                for j3 in range(topo.l_c):
                    n = j3 * s + jn
                    b_classes.setdefault((j3, k % cb), []).append(
                        (flat(k // cb, n), flat(i, j))
                    )
        a_ticks.append(tuple(
            PullRound(slot=slot, q=q, pairs=perm)
            for (slot, q), pairs in sorted(a_classes.items())
            for perm in _partition_rounds(pairs)
        ))
        b_ticks.append(tuple(
            PullRound(slot=slot, q=q, pairs=perm)
            for (slot, q), pairs in sorted(b_classes.items())
            for perm in _partition_rounds(pairs)
        ))

    # L-1 partial-C sends: round d moves the partial for the panel d steps
    # along the flattened layer ring to its home (a full permutation).
    c_rounds: list[Perm] = []
    for d in range(1, topo.l):
        pairs = []
        for i in range(p_r):
            for j in range(p_c):
                _, _, lay = coords3d(topo, i, j)
                t = (lay + d) % topo.l
                ti3, tj3 = t % topo.l_r, t // topo.l_r
                pairs.append(
                    (flat(i, j), flat(ti3 * s + i % s, tj3 * s + j % s))
                )
        c_rounds.append(tuple(pairs))
    return tuple(a_ticks), tuple(b_ticks), tuple(c_rounds), ca, cb


def _resolve_l(p_r: int, p_c: int, l: int | None) -> int:
    """Default depth: forced mx/mn on non-square grids (the paper's rule),
    1 on square grids unless the caller asks for more."""
    if l is not None:
        return l
    if p_r != p_c:
        mn, mx = min(p_r, p_c), max(p_r, p_c)
        if mx % mn == 0 and mx <= mn * mn:
            return mx // mn
    return 1


@lru_cache(maxsize=256)
def plan_multiply(mesh, engine: str, l: int | None = None) -> MultiplyPlan:
    """Compile the static schedule for (mesh, engine).

    2D meshes carry ("r", "c") axes; the stacked 2.5D formulation uses an
    ("l", "r", "c") mesh.  ``l`` overrides the depth of pull plans on
    square grids (non-square grids force L = mx/mn as in the paper).
    ``mesh`` is anything hashable with ``shape`` and ``axis_names``.
    """
    axis_names = tuple(mesh.axis_names)
    if engine not in ("cannon", "onesided", "gather", "twofive"):
        raise ValueError(f"unknown engine {engine!r}")
    if l is not None and engine in ("cannon", "onesided", "gather"):
        raise ValueError(
            f"engine {engine!r} has no depth parameter (L is fixed at 1); "
            "use engine='twofive' for L > 1"
        )

    if "l" in axis_names:
        if engine != "twofive":
            raise ValueError(f"engine {engine!r} does not use an 'l' mesh axis")
        l_size = mesh.shape["l"]
        if l is not None and l != l_size:
            raise ValueError(
                f"l={l} conflicts with the mesh's 'l' axis of size {l_size}; "
                "the stacked engine takes its depth from the mesh"
            )
        p = mesh.shape["r"]
        if mesh.shape["c"] != p:
            raise ValueError(
                "stacked 2.5D requires square layer grids; use a 2D "
                "(r, c) mesh for non-square topologies (virtual depth)"
            )
        # the mesh formulation's chunk structure: V = p, depth = l_size.
        topo = Topology(
            p_r=p, p_c=p, l=l_size, l_r=1, l_c=l_size, side3d=p,
            v=p, nbuffers_a=2, nbuffers_b=2,
        )
        groups = tuple(topo.layer_groups(li) for li in range(l_size))
        starts = tuple(topo.chunk(li)[0] for li in range(l_size))
        ticks = max(groups)
        pre_a = tuple(
            (
                (li * p + i) * p + j,
                (li * p + i) * p + (j - i - starts[li]) % p,
            )
            for li in range(l_size)
            for i in range(p)
            for j in range(p)
        )
        pre_b = tuple(
            (
                (li * p + i) * p + j,
                (li * p + (i - j - starts[li]) % p) * p + j,
            )
            for li in range(l_size)
            for i in range(p)
            for j in range(p)
        )
        return MultiplyPlan(
            engine=engine, kind="stacked", mesh=mesh, axes=("l", "r", "c"),
            p_r=p, p_c=p, topo=topo, ticks=ticks,
            pre_a=pre_a, pre_b=pre_b,
            shift_a=_ring_perm(p), shift_b=_ring_perm(p),
            layer_groups=groups, chunk_starts=starts,
        )

    p_r, p_c = mesh.shape["r"], mesh.shape["c"]
    if engine == "gather":
        topo = make_topology(p_r, p_c, 1)
        return MultiplyPlan(
            engine=engine, kind="gather", mesh=mesh, axes=("r", "c"),
            p_r=p_r, p_c=p_c, topo=topo, ticks=1,
        )

    if engine == "cannon":
        if p_r != p_c:
            raise ValueError("Cannon engine requires a square grid")
        p = p_r
        topo = make_topology(p, p, 1)
        pre_a = tuple(
            (i * p + j, i * p + (j - i) % p) for i in range(p) for j in range(p)
        )
        pre_b = tuple(
            (i * p + j, ((i - j) % p) * p + j) for i in range(p) for j in range(p)
        )
        return MultiplyPlan(
            engine=engine, kind="ring", mesh=mesh, axes=("r", "c"),
            p_r=p, p_c=p, topo=topo, ticks=topo.v,
            pre_a=pre_a, pre_b=pre_b,
            shift_a=_ring_perm(p), shift_b=_ring_perm(p),
        )

    # onesided / twofive on the plain 2D grid: the pull formulation.
    depth = 1 if engine == "onesided" else _resolve_l(p_r, p_c, l)
    topo = make_topology(p_r, p_c, depth)
    if l is not None and engine == "twofive" and topo.l != l:
        raise ValueError(
            f"L={l} is invalid for a {p_r}x{p_c} grid (paper rule); "
            f"topology resolved L={topo.l}"
        )
    a_pulls, b_pulls, c_rounds, ca, cb = _pull_schedule(topo)
    return MultiplyPlan(
        engine=engine, kind="pull", mesh=mesh, axes=("r", "c"),
        p_r=p_r, p_c=p_c, topo=topo, ticks=topo.ticks,
        a_pulls=a_pulls, b_pulls=b_pulls, c_rounds=c_rounds, ca=ca, cb=cb,
    )


# ---------------------------------------------------------------------------
# execution: engine bodies over rank lists
# ---------------------------------------------------------------------------


def build_shard_body(plan: MultiplyPlan, *, threshold: float, backend: str,
                     stack_capacity: int | None = None, transport=None,
                     c_layout: str = "2d",
                     tile: tuple[int, int] | None = None):
    """The engine's body over rank lists: ``(ab, am, an, bb, bm, bn) ->
    (cb, cm)``, each a list of per-rank shards in flattened-rank order.

    Iteration chains (``core/signiter.py``) call it inside their sweep:
    the multiplies and the algebra between them run on the shards with no
    re-partitioning.  C comes home in the 2D (r, c) layout unless a
    stacked plan is asked for ``c_layout="scatter"`` (C reduce-scattered
    over ``l`` along block rows); other plans ignore ``c_layout``, as in
    the reference.  ``transport`` is a resolved ``PanelTransport``; None
    is dense (a fused chain without an envelope keeps dense panels).
    ``tile`` is the ``cuda`` kernel's group layout (None the default).
    """
    from repro_torch.core import transport as T

    if c_layout not in ("2d", "scatter"):
        raise ValueError(f"unknown c_layout {c_layout!r}")
    if transport is None:
        transport = T.DENSE
    if not isinstance(transport, T.PanelTransport):
        raise TypeError("build_shard_body takes a resolved PanelTransport "
                        f"or None, not {transport!r}")
    kw = dict(
        threshold=threshold, backend=backend,
        stack_capacity=stack_capacity, transport=transport, tile=tile,
    )
    if plan.kind == "ring":
        from repro_torch.core.cannon import ring_body

        return ring_body(plan, **kw)
    if plan.kind == "pull":
        from repro_torch.core.twofive import pull_body

        return pull_body(plan, **kw)
    if plan.kind == "stacked":
        from repro_torch.core.twofive import stacked_body

        return stacked_body(plan, c_layout=c_layout, **kw)
    if plan.kind == "gather":
        from repro_torch.core.gather import gather_body

        return gather_body(plan, **kw)
    raise ValueError(plan.kind)


def _validated_plan(a, b, mesh, engine: str, l: int | None) -> MultiplyPlan:
    """The plan of ``a . b`` on ``mesh``, its block grids checked (the
    square contract, or the rectangular one with ``nb_k``)."""
    if a.nb_c != b.nb_r or a.bs_c != b.bs_r:
        raise ValueError(
            f"operand shapes do not contract: A is {a.nb_r}x{a.nb_c} "
            f"blocks of {a.bs_r}x{a.bs_c}, B is {b.nb_r}x{b.nb_c} "
            f"blocks of {b.bs_r}x{b.bs_c}"
        )
    plan = plan_multiply(mesh, engine, l)
    if (a.nb_c, b.nb_c) == (a.nb_r, a.nb_r):
        plan.validate_blocks(a.nb_r, a.nb_r)
    else:
        plan.validate_blocks(a.nb_r, b.nb_c, a.nb_c)
    return plan


def run_body(plan: MultiplyPlan, body, a, b, *, c_layout: str = "2d",
             assignment=None):
    """The counterpart of the reference's shard_map executors: shard two
    replicated operands onto ``plan.mesh`` (``bsm.shard_bsm``, under
    ``assignment``), run ``body`` over the rank lists, and gather C (one
    ``BlockSparseMatrix`` on the mesh's first device, in original block
    coordinates)."""
    from repro_torch.core import bsm as B
    from repro_torch.core import distribute as D

    mesh = plan.mesh
    sa = B.shard_bsm(a, mesh, assignment=assignment)
    sb = sa if b is a else B.shard_bsm(b, mesh, assignment=assignment)
    cb, cm = body(sa.blocks, sa.mask, sa.norms, sb.blocks, sb.mask, sb.norms)
    if plan.kind == "stacked" and c_layout == "scatter":
        c = B.unshard_row_scatter(mesh, cb, cm)
        return c if assignment is None else D.undo_assignment(c, assignment)
    return B.ShardedBSM.from_shards(cb, cm, mesh, sa.assignment).unshard()


def execute(a, b, mesh, engine: str, *, threshold: float = 0.0,
            backend: str | None = None, c_layout: str = "2d",
            l: int | None = None, stack_capacity: int | None = None,
            transport=None, assignment=None,
            tile: tuple[int, int] | None = None):
    """One distributed multiply from replicated operands: shard, run the
    engine's body, gather C — the path behind ``engine.multiply`` and the
    per-engine wrappers (``multiply_2d`` / ``multiply_gather`` /
    ``multiply_25d``).

    ``assignment`` (None / mode string / ``distribute.Assignment``) is the
    block->rank layout the multiply runs under: the operands are permuted
    at the shard boundary and C comes back in original block coordinates.
    The transport is resolved on the permuted masks, the pattern the
    engine ships.  ``engine="auto"`` asks the tuner
    (``tuner.resolve_multiply``) for the engine and every option the
    caller left open; a ``backend`` left at None is then the tuner's, and
    "dense" for a named engine."""
    if engine == "auto":
        from repro_torch.tuner import resolve_multiply

        engine, kw = resolve_multiply(
            a, b, mesh, threshold=threshold, backend=backend, l=l,
            stack_capacity=stack_capacity, transport=transport,
            assignment=assignment, tile=tile)
        return execute(a, b, mesh, engine, c_layout=c_layout, **kw)
    backend = backend or "dense"
    plan = _validated_plan(a, b, mesh, engine, l)
    asg = resolve_assignment(assignment, a, b, mesh)
    ta, tb = (a, b) if asg is None else _permuted_mask_views(a, b, asg)
    tr = resolve_transport(transport, ta, tb, mesh, engine, l)
    body = build_shard_body(plan, threshold=threshold, backend=backend,
                            stack_capacity=stack_capacity,
                            transport=tr, c_layout=c_layout, tile=tile)
    return run_body(plan, body, a, b, c_layout=c_layout, assignment=asg)


def execute_sharded(a, b, engine: str, *, threshold: float = 0.0,
                    backend: str | None = None, c_layout: str = "2d",
                    l: int | None = None,
                    stack_capacity: int | None = None, transport=None,
                    assignment=None, tile: tuple[int, int] | None = None):
    """Sharded multiply: ShardedBSM in, ShardedBSM out, no gather.  C stays
    in the 2D home layout its next multiply consumes (``c_layout`` must be
    "2d") and inherits the operands' assignment.

    Sharded operands already live in their assignment's permuted layout
    (``shard_bsm`` applied it), so their masks are the pattern the
    transport is resolved on; an ``assignment`` here can only confirm the
    carried layout.  Resolving a transport other than dense reads the
    masks on the host (one copy per operand and call); fused chains never
    come here.  ``engine="auto"`` asks the tuner with the assignment
    pinned to identity: the layout was chosen at ``shard_bsm``, and the
    tuner sees the permuted pattern.  ``backend`` None is ``execute``'s."""
    from repro_torch.core import bsm as B

    if c_layout != "2d":
        raise ValueError("sharded chains require c_layout='2d'")
    if a.mesh != b.mesh:
        raise ValueError("operands sharded on different meshes")
    asg = a._join_assignment(b)
    if assignment is not None:
        want = getattr(assignment, "mode", assignment)
        if want != B._assign_name(asg):
            raise ValueError(
                f"operands are sharded under assignment "
                f"{B._assign_name(asg)}; cannot execute under {want!r} — "
                "unshard and redistribute instead"
            )
    if engine == "auto":
        from repro_torch.tuner import resolve_multiply

        engine, kw = resolve_multiply(
            a, b, a.mesh, threshold=threshold, backend=backend, l=l,
            stack_capacity=stack_capacity, transport=transport,
            assignment=assignment, tile=tile)
        return execute_sharded(a, b, engine, c_layout=c_layout, **kw)
    backend = backend or "dense"
    plan = _validated_plan(a, b, a.mesh, engine, l)
    tr = resolve_transport(transport, a, b, a.mesh, engine, l)
    body = build_shard_body(plan, threshold=threshold, backend=backend,
                            stack_capacity=stack_capacity, transport=tr,
                            tile=tile)
    cb, cm = body(a.blocks, a.mask, a.norms, b.blocks, b.mask, b.norms)
    return B.ShardedBSM.from_shards(cb, cm, a.mesh, asg)
