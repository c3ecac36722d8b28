"""Pattern-envelope forecasting: one set of capacities for a whole drifting
chain — the twin of ``repro/core/envelope.py`` (host numpy, float64, as
there).

Purification changes the sparsity pattern every sweep: the mask product
fills blocks in and the threshold filter decays them.  Without an envelope
the port's fused sweep compacts each local multiply at the exact bucketed
count of its own cube (one host sync for the count) and pins dense panel
transport, since a packing capacity taken from the first pattern would
drop fill-in blocks mid-iteration.  ``forecast_chain`` propagates a
*symbolic* (mask, norm-bound) pair through the Newton-Schulz recurrence
X <- 1/2 X (3I - X^2) and returns an :class:`Envelope`: an
over-approximation of every per-sweep pattern the realized chain can
visit.  Capacities derived from it (product lists:
``local_capacity`` / ``device_capacity``; packed panels: ``transport``)
are sound for every sweep, so the chain keeps one product-list shape and
one transport throughout.

Soundness (the reference's argument, unchanged): with ``m_s`` / ``n_s``
the realized mask and block norms entering sweep ``s`` and ``M_s`` /
``N_s`` the symbolic pair, the invariant ``m_s <= M_s`` and
``n_s <= (1 + eps_s) N_s`` holds by induction: the symbolic filter keeps
every product with ``N_ik N_kj > threshold / (1 + margin)``, the result
bound ``sum_k N_ik N_kj`` dominates the realized norm by the triangle
inequality, ``Y = 3I - X^2`` adds ``3 sqrt(bs)`` on the diagonal, and the
post-filter compares against ``filter_eps / (1 + margin)`` before the
exact 0.5 scale.  ``margin`` (5 % by default) absorbs the f32 rounding of
the realized chain.

The port stops propagating at the symbolic fixed point: once a sweep
leaves (mask, norm bounds) bitwise unchanged — the bounds grow until they
hit the ``_NORM_CAP`` ceiling and the mask fills — every later sweep would
repeat it exactly, so its mask is repeated instead of recomputed.  The
result is identical to propagating all ``sweeps`` sweeps.

``union_envelope`` is the stream-shaped constructor (no recurrence): the
union of a family of operand masks (serving batches, MoE expert dispatch,
where no two batches share an exact mask) and its product cube, sound for
any threshold.

``DispatchCache`` is the serving stream's pattern-bucketed envelope and
decision cache (the MoE ``spgemm`` impl's dispatch): one union envelope
per ``tuner.features.mask_bucket``, its decision resolved once per bucket
and persisted in the bound tuning database.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import cached_property

import numpy as np

from repro_torch.kernels.stacks import bucket_capacity, pattern_signature

# default floating-point slack absorbed by the effective thresholds
DEFAULT_MARGIN = 0.05

# norm-bound ceiling: propagated bounds grow every sweep and would overflow
# float64 on long chains.  Clipping down stays sound because any realized
# norm is a finite float32 (<= ~3.4e38 << _NORM_CAP), and products of two
# capped bounds stay finite (1e200 < float64 max).
_NORM_CAP = 1e100

def _frozen(arr: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(arr)
    arr.flags.writeable = False
    return arr


@dataclass(frozen=True)
class Envelope:
    """Over-approximating pattern envelope of a multiply chain or stream.

    ``mask_a`` / ``mask_b``  — 2D bool unions of every left / right
        operand mask a chain multiply can ship (transport capacities).
    ``cube``                 — (nb_r, nb_k, nb_c) bool union of every
        per-multiply surviving-product cube (product-list capacities).
    ``sweep_masks``          — per-sweep forecast result masks of a
        ``forecast_chain`` envelope; empty for stream envelopes.
    ``threshold`` / ``filter_eps`` / ``margin`` — the chain spec the
        forecast ran under (0 / 0 / 0 for stream envelopes).
    """

    mask_a: np.ndarray
    mask_b: np.ndarray
    cube: np.ndarray
    sweep_masks: tuple = ()
    threshold: float = 0.0
    filter_eps: float = 0.0
    margin: float = 0.0

    @cached_property
    def signature(self) -> bytes:
        """Digest identifying this envelope (cache-key part)."""
        h = hashlib.sha1(b"envelope")
        h.update(pattern_signature(self.cube))
        h.update(pattern_signature(self.mask_a))
        h.update(pattern_signature(self.mask_b))
        h.update(np.float64([self.threshold, self.filter_eps,
                             self.margin]).tobytes())
        return h.digest()

    def covers(self, mask_a, mask_b=None) -> bool:
        """Whether a concrete operand pattern lies inside the envelope —
        the cheap 2D drift check ``engine.multiply`` runs before trusting
        envelope-derived capacities."""
        am = np.asarray(mask_a, bool)
        if am.shape != self.mask_a.shape or not (am <= self.mask_a).all():
            return False
        if mask_b is None:
            return True
        bm = np.asarray(mask_b, bool)
        return bm.shape == self.mask_b.shape and bool((bm <= self.mask_b).all())

    def local_capacity(self) -> int:
        """Bucketed single-device product-list capacity covering every
        multiply of the chain (the union cube's product count)."""
        return bucket_capacity(int(self.cube.sum()))

    def device_capacity(self, mesh, engine: str) -> int:
        """Bucketed per-rank product-list capacity over the envelope cube
        (``plan.get_device_capacity``: monotone in the cube, so sound for
        every sweep)."""
        from repro_torch.core import plan as plan_mod

        return plan_mod.get_device_capacity(self.cube, mesh, engine)

    def transport(self, mesh, engine: str, l: int | None = None,
                  mode: str = "auto"):
        """Panel transport resolved against the envelope's operand-mask
        unions: packing capacities that cover every panel any sweep can
        ship (``plan.get_transport``, monotone in the masks)."""
        from repro_torch.core import plan as plan_mod

        return plan_mod.get_transport(self.mask_a, self.mask_b, mesh,
                                      engine, l, mode)


def forecast_chain(
    mask,
    norms,
    *,
    sweeps: int,
    threshold: float = 0.0,
    filter_eps: float = 0.0,
    bs: int = 1,
    margin: float = DEFAULT_MARGIN,
) -> Envelope:
    """Symbolic fill-in forecast of ``sweeps`` Newton-Schulz sweeps.

    ``mask`` / ``norms`` — the concrete pattern entering the chain (after
    the spectral scale and any storage cast), numpy on the host.  ``bs``
    — the square block edge (the identity block's Frobenius norm is
    ``sqrt(bs)``).  Returns the :class:`Envelope` whose cube / mask unions
    cover every multiply of the chain and whose ``sweep_masks[s]`` covers
    the realized result mask of sweep ``s``.
    """
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    if margin < 0.0:
        raise ValueError(f"margin must be >= 0, got {margin}")
    m = np.asarray(mask, bool)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"chain forecasting needs a square 2D mask, "
                         f"got shape {m.shape}")
    n = np.where(m, np.asarray(norms, np.float64), 0.0)
    nb = m.shape[0]
    eye = np.eye(nb, dtype=bool)
    ident_norm = 3.0 * np.sqrt(float(bs))
    thr_eff = threshold / (1.0 + margin)
    eps_eff = filter_eps / (1.0 + margin)

    # the cube is kept k-major, (k, i, j), while it is built
    cube_k = np.zeros((nb, nb, nb), bool)

    def multiply(lm, ln, rm, rn):
        """Symbolic filtered product (+ post-filter): the surviving
        products OR-ed into ``cube_k``, the result mask and norm bound.
        One k at a time, which sums the bounds in the order of
        ``np.sum(axis=1)`` over the full (i, k, j) cube, bit for bit."""
        cm = np.zeros((nb, nb), bool)
        cn = np.zeros((nb, nb))
        for k in range(nb):
            ok = lm[:, k, None] & rm[None, k, :]
            t = ln[:, k, None] * rn[None, k, :]
            if threshold > 0.0:
                ok &= t > thr_eff
            cube_k[k] |= ok
            cm |= ok
            cn += np.where(ok, t, 0.0)
        cn = np.minimum(cn, _NORM_CAP)
        if filter_eps > 0.0:
            keep = cm & (cn > eps_eff)
            cm, cn = keep, np.where(keep, cn, 0.0)
        return cm, cn

    union_a = m.copy()
    union_b = m.copy()
    sweep_masks = []
    while len(sweep_masks) < sweeps:
        # multiply 1: X . X (+ post-filter, the realized sweep's order)
        x2m, x2n = multiply(m, n, m, n)
        # Y = 3I - X^2: diagonal blocks gain the identity's norm bound
        ym = x2m | eye
        yn = x2n + ident_norm * eye
        # multiply 2: X . Y, post-filter BEFORE the exact 0.5 scale
        cm, cn = multiply(m, n, ym, yn)
        union_a |= m
        union_b |= m | ym
        fixed = np.array_equal(cm, m) and np.array_equal(0.5 * cn, n)
        m, n = cm, 0.5 * cn
        sweep_masks.append(_frozen(m))
        if fixed:  # every later sweep repeats this one bit for bit
            sweep_masks.extend([sweep_masks[-1]] * (sweeps - len(sweep_masks)))
    cube = cube_k.transpose(1, 0, 2)
    return Envelope(
        mask_a=_frozen(union_a),
        mask_b=_frozen(union_b),
        cube=_frozen(cube),
        sweep_masks=tuple(sweep_masks),
        threshold=float(threshold),
        filter_eps=float(filter_eps),
        margin=float(margin),
    )


def union_envelope(masks_a, masks_b=None) -> Envelope:
    """Stream envelope: the union of a family of concrete operand masks.

    ``masks_a`` — iterable of (nb_r, nb_k) left-operand masks;
    ``masks_b`` — right-operand masks (defaults to ``masks_a``, the A @ A
    stream).  The cube is the product cube of the unions — sound for any
    threshold, since the norm filter only removes products.
    """
    from repro_torch.tuner.features import mask_union

    ua = mask_union(masks_a)
    ub = ua if masks_b is None else mask_union(masks_b)
    if ua.shape[1] != ub.shape[0]:
        raise ValueError(
            f"operand mask unions do not chain: {ua.shape} @ {ub.shape}"
        )
    cube = ua[:, :, None] & ub[None, :, :]
    return Envelope(mask_a=_frozen(ua), mask_b=_frozen(ub),
                    cube=_frozen(cube))


# ---------------------------------------------------------------------------
# DispatchCache: the serving-grade pattern-bucketed decision cache
# ---------------------------------------------------------------------------


@dataclass
class DispatchBucket:
    """One warmed request-mix regime: a union envelope plus the decision
    resolved for it (local backend + stack capacity), and its counters."""

    envelope: Envelope
    decision: dict
    hits: int = 0
    widenings: int = 0


def _analytic_dispatch_decision(env: Envelope, bs_r: int, bs_k: int,
                                bs_c: int, dtype: str,
                                device="cpu") -> dict:
    """Backend + capacity for a dispatch envelope, from the cost model.

    The same dense / compacted crossover the engine's ``choose_backend``
    runs on concrete patterns (``local_mm.backend_local_cost``), evaluated
    once on the envelope's union cube.  The compacted backend is the
    flavour of ``device``: ``cuda`` (the kernel) on a CUDA device, where
    the reference names its jnp gather path ``stacks``, and ``stacks`` on
    the CPU; the dense one is ``dense`` (the reference's ``jnp``).
    """
    import torch

    from repro_torch.core.local_mm import backend_local_cost

    dt = getattr(torch, str(dtype))
    ni, nk, nj = env.cube.shape
    fill = float(env.cube.mean()) if env.cube.size else 0.0
    dense = backend_local_cost(ni, nk, nj, bs_r, bs_k, bs_c, fill=1.0,
                               backend="dense", dtype=dt)
    compact = backend_local_cost(ni, nk, nj, bs_r, bs_k, bs_c, fill=fill,
                                 backend="stacks", dtype=dt)
    if dense <= compact:
        backend = "dense"
    else:
        backend = "cuda" if torch.device(device).type == "cuda" else "stacks"
    return {"backend": backend, "capacity": env.local_capacity(),
            "source": "analytic"}


class DispatchCache:
    """Pattern-bucketed envelope / decision cache for serving streams.

    Every batch routes tokens differently, so no two dispatch masks are
    equal, but request MIXES are stable for long stretches.  The cache
    groups masks into the coarse buckets of ``tuner.features.mask_bucket``
    (log2 shape classes, occupancy deciles, row-load class) and keeps ONE
    union envelope per bucket:

    * ``resolve(mask)`` on a warmed bucket whose envelope covers the mask
      is the warm path: the envelope's capacity serves every batch of the
      mix (``dispatch_hits`` in ``plan.cache_stats()``);
    * a mask in a NEW bucket warms it (``dispatch_misses``: once per
      request-mix regime, not per batch);
    * a mask that escapes its bucket's envelope WIDENS the union and
      re-resolves the decision (``drift_retunes``).

    The per-bucket decision is resolved once per bucket; with a tuning
    database bound (``tuner.set_default_db``, the ``--tuning-db`` serving
    flag) it is persisted under a ``dispatch|`` key with the device that
    decided it, so a relaunched server warm-starts every mix it has seen.
    ``device`` names where the multiplies run (CUDA unless the caller
    names another): it picks the compacted backend's name.
    """

    def __init__(self, mask_b, *, bs_r: int = 1, bs_k: int = 1,
                 bs_c: int = 1, dtype: str = "float32",
                 decision_fn=None, device=None):
        from repro_torch.config import resolve_device

        self.mask_b = np.asarray(mask_b, bool)
        self.bs_r, self.bs_k, self.bs_c = int(bs_r), int(bs_k), int(bs_c)
        self.dtype = str(dtype)
        self._decision_fn = decision_fn
        self.device = resolve_device(device)
        self._buckets: dict[tuple, DispatchBucket] = {}

    # ---- keys ----------------------------------------------------------
    def bucket_of(self, mask) -> tuple:
        from repro_torch.tuner.features import mask_bucket

        return mask_bucket(mask, self.bs_r, self.bs_c)

    # ---- decision resolution (once per bucket) -------------------------
    def _db_key(self, key: tuple) -> str:
        return "dispatch|" + "|".join(str(p) for p in key)

    def _decide(self, key: tuple, env: Envelope) -> dict:
        from repro_torch import tuner
        from repro_torch.tuner.db import device_tag

        if self._decision_fn is not None:
            return dict(self._decision_fn(env))
        db = tuner.get_default_db()
        need = env.local_capacity()
        tag = device_tag(self.device)
        if db is not None:
            rec = db.lookup(self._db_key(key), tag)
            # a persisted decision is reusable only while its capacity
            # still covers this envelope (capacities grow with the union)
            if rec is not None and int(rec.get("capacity", 0)) >= need:
                return {"backend": rec["backend"],
                        "capacity": int(rec["capacity"]), "source": "db"}
        dec = _analytic_dispatch_decision(env, self.bs_r, self.bs_k,
                                          self.bs_c, self.dtype, self.device)
        if db is not None:
            db.record(self._db_key(key), dict(dec, device=tag))
        return dec

    # ---- the serving-path API ------------------------------------------
    def warm(self, masks) -> "DispatchCache":
        """Fold a calibration stream into the buckets (no hit / miss
        accounting: calibration is not serving traffic)."""
        for m in masks:
            self._observe(np.asarray(m, bool), calibration=True)
        return self

    def resolve(self, mask) -> tuple[Envelope, dict]:
        """Serving-time lookup: (envelope, decision) for one batch's
        dispatch mask, with warm / miss / drift accounting."""
        return self._observe(np.asarray(mask, bool), calibration=False)

    def _observe(self, m: np.ndarray, *, calibration: bool):
        from repro_torch.core import plan as plan_mod

        key = self.bucket_of(m)
        bkt = self._buckets.get(key)
        if bkt is None:
            env = union_envelope([m], [self.mask_b])
            bkt = DispatchBucket(envelope=env,
                                 decision=self._decide(key, env))
            self._buckets[key] = bkt
            if not calibration:
                plan_mod.note_dispatch_lookup(False)
            return bkt.envelope, bkt.decision
        if not bkt.envelope.covers(m):
            # in-bucket drift: widen the union, re-resolve the decision
            bkt.envelope = union_envelope(
                [bkt.envelope.mask_a, m], [self.mask_b])
            bkt.decision = self._decide(key, bkt.envelope)
            bkt.widenings += 1
            if not calibration:
                plan_mod.note_drift_retune()
            return bkt.envelope, bkt.decision
        if not calibration:
            bkt.hits += 1
            plan_mod.note_dispatch_lookup(True)
        return bkt.envelope, bkt.decision

    # ---- introspection -------------------------------------------------
    def __len__(self) -> int:
        return len(self._buckets)

    def stats(self) -> dict:
        return {
            "buckets": len(self._buckets),
            "hits": sum(b.hits for b in self._buckets.values()),
            "widenings": sum(b.widenings for b in self._buckets.values()),
            "capacities": sorted(
                {int(b.decision["capacity"]) for b in self._buckets.values()}
            ),
        }
