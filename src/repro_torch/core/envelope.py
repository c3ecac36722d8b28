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
union of a family of operand masks and its product cube.

``DispatchCache`` and its helpers (the serving stream's pattern-bucketed
decision cache) belong to the MoE dispatch slices (ROADMAP.md Queue A
items 13.1 and 14) and raise here.
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

_DISPATCH = ("the serving dispatch cache is the MoE dispatch path: "
             "ROADMAP.md Queue A items 13.1 and 14")


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
# the serving dispatch cache: the MoE dispatch slices', not ported yet
# ---------------------------------------------------------------------------


class DispatchBucket:
    """One warmed request-mix regime of ``DispatchCache`` (items 13.1,
    14)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_DISPATCH)


def _analytic_dispatch_decision(*args, **kwargs) -> dict:
    """Backend + capacity for a dispatch envelope (items 13.1, 14)."""
    raise NotImplementedError(_DISPATCH)


class DispatchCache:
    """Pattern-bucketed envelope/decision cache for serving streams; its
    buckets are the tuner's feature buckets and its decisions the tuner's
    database records (items 13.1, 14)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_DISPATCH)
