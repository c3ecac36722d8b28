"""Matrix-sign iteration — the paper's driving application (linear-scaling
DFT density-matrix purification, Eqs. (1)-(3)); the torch twin of
``repro/core/signiter.py``, single device.

    sign(A) = A (A^2)^{-1/2};   X_{n+1} = 1/2 X_n (3 I - X_n^2)

Each iteration is two block-sparse multiplications with on-the-fly and
post-multiplication filtering.

``fused`` (default) — one sweep (X², post-filter, 3I − X², X·Y,
    post-filter, the 0.5 scale, residual and occupancy) is one cached
    function (``plan.get_chain_program``) that runs eagerly on the device.
    Residual and occupancy stay device scalars until every
    ``sync_every``-th sweep.  Each multiply compacts the current pattern on
    the device at its exact bucketed capacity, where the reference traces
    the sweep once at full-cube capacity; padding adds nothing, so the
    numbers are the same.  Reading the product count costs one sync per
    multiply; capturing the sweep in a CUDA graph is later work.

``legacy`` — the host-driven loop: each multiply re-enters ``multiply()``,
    the algebra between multiplies runs as separate operations, and the
    residual syncs every sweep.  Kept as the parity oracle.

``density_matrix`` evaluates P = 1/2 (I - sign(H - mu I)) (paper Eq. (1),
S = I); trace(P) = #{eigenvalues < mu} is the convergence observable.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core import bsm as B
from repro_torch.core import plan as plan_mod
from repro_torch.core.bsm import block_norms
from repro_torch.core.engine import multiply
from repro_torch.core.local_mm import local_filtered_mm


@dataclass
class SignIterStats:
    iterations: int
    converged: bool
    residual: float
    occupancy_trace: list[float]
    multiplications: int
    residual_trace: list[float] = field(default_factory=list)
    mode: str = "legacy"
    sync_every: int = 1
    host_syncs: int = 0  # device->host residual syncs (fused: ~it/sync_every)
    retraces: int = 0  # fused: sweep programs built (chain_misses delta);
    #   legacy: fresh product-list compactions (pattern_misses delta)


def _check_single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the sharded sign iteration arrives with the distributed slices "
            "(ROADMAP.md Queue A item 9); pass mesh=None"
        )


def _scale_to_unit_spectrum(x: B.BlockSparseMatrix) -> B.BlockSparseMatrix:
    """Scale X0 so its spectrum lies in [-1, 1] (Frobenius bound)."""
    nrm = x.frobenius_norm()
    return B.scale(x, 1.0 / torch.clamp(nrm, min=1e-30))


# ---------------------------------------------------------------------------
# the fused sweep
# ---------------------------------------------------------------------------


def _make_sweep(mm, filter_eps: float, *, total_blocks: int):
    """One whole Newton-Schulz sweep as a single function.

    ``mm(ab, am, an, bb, bm, bn) -> (cb, cm)`` is the multiply body
    (``local_filtered_mm`` on one device).  Everything between the two
    multiplies is block algebra with incrementally-updated norms; the
    residual and occupancy leave as device scalars.
    """
    eps = float(filter_eps)

    def post_filter(cb, cm, cn):
        if eps <= 0.0:
            return cb, cm, cn
        keep = cm & (cn > eps)
        return (
            cb * keep[:, :, None, None].to(cb.dtype),
            keep,
            torch.where(keep, cn, 0.0),
        )

    def sweep(xb, xm, xn, ib, im):
        # X^2 (multiply 1) + post-filter, mirroring multiply(filter_eps=...)
        x2b, x2m = mm(xb, xm, xn, xb, xm, xn)
        x2n = block_norms(x2b)
        x2b, x2m, x2n = post_filter(x2b, x2m, x2n)
        # Y = 3I - X^2, norms from the new blocks
        yb = ib * 3.0 - x2b  # 3 and 1/2 are exact in every storage dtype
        ym = im | x2m
        yn = block_norms(yb)
        # X . Y (multiply 2) + post-filter + the 1/2 scale (derived norms)
        cb, cm = mm(xb, xm, xn, yb, ym, yn)
        cn = block_norms(cb)
        cb, cm, cn = post_filter(cb, cm, cn)
        cb = cb * 0.5
        cn = cn * 0.5
        # convergence: || X_{n+1} - X_n ||_F / || X_{n+1} ||_F
        num_sq = torch.sum(torch.square((cb - xb).to(torch.float32)))
        den_sq = torch.sum(torch.square(cn))
        residual = torch.sqrt(num_sq) / torch.clamp(torch.sqrt(den_sq),
                                                    min=1e-30)
        occupancy = cm.to(torch.float32).sum() / total_blocks
        return cb, cm, cn, residual, occupancy

    return sweep


def get_sweep_program(x: B.BlockSparseMatrix, *, threshold: float,
                      filter_eps: float, backend: str):
    """The fused sweep for (shape, dtype, device, thresholds, backend),
    cached in the plan layer (``chain_hits`` / ``chain_misses``).

    ``backend="auto"`` becomes ``dense``, as in the reference's fused
    sweep (one sweep serves the whole evolving pattern; resolve "auto"
    against a concrete pattern before the chain, as ``launch/purify.py``
    does).
    """
    if backend == "auto":
        backend = "dense"
    key = ("signiter", x.nb_r, x.nb_c, x.bs_r, x.bs_c, str(x.dtype),
           str(x.device), float(threshold), float(filter_eps), backend)

    def make_program():
        def mm(*args):
            return local_filtered_mm(*args, threshold=threshold,
                                     backend=backend)

        return _make_sweep(mm, filter_eps, total_blocks=x.nb_r * x.nb_c)

    return plan_mod.get_chain_program(key, make_program)


# ---------------------------------------------------------------------------
# iteration loops
# ---------------------------------------------------------------------------


def sign_iteration_legacy(
    x0: B.BlockSparseMatrix,
    *,
    mesh=None,
    threshold: float = 0.0,
    filter_eps: float = 0.0,
    max_iter: int = 50,
    tol: float = 1e-6,
    backend: str = "dense",
    storage_dtype: torch.dtype | None = None,
) -> tuple[B.BlockSparseMatrix, SignIterStats]:
    """The host-driven per-op loop (parity oracle): two ``multiply()``
    re-entries per sweep, eager algebra between them, a host residual sync
    every sweep."""
    _check_single_device(mesh)
    nb, bs = x0.nb_r, x0.bs_r
    ident = B.identity(nb, bs, x0.dtype, device=x0.device)
    x = _scale_to_unit_spectrum(x0)
    if storage_dtype is not None:
        # cast AFTER the spectral scale; norms recalibrated (bsm.astype)
        x = B.cast_bsm(x, storage_dtype)
        ident = B.cast_bsm(ident, storage_dtype)
    occ, res_trace = [], []
    n_mults = 0
    converged = False
    residual = float("inf")
    misses0 = plan_mod.cache_stats()["pattern_misses"]
    it = 0
    for it in range(1, max_iter + 1):
        x2 = multiply(x, x, threshold=threshold, filter_eps=filter_eps,
                      backend=backend)
        n_mults += 1
        # 3I - X^2
        y = B.add(B.scale(x2, -1.0), B.scale(ident, 3.0))
        xn = multiply(x, y, threshold=threshold, filter_eps=filter_eps,
                      backend=backend)
        xn = B.scale(xn, 0.5)
        n_mults += 1
        # convergence: || X_{n+1} - X_n ||_F / || X_n ||_F
        diff = B.add(xn, B.scale(x, -1.0))
        residual = float(diff.frobenius_norm()
                         / torch.clamp(xn.frobenius_norm(), min=1e-30))
        res_trace.append(residual)
        occ.append(float(xn.occupancy()))
        x = xn
        if residual < tol:
            converged = True
            break
    stats = SignIterStats(
        iterations=it,
        converged=converged,
        residual=residual,
        occupancy_trace=occ,
        multiplications=n_mults,
        residual_trace=res_trace,
        mode="legacy",
        sync_every=1,
        host_syncs=it,
        retraces=plan_mod.cache_stats()["pattern_misses"] - misses0,
    )
    return x, stats


def sign_iteration(
    x0: B.BlockSparseMatrix,
    *,
    mesh=None,
    threshold: float = 0.0,
    filter_eps: float = 0.0,
    max_iter: int = 50,
    tol: float = 1e-6,
    mode: str = "fused",
    sync_every: int = 1,
    backend: str = "dense",
    storage_dtype: torch.dtype | None = None,
) -> tuple[B.BlockSparseMatrix, SignIterStats]:
    """Newton-Schulz iteration X <- 1/2 X (3I - X^2) to sign(x0).

    mode       — "fused" (default) or "legacy" (per-op host loop; oracle).
    sync_every — fused only: host-sync the device-resident residual every
                 k sweeps.  With k > 1 the loop may run up to k-1 sweeps
                 past convergence (the sign fixed point is stable, so extra
                 sweeps only polish); the traces stay complete.
    backend    — local stage of every multiply: "dense" | "stacks" |
                 "cuda" ("auto" is "dense" in the fused sweep).
    storage_dtype — reduced-precision block storage for the whole chain:
                 X and I are quantized once after the spectral scale, with
                 norms recalibrated; every multiply accumulates in f32.

    ``mesh`` other than None raises: the sharded chain is a later slice.
    """
    if mode == "legacy":
        return sign_iteration_legacy(
            x0, mesh=mesh, threshold=threshold, filter_eps=filter_eps,
            max_iter=max_iter, tol=tol, backend=backend,
            storage_dtype=storage_dtype,
        )
    if mode != "fused":
        raise ValueError(f"unknown mode {mode!r}; 'fused' or 'legacy'")
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    _check_single_device(mesh)
    nb, bs = x0.nb_r, x0.bs_r
    ident = B.identity(nb, bs, x0.dtype, device=x0.device)
    x = _scale_to_unit_spectrum(x0)
    if storage_dtype is not None:
        x = B.cast_bsm(x, storage_dtype)
        ident = B.cast_bsm(ident, storage_dtype)

    chain_misses0 = plan_mod.cache_stats()["chain_misses"]
    xb, xm, xn = x.blocks, x.mask, x.norms
    ib, im = ident.blocks, ident.mask
    occ_trace: list[float] = []
    res_trace: list[float] = []
    pending: list[tuple] = []
    converged = False
    syncs = 0
    it = 0
    for it in range(1, max_iter + 1):
        # fetched per sweep: the chain counters then record how many sweeps
        # reused one program
        sweep = get_sweep_program(x, threshold=threshold,
                                  filter_eps=filter_eps, backend=backend)
        xb, xm, xn, res_d, occ_d = sweep(xb, xm, xn, ib, im)
        pending.append((res_d, occ_d))
        if it % sync_every == 0 or it == max_iter:
            syncs += 1
            for res_d, occ_d in pending:
                r = float(res_d)
                res_trace.append(r)
                occ_trace.append(float(occ_d))
                if r < tol:
                    converged = True
            pending = []
            if converged:
                break

    stats = SignIterStats(
        iterations=it,
        converged=converged,
        residual=res_trace[-1] if res_trace else float("inf"),
        occupancy_trace=occ_trace,
        multiplications=2 * it,
        residual_trace=res_trace,
        mode="fused",
        sync_every=sync_every,
        host_syncs=syncs,
        retraces=plan_mod.cache_stats()["chain_misses"] - chain_misses0,
    )
    return B.BlockSparseMatrix(blocks=xb, mask=xm, norms=xn), stats


def density_matrix(
    h: B.BlockSparseMatrix,
    mu: float,
    *,
    mesh=None,
    threshold: float = 0.0,
    filter_eps: float = 0.0,
    max_iter: int = 60,
    tol: float = 1e-6,
    mode: str = "fused",
    sync_every: int = 1,
    backend: str = "dense",
    storage_dtype: torch.dtype | None = None,
) -> tuple[B.BlockSparseMatrix, SignIterStats]:
    """P = 1/2 (I - sign(H - mu I))  (paper Eq. (1) with S = I)."""
    ident = B.identity(h.nb_r, h.bs_r, h.dtype, device=h.device)
    shifted = B.add(h, B.scale(ident, -mu))
    sgn, stats = sign_iteration(
        shifted, mesh=mesh, threshold=threshold,
        filter_eps=filter_eps, max_iter=max_iter, tol=tol, mode=mode,
        sync_every=sync_every, backend=backend, storage_dtype=storage_dtype,
    )
    if sgn.dtype != ident.dtype:  # projector algebra in storage dtype
        ident = B.cast_bsm(ident, sgn.dtype)
    p = B.scale(B.add(ident, B.scale(sgn, -1.0)), 0.5)
    return p, stats


def trace(m: B.BlockSparseMatrix) -> torch.Tensor:
    """Trace over the occupied diagonal blocks (a device scalar)."""
    idx = torch.arange(min(m.nb_r, m.nb_c), device=m.device)
    tr = torch.diagonal(m.blocks[idx, idx], dim1=-2, dim2=-1).sum(-1)
    return torch.sum(tr * m.mask[idx, idx])
