"""Matrix-sign iteration — the paper's driving application (linear-scaling
DFT density-matrix purification, Eqs. (1)-(3)); the torch twin of
``repro/core/signiter.py``.

    sign(A) = A (A^2)^{-1/2};   X_{n+1} = 1/2 X_n (3 I - X_n^2)

Each iteration is two block-sparse multiplications with on-the-fly and
post-multiplication filtering.

``fused`` (default) — one sweep (X², post-filter, 3I − X², X·Y,
    post-filter, the 0.5 scale, residual and occupancy) is one cached
    function (``plan.get_chain_program``) over rank lists.  On one device
    the list holds one shard and the multiply is ``local_filtered_mm``.
    With a mesh (``launch/mesh.py``) X is sharded once at the chain
    boundary (``bsm.shard_bsm``); each multiply is the engine's body over
    the ranks (``plan.build_shard_body``), the algebra between the two
    multiplies runs rank-local, and the three convergence partials
    (residual numerator, denominator, occupancy count) are summed over the
    ranks once per sweep (``transport.psum``, the reference's one psum).
    Residual and occupancy stay device scalars until every
    ``sync_every``-th sweep.  Each local multiply compacts its pattern at
    the exact bucketed capacity, where the reference traces the sweep once
    at full-cube capacity; padding adds nothing, so the numbers are the
    same.  Reading the product count costs one sync per local multiply
    (three with the CUDA kernel's group masks); capturing the sweep in a
    CUDA graph is later work.

    Under a pattern envelope (``envelope=``, ``core/envelope.py``: forecast
    once from the chain's entering pattern) every local multiply compacts
    at the envelope's capacity instead (no count to read: two syncs per
    CUDA-kernel multiply), so the product list keeps one shape for the
    whole chain, and a non-dense ``transport=`` becomes available with
    packing capacities that cover every sweep.  ``assignment=`` shards the
    chain once under a block->rank permutation; sign(P X P^T) =
    P sign(X) P^T and P I P^T = I, so every sweep runs in the permuted
    layout and the exit boundary undoes it.

``legacy`` — the host-driven loop: each multiply re-enters ``multiply()``
    from replicated matrices (sharded and gathered per multiply on a
    mesh), the algebra between multiplies runs as separate operations, and
    the residual syncs every sweep.  Kept as the parity oracle.

``density_matrix`` evaluates P = 1/2 (I - sign(H - mu I)) (paper Eq. (1),
S = I); trace(P) = #{eigenvalues < mu} is the convergence observable.  A
sharded H stays sharded to the chain boundary.

``engine="auto"`` on a mesh is one tuner decision per chain
(``tuner.autotune(x, x, mesh, chain=True)`` on the finalized operand:
chain-safe candidates only, or the whole space under an envelope); the
chain keeps the caller's backend and runs the chosen engine and depth.
``backend="auto"`` under an envelope is the tuner's
``choose_local_backend`` on the envelope's fill; the operand's device
picks the compacted flavour (``cuda`` or ``stacks``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch.core import bsm as B
from repro_torch.core import plan as plan_mod
from repro_torch.core import transport as T
from repro_torch.core.bsm import block_norms
from repro_torch.core.engine import _envelope_transport, multiply
from repro_torch.core.local_mm import local_filtered_mm
from repro_torch.obs import span


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
    envelope: bool = False  # the chain ran against a pattern envelope
    forecast_s: float = 0.0  # host seconds getting the envelope ("auto")
    engine: str = ""  # the engine the chain ran ("auto" resolved)
    l: int | None = None  # and its depth


def _resolve_engine(x, mesh, engine: str, threshold: float,
                    l: int | None, envelope=None) -> tuple[str, int | None]:
    """``engine="auto"`` for a chain: ONE tuner decision on the chain's
    operand (X . X, the purification's own multiply), then every sweep
    runs the chosen (engine, L).  ``chain=True`` keeps to chain-safe
    candidates (dense local stage, dense panels): a capacity taken from
    the first pattern could drop fill-in mid-chain.  Under ``envelope``
    the capacities come from the forecast cube, so the whole space is
    ranked.  Vestigial on one device."""
    if engine != "auto":
        return engine, l
    if mesh is None:
        return "twofive", l
    from repro_torch import tuner

    dec = tuner.autotune(x, x, mesh, threshold=threshold, l=l, chain=True,
                         envelope=envelope)
    return dec.engine, dec.l


def _scale_to_unit_spectrum(x):
    """Scale X0 so its spectrum lies in [-1, 1] (Frobenius bound)."""
    s = 1.0 / torch.clamp(x.frobenius_norm(), min=1e-30)
    if isinstance(x, B.ShardedBSM):
        return x.scale(s)
    return B.scale(x, s)


# ---------------------------------------------------------------------------
# the fused sweep
# ---------------------------------------------------------------------------


def _make_sweep(mm, reduce, filter_eps: float, *, total_blocks: int):
    """One whole Newton-Schulz sweep as a single function over rank lists.

    ``mm(ab, am, an, bb, bm, bn) -> (cb, cm)`` is the multiply over the
    rank lists (the engine's body, or ``local_filtered_mm`` on a list of
    one); ``reduce`` sums the per-rank convergence partials over the
    ranks (``transport.psum``; the identity for one rank).  Everything
    between the two multiplies is rank-local block algebra with
    incrementally-updated norms; the residual and occupancy leave as
    device scalars.
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
        yb, ym, yn = [], [], []
        for r in range(len(xb)):
            b, m, _ = post_filter(x2b[r], x2m[r], block_norms(x2b[r]))
            # Y = 3I - X^2, norms from the new blocks
            y = ib[r] * 3.0 - b  # 3 and 1/2 are exact in every storage dtype
            yb.append(y)
            ym.append(im[r] | m)
            yn.append(block_norms(y))
        del x2b, x2m
        # X . Y (multiply 2) + post-filter + the 1/2 scale (derived norms)
        cb, cm = mm(xb, xm, xn, yb, ym, yn)
        del yb, ym, yn
        out_b, out_m, out_n, partials = [], [], [], []
        for r in range(len(xb)):
            b, m, nn = post_filter(cb[r], cm[r], block_norms(cb[r]))
            b = b * 0.5
            nn = nn * 0.5
            # convergence: || X_{n+1} - X_n ||_F / || X_{n+1} ||_F, as
            # per-rank partial sums (and the occupied-block count)
            partials.append(torch.stack([
                torch.sum(torch.square((b - xb[r]).to(torch.float32))),
                torch.sum(torch.square(nn)),
                m.to(torch.float32).sum(),
            ]))
            out_b.append(b)
            out_m.append(m)
            out_n.append(nn)
        num_sq, den_sq, occ_cnt = reduce(partials)[0]
        residual = torch.sqrt(num_sq) / torch.clamp(torch.sqrt(den_sq),
                                                    min=1e-30)
        occupancy = occ_cnt / total_blocks
        return out_b, out_m, out_n, residual, occupancy

    return sweep


def _envelope_statics(env, x, mesh, engine: str, l: int | None,
                      backend: str, stack_capacity: int | None, transport):
    """(backend, product-list capacity, transport) of chain operand ``x``
    under envelope ``env``: ``"auto"`` resolved by the tuner's analytic
    crossover on the envelope's fill (``x``'s device picks ``cuda`` or
    ``stacks``), the envelope's capacity for a compacted backend left
    without one, and the transport resolved on the envelope's mask
    unions."""
    if backend == "auto":
        from repro_torch.tuner.model import choose_local_backend

        backend = choose_local_backend(
            x.nb_r, x.nb_c, x.nb_c, x.bs_r, x.bs_c, x.bs_c,
            fill=float(env.cube.mean()), device=x.device)
    if stack_capacity is None and backend in ("stacks", "cuda"):
        stack_capacity = (env.local_capacity() if mesh is None
                          else env.device_capacity(mesh, engine))
    if mesh is not None:  # a chain's None is dense, not the configured mode
        transport = _envelope_transport(env.mask_a, env.mask_b,
                                        transport or "dense", mesh, engine, l)
    return backend, stack_capacity, transport


def get_sweep_program(x, mesh=None, *, engine: str = "twofive",
                      threshold: float, filter_eps: float, backend: str,
                      l: int | None = None, stack_capacity: int | None = None,
                      envelope=None, transport=None,
                      tile: tuple[int, int] | None = None):
    """The fused sweep for (mesh, engine, L, shape, dtype, device,
    thresholds, backend, capacity, group layout, transport), cached in the
    plan layer (``chain_hits`` / ``chain_misses``).  It takes and returns
    rank lists: one shard per rank of ``mesh``, or a list of one with no
    mesh.

    Without ``envelope``, ``backend="auto"`` becomes ``dense`` as in the
    reference's fused sweep (one sweep serves the whole evolving pattern;
    resolve "auto" against a concrete pattern before the chain, as
    ``launch/purify.py`` does), and the panel transport is pinned dense: a
    packing capacity taken from the first pattern would drop fill-in
    blocks mid-iteration, so a non-dense ``transport`` raises.

    With an ``envelope.Envelope``: a compacted backend without
    ``stack_capacity`` takes the envelope's (``local_capacity`` on one
    device, ``device_capacity`` on a mesh), and a non-dense transport
    ("auto" / "compressed") resolves its per-panel capacities from the
    envelope's operand-mask unions — both sound for every sweep the
    envelope covers.  ``backend="auto"`` there is the tuner's
    ``choose_local_backend`` on the envelope's fill.  ``tile`` is the
    ``cuda`` kernel's group layout (None the default).
    """
    if engine == "auto":
        raise ValueError("resolve engine='auto' before building a chain "
                         "program (sign_iteration does, through the tuner)")
    if envelope is not None:
        backend, stack_capacity, transport = _envelope_statics(
            envelope, x, mesh, engine, l, backend, stack_capacity,
            transport)
    else:
        if backend == "auto":
            backend = "dense"
        if (transport not in (None, "dense")
                and getattr(transport, "mode", None) != "dense"):
            raise ValueError(
                "non-dense chain transport needs an envelope: a packing "
                "capacity derived from the first pattern would drop "
                "fill-in panels mid-iteration (core/envelope.py)"
            )
        transport = None
    if mesh is None or transport == T.DENSE:
        transport = None
    where = mesh if mesh is not None else str(x.device)
    key = ("signiter", where, engine if mesh is not None else None, l,
           x.nb_r, x.nb_c, x.bs_r, x.bs_c, str(x.dtype), float(threshold),
           float(filter_eps), backend, stack_capacity,
           None if tile is None else tuple(tile))
    if transport is not None:
        key += (transport.key,)
    total_blocks = x.nb_r * x.nb_c

    def make_program():
        if mesh is None:
            def mm(ab, am, an, bb, bm, bn):
                c = local_filtered_mm(ab[0], am[0], an[0], bb[0], bm[0],
                                      bn[0], threshold=threshold,
                                      backend=backend,
                                      stack_capacity=stack_capacity,
                                      tile=tile)
                return [c[0]], [c[1]]

            return _make_sweep(mm, lambda ps: ps, filter_eps,
                               total_blocks=total_blocks)
        plan = plan_mod.plan_multiply(mesh, engine, l)
        plan.validate_blocks(x.nb_r, x.nb_c)
        mm = plan_mod.build_shard_body(plan, threshold=threshold,
                                       backend=backend,
                                       stack_capacity=stack_capacity,
                                       transport=transport, tile=tile)
        return _make_sweep(mm, lambda ps: T.psum(mesh, ps, ("r", "c")),
                           filter_eps, total_blocks=total_blocks)

    return plan_mod.get_chain_program(key, make_program)


# ---------------------------------------------------------------------------
# iteration loops
# ---------------------------------------------------------------------------


def sign_iteration_legacy(
    x0: B.BlockSparseMatrix,
    *,
    mesh=None,
    engine: str = "twofive",
    threshold: float = 0.0,
    filter_eps: float = 0.0,
    max_iter: int = 50,
    tol: float = 1e-6,
    scale_input: bool = True,
    backend: str = "dense",
    l: int | None = None,
    storage_dtype: torch.dtype | None = None,
    tile: tuple[int, int] | None = None,
    assignment=None,
) -> tuple[B.BlockSparseMatrix, SignIterStats]:
    """The host-driven per-op loop (parity oracle): two ``multiply()``
    re-entries per sweep from replicated matrices (on ``mesh`` with
    ``engine`` and ``assignment`` when given), eager algebra between them,
    a host residual sync every sweep.  ``engine="auto"`` is resolved once,
    on the entering pattern; ``scale_input=False`` iterates on ``x0`` as
    given (its spectrum already in [-1, 1])."""
    engine, l = _resolve_engine(x0, mesh, engine, threshold, l)
    nb, bs = x0.nb_r, x0.bs_r
    ident = B.identity(nb, bs, x0.dtype, device=x0.device)
    x = _scale_to_unit_spectrum(x0) if scale_input else x0
    if storage_dtype is not None:
        # cast AFTER the spectral scale; norms recalibrated (bsm.astype)
        x = B.cast_bsm(x, storage_dtype)
        ident = B.cast_bsm(ident, storage_dtype)
    occ, res_trace = [], []
    n_mults = 0
    converged = False
    residual = float("inf")
    misses0 = plan_mod.cache_stats()["pattern_misses"]
    mm_kw = dict(engine=engine, threshold=threshold, filter_eps=filter_eps,
                 backend=backend, l=l, tile=tile, assignment=assignment)
    it = 0
    for it in range(1, max_iter + 1):
        x2 = multiply(x, x, mesh, **mm_kw)
        n_mults += 1
        # 3I - X^2
        y = B.add(B.scale(x2, -1.0), B.scale(ident, 3.0))
        xn = multiply(x, y, mesh, **mm_kw)
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
        engine=engine,
        l=l,
    )
    return x, stats


def sign_iteration(
    x0: B.BlockSparseMatrix | B.ShardedBSM,
    *,
    mesh=None,
    engine: str = "twofive",
    threshold: float = 0.0,
    filter_eps: float = 0.0,
    max_iter: int = 50,
    tol: float = 1e-6,
    scale_input: bool = True,
    mode: str = "fused",
    sync_every: int = 1,
    backend: str = "dense",
    l: int | None = None,
    stack_capacity: int | None = None,
    storage_dtype: torch.dtype | None = None,
    tile: tuple[int, int] | None = None,
    assignment=None,
    envelope=None,
    transport=None,
) -> tuple[B.BlockSparseMatrix | B.ShardedBSM, SignIterStats]:
    """Newton-Schulz iteration X <- 1/2 X (3I - X^2) to sign(x0).

    scale_input — scale X0 by 1 / ||X0||_F first, so its spectrum lies in
                 [-1, 1]; False iterates on ``x0`` as given.

    mode       — "fused" (default) or "legacy" (per-op host loop; oracle).
    sync_every — fused only: host-sync the device-resident residual every
                 k sweeps.  With k > 1 the loop may run up to k-1 sweeps
                 past convergence (the sign fixed point is stable, so extra
                 sweeps only polish); the traces stay complete.
    backend    — local stage of every multiply: "dense" | "stacks" |
                 "cuda" ("auto" is "dense" in the fused sweep without an
                 envelope, the tuner's ``choose_local_backend`` under one).
    stack_capacity — product-list bound of the compacted backends, used
                 as given; None takes the envelope's under an envelope,
                 else each local multiply's exact bucketed count.
    tile       — the ``cuda`` kernel's group layout (None the default).
    engine, l  — the distributed engine on ``mesh`` (and the pull
                 engine's depth); vestigial without a mesh.  "auto" on a
                 mesh is one tuner decision for the chain
                 (``_resolve_engine``).
    storage_dtype — reduced-precision block storage for the whole chain:
                 X and I are quantized once after the spectral scale, with
                 norms recalibrated; every multiply accumulates in f32.
    envelope   — fused only: None, ``"auto"`` (forecast here from the
                 finalized operand by ``plan.get_envelope`` with
                 ``sweeps=max_iter``: one host copy of its mask and norms)
                 or an ``envelope.Envelope``.  The local stage compacts at
                 the envelope's capacity, and a non-dense ``transport``
                 takes its capacities from the envelope (see
                 ``get_sweep_program``).
    transport  — fused only: panel transport of the sweep's multiplies on
                 a mesh ("auto" | "dense" | "compressed" or a
                 ``PanelTransport``; None is dense).  Non-dense needs an
                 envelope.
    assignment — the block->rank distribution of the WHOLE chain, resolved
                 once at the shard boundary (None / a mode string / a
                 ``distribute.Assignment``; see ``bsm.shard_bsm``).  Needs
                 a mesh.

    A ShardedBSM ``x0`` stays sharded end to end (under its own carried
    assignment; a conflicting ``assignment`` raises) and the result is a
    ShardedBSM; a BlockSparseMatrix with ``mesh`` given is sharded once at
    entry and gathered once at exit (the chain boundaries).  The legacy
    loop takes replicated matrices only.
    """
    sharded_in = isinstance(x0, B.ShardedBSM)
    if sharded_in:
        if mesh is not None and mesh != x0.mesh:
            raise ValueError("mesh argument conflicts with operand mesh")
        mesh = x0.mesh
    if mode == "legacy":
        if sharded_in:
            raise TypeError("legacy mode operates on replicated matrices; "
                            "unshard first (bsm.unshard_bsm)")
        if envelope is not None or transport is not None:
            raise ValueError(
                "envelope/transport are fused-chain controls; the legacy "
                "loop re-enters multiply() per pattern")
        return sign_iteration_legacy(
            x0, mesh=mesh, engine=engine, threshold=threshold,
            filter_eps=filter_eps, max_iter=max_iter, tol=tol,
            scale_input=scale_input, backend=backend, l=l,
            storage_dtype=storage_dtype, tile=tile, assignment=assignment,
        )
    if mode != "fused":
        raise ValueError(f"unknown mode {mode!r}; 'fused' or 'legacy'")
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    if sharded_in and assignment is not None and (
            getattr(assignment, "mode", assignment)
            != B._assign_name(x0.assignment)):
        raise ValueError(
            f"operand is sharded under assignment "
            f"{B._assign_name(x0.assignment)}; unshard before iterating "
            "under a different layout")
    nb, bs = x0.nb_r, x0.bs_r
    if mesh is not None:
        # one layout decision for the whole chain, made at the shard
        # boundary; the identity inherits it (P I P^T = I)
        x = B.shard_bsm(x0, mesh, assignment=assignment)
        ident = B.sharded_identity(nb, bs, mesh, x0.dtype,
                                   assignment=x.assignment)
    else:
        if assignment not in (None, "identity"):
            raise ValueError("assignment needs a mesh: a block->rank "
                             "distribution has no meaning on one device")
        x = x0
        ident = B.identity(nb, bs, x0.dtype, device=x0.device)
    if scale_input:
        x = _scale_to_unit_spectrum(x)
    if storage_dtype is not None:
        x = B.cast_bsm(x, storage_dtype)
        ident = B.cast_bsm(ident, storage_dtype)
    env, forecast_s = envelope, 0.0
    if env is True or env == "auto":
        # forecast from the FINALIZED operand (scaled, cast, in the chain's
        # layout): its norm bounds must dominate the norms the filters see
        t0 = time.perf_counter()
        norms = x.gather(x.norms) if mesh is not None else x.norms
        env = plan_mod.get_envelope(
            B.host_mask(x), B.host_array(norms), sweeps=max_iter,
            threshold=threshold, filter_eps=filter_eps, bs=x.bs_r)
        forecast_s = time.perf_counter() - t0
    # the engine is resolved on the finalized operand and the envelope:
    # with one, the tuner ranks the whole candidate space
    engine, l = _resolve_engine(x, mesh, engine, threshold, l, envelope=env)
    if env is not None:  # resolved once: the cube's digest is not free
        backend, stack_capacity, transport = _envelope_statics(
            env, x, mesh, engine, l, backend, stack_capacity, transport)

    def ranks(m):
        if mesh is None:
            return [m.blocks], [m.mask], [m.norms]
        return m.blocks, m.mask, m.norms

    chain_misses0 = plan_mod.cache_stats()["chain_misses"]
    xb, xm, xn = ranks(x)
    ib, im, _ = ranks(ident)
    occ_trace: list[float] = []
    res_trace: list[float] = []
    pending: list[tuple] = []
    converged = False
    syncs = 0
    it = 0
    for it in range(1, max_iter + 1):
        # fetched per sweep: the chain counters then record how many sweeps
        # reused one program
        sweep = get_sweep_program(x, mesh, engine=engine, threshold=threshold,
                                  filter_eps=filter_eps, backend=backend, l=l,
                                  stack_capacity=stack_capacity,
                                  envelope=env, transport=transport,
                                  tile=tile)
        with span("repro.signiter.sweep"):
            xb, xm, xn, res_d, occ_d = sweep(xb, xm, xn, ib, im)
        pending.append((res_d, occ_d))
        if it % sync_every == 0 or it == max_iter:
            syncs += 1
            with span("repro.signiter.sync"):
                for res_d, occ_d in pending:
                    r = float(res_d)
                    res_trace.append(r)
                    occ_trace.append(float(occ_d))
                    if r < tol:
                        converged = True
            pending = []
            if converged:
                break

    if mesh is not None:
        out = B.ShardedBSM(tuple(xb), tuple(xm), tuple(xn), mesh,
                           x.assignment)
        result = out if sharded_in else out.unshard()
    else:
        result = B.BlockSparseMatrix(blocks=xb[0], mask=xm[0], norms=xn[0])
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
        envelope=env is not None,
        forecast_s=forecast_s,
        engine=engine,
        l=l,
    )
    return result, stats


def density_matrix(
    h: B.BlockSparseMatrix | B.ShardedBSM,
    mu: float,
    *,
    mesh=None,
    engine: str = "twofive",
    threshold: float = 0.0,
    filter_eps: float = 0.0,
    max_iter: int = 60,
    tol: float = 1e-6,
    mode: str = "fused",
    sync_every: int = 1,
    backend: str = "dense",
    l: int | None = None,
    storage_dtype: torch.dtype | None = None,
    tile: tuple[int, int] | None = None,
    assignment=None,
    envelope=None,
    transport=None,
) -> tuple[B.BlockSparseMatrix | B.ShardedBSM, SignIterStats]:
    """P = 1/2 (I - sign(H - mu I))  (paper Eq. (1) with S = I).  The shift,
    the sign iteration and the projector run where ``h`` lives: a
    ShardedBSM H gives a ShardedBSM P with no gather in between, under H's
    assignment.  ``tile``, ``assignment``, ``envelope`` and
    ``transport`` are ``sign_iteration``'s (``engine="auto"`` too)."""
    if isinstance(h, B.ShardedBSM):
        ident = B.sharded_identity(h.nb_r, h.bs_r, h.mesh, h.dtype,
                                   assignment=h.assignment)
        shifted = ident.scale(-mu).add(h)
    else:
        ident = B.identity(h.nb_r, h.bs_r, h.dtype, device=h.device)
        shifted = B.add(h, B.scale(ident, -mu))
    sgn, stats = sign_iteration(
        shifted, mesh=mesh, engine=engine, threshold=threshold,
        filter_eps=filter_eps, max_iter=max_iter, tol=tol, mode=mode,
        sync_every=sync_every, backend=backend, l=l,
        storage_dtype=storage_dtype, tile=tile, assignment=assignment,
        envelope=envelope, transport=transport,
    )
    if sgn.dtype != ident.dtype:  # projector algebra in storage dtype
        ident = B.cast_bsm(ident, sgn.dtype)
    if isinstance(sgn, B.ShardedBSM):
        p = sgn.scale(-1.0).add(ident).scale(0.5)
    else:
        p = B.scale(B.add(ident, B.scale(sgn, -1.0)), 0.5)
    return p, stats


def trace(m: B.BlockSparseMatrix | B.ShardedBSM) -> torch.Tensor:
    """Trace over the occupied diagonal blocks (a device scalar)."""
    if isinstance(m, B.ShardedBSM):
        return m.trace()
    idx = torch.arange(min(m.nb_r, m.nb_c), device=m.device)
    tr = torch.diagonal(m.blocks[idx, idx], dim1=-2, dim2=-1).sum(-1)
    return torch.sum(tr * m.mask[idx, idx])
