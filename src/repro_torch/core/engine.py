"""The public ``multiply`` entry point — the torch twin of
``repro/core/engine.py``.

Local backends (``core/local_mm.py``): ``dense`` masked contraction,
``stacks`` compacted gather-GEMM-scatter, ``cuda`` the hand-written Hopper
kernel — plus ``"auto"``, the occupancy-driven choice: the exact
surviving-product fill of the concrete pattern picks the compacted
backends below ``AUTO_DENSE_FILL``.

``multiply_reference`` implements the filtered semantics on one device and
is the oracle.  The compacted path runs through the plan layer's
pattern-signature cache (``plan.get_product_stacks``): a repeated pattern
reuses its product list.

With a mesh (``launch/mesh.py``) the multiply runs one of the paper's
engines over the mesh's ranks (``plan.execute``): ``cannon`` (PTP,
Algorithm 1), ``onesided`` (OS1), ``gather`` (all-gather pull) and
``twofive`` (OSL, Algorithm 2: the pull body on a 2D mesh, the stacked
body on an (l, r, c) mesh).  ``ShardedBSM`` operands stay sharded
(``plan.execute_sharded``).  Panels move dense or occupancy-compressed
(``transport=``, ``core/transport.py``), under a block->rank assignment
(``assignment=``, ``core/distribute.py``), and a pattern envelope
(``envelope=``, ``core/envelope.py``) can stand in for the call's own
pattern when capacities are derived.  ``engine="auto"`` with a mesh hands
the whole decision (engine, depth, backend, capacity, transport, group
layout, assignment) to the tuner (``repro_torch.tuner.autotune``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core import transport as T
from repro_torch.core.bsm import (
    BlockSparseMatrix,
    ShardedBSM,
    block_norms,
    filter_bsm,
    host_mask,
)
from repro_torch.core.local_mm import (
    GATHER_OVERHEAD,
    backend_local_cost,
    local_filtered_mm,
)
from repro_torch.kernels.stacks import pair_cube

ENGINES = ("cannon", "onesided", "gather", "twofive")

# surviving-product fill at which the dense contraction and the compacted
# backends break even under the shared analytic model
AUTO_DENSE_FILL = 1.0 / GATHER_OVERHEAD


def _pair_filter(a: BlockSparseMatrix, b: BlockSparseMatrix,
                 threshold: float) -> torch.Tensor:
    """(i, k, j) filter cube on the operands' device."""
    return pair_cube(a.mask, b.mask, a.norms, b.norms, threshold)


def _host_pair_filter(a, b, threshold: float, *, host=None) -> np.ndarray:
    """Concrete (i, k, j) filter cube on the host (numpy), from one host
    copy of each operand's mask and norms (a ``ShardedBSM``'s gathered
    home layout).  ``host`` — ``(mask_a, norms_a, mask_b, norms_b)`` when
    the caller already holds them."""
    if host is None:
        from repro_torch.core.bsm import host_mask, host_norms

        host = (host_mask(a), host_norms(a), host_mask(b), host_norms(b))
    am, an, bm, bn = host
    ok = np.asarray(am, bool)[:, :, None] & np.asarray(bm, bool)[None, :, :]
    if threshold > 0.0:
        an = np.asarray(an, np.float32)
        bn = np.asarray(bn, np.float32)
        ok &= an[:, :, None] * bn[None, :, :] > threshold
    return ok


def choose_backend(a: BlockSparseMatrix, b: BlockSparseMatrix,
                   threshold: float = 0.0, *, ok=None) -> str:
    """Cost-model-driven local-backend selection (the ``"auto"`` policy):
    ``dense`` when the full-cube work undercuts the compacted path's
    gathered products, else the compacted flavour of the operands' device —
    the CUDA kernel on a CUDA device (where the reference picks ``pallas``
    on a TPU), ``stacks`` on the CPU.

    ``ok`` — optional precomputed filter cube (a tensor, or a numpy cube
    such as an envelope's).
    """
    if ok is None:
        ok = _pair_filter(a, b, threshold)
    if isinstance(ok, torch.Tensor):
        fill = float(ok.float().mean()) if ok.numel() else 0.0
    else:
        fill = float(np.mean(ok)) if np.size(ok) else 0.0
    dims = (a.nb_r, a.nb_c, b.nb_c, a.bs_r, a.bs_c, b.bs_c)
    dense = backend_local_cost(*dims, fill=1.0, backend="dense",
                               dtype=a.dtype)
    compact = backend_local_cost(*dims, fill=fill, backend="stacks",
                                 dtype=a.dtype)
    if dense <= compact:
        return "dense"
    return "cuda" if a.device.type == "cuda" else "stacks"


def _reference_compacted(
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    threshold: float,
    backend: str,
    ok: torch.Tensor | None = None,
    tile: tuple[int, int] | None = None,
) -> BlockSparseMatrix:
    """Single-device stacks/cuda path over the plan layer's pattern cache:
    compaction at the exact bucketed capacity, product list cached per
    pattern signature; ``tile`` is the kernel's group layout."""
    from repro_torch.core.local_mm import stacks_mm
    from repro_torch.kernels.block_spgemm import block_spgemm_stacks

    if ok is None:
        ok = _pair_filter(a, b, threshold)
    ni, _nk, nj = ok.shape
    stacks, _n = plan_mod.get_product_stacks(ok)
    cm = ok.any(dim=1)
    # both start from zero, so tiles without a survivor are already zero
    # (the reference zeroes them here: its Pallas grid never visits them)
    if backend == "cuda":
        cb = block_spgemm_stacks(a.blocks, b.blocks, stacks, ni=ni, nj=nj,
                                 group=tile)
    else:
        cb = stacks_mm(a.blocks, b.blocks, stacks, ni=ni, nj=nj)
    return BlockSparseMatrix(blocks=cb, mask=cm, norms=block_norms(cb))


def multiply_reference(
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    threshold: float = 0.0,
    backend: str = "dense",
    *,
    stack_capacity: int | None = None,
    ok: torch.Tensor | None = None,
    tile: tuple[int, int] | None = None,
) -> BlockSparseMatrix:
    """Single-device filtered block multiply (oracle).

    ``ok`` — optional precomputed filter cube; one derivation then serves
    backend choice, compaction and the C mask.  ``tile`` — the ``cuda``
    kernel's group layout (None the default).
    """
    if backend == "auto":
        if ok is None:
            ok = _pair_filter(a, b, threshold)
        backend = choose_backend(a, b, threshold, ok=ok)
    if backend in ("stacks", "cuda") and stack_capacity is None:
        return _reference_compacted(a, b, threshold, backend, ok, tile)
    cb, cm = local_filtered_mm(
        a.blocks, a.mask, a.norms, b.blocks, b.mask, b.norms,
        threshold=threshold, backend=backend, stack_capacity=stack_capacity,
        tile=tile,
    )
    return BlockSparseMatrix(blocks=cb, mask=cm, norms=block_norms(cb))


def multiply(
    a: BlockSparseMatrix | ShardedBSM,
    b: BlockSparseMatrix | ShardedBSM,
    mesh=None,
    *,
    engine: str = "twofive",
    threshold: float = 0.0,
    filter_eps: float | None = None,
    backend: str | None = None,
    c_layout: str = "2d",
    l: int | None = None,
    stack_capacity: int | None = None,
    tile: tuple[int, int] | None = None,
    transport=None,
    assignment=None,
    envelope=None,
) -> BlockSparseMatrix | ShardedBSM:
    """Filtered C = A . B, on one device or over a mesh of ranks.

    threshold  — on-the-fly filter: skip block products with
                 norm(A_ik) * norm(B_kj) <= threshold.
    filter_eps — post-multiplication filter: drop result blocks with
                 norm <= filter_eps (defaults to ``threshold``).
    backend    — local stage of every rank: "dense" | "stacks" | "cuda" |
                 "auto" (occupancy heuristic on the whole product, see
                 ``choose_backend``; "dense" for sharded operands, whose
                 pattern the reference does not walk); None is "dense",
                 as the reference's None is "jnp" — and, with
                 ``engine="auto"``, left to the tuner.
    c_layout   — stacked 2.5D only: "2d" or "scatter" (``twofive``).
    l          — depth of the 2D-mesh ``twofive`` pull engine on square
                 grids (non-square grids force L = mx/mn).
    stack_capacity — product bound for the compacted backends; derived
                 exactly from each local multiply's pattern when omitted.
    tile       — the ``cuda`` kernel's group layout ``(g_r, g_c)``
                 (``kernels.block_spgemm.kernel_tile``; None the default).
    transport  — panel transport on a mesh: a ``transport.PanelTransport``
                 or "auto" | "dense" | "compressed"; None is the configured
                 default (``REPRO_TRANSPORT``, else "auto").  "auto" packs
                 only occupied blocks when the bucketed capacities stay at
                 most a quarter of each panel, and ships dense panels
                 otherwise; compressed results equal dense ones bit for
                 bit.  Capacities come from the concrete masks
                 (``plan.get_transport``: one host copy of each mask).
    assignment — block->rank distribution on a mesh: None / "identity",
                 "randomized" | "nnz_greedy" (derived from the masks), or a
                 ``distribute.Assignment``.  Replicated operands are
                 permuted at the shard boundary and C comes back in
                 original block coordinates; sharded operands carry their
                 layout from ``shard_bsm`` and a value here can only
                 confirm it.  Needs a mesh.
    envelope   — an ``envelope.Envelope``: every pattern-dependent static
                 (product-list capacity, transport capacities, the
                 "auto" backend's fill) comes from the envelope instead of
                 this call's pattern.  The operands' masks are checked
                 against it (``Envelope.covers``, one host copy of each);
                 a pattern outside it runs the exact path and counts
                 ``drift_retunes``.

    With no mesh the engine is vestigial, as in the reference.
    ShardedBSM operands (both, on one mesh) run on their shards and come
    back sharded, post-filtered rank-local; replicated operands with a
    mesh are sharded once, multiplied and gathered.  ``engine="auto"``
    with a mesh is one ``tuner.autotune`` decision (cached on the
    pattern); for sharded operands it pins the identity assignment (the
    layout was chosen at ``shard_bsm``).
    """
    if engine != "auto" and engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; one of {ENGINES} or 'auto'"
        )
    env = envelope
    if env is not None:
        from repro_torch.core.envelope import Envelope

        if not isinstance(env, Envelope):
            raise TypeError(f"envelope must be an envelope.Envelope, not "
                            f"{type(env).__name__}")
        if not env.covers(host_mask(a), host_mask(b)):
            # the pattern drifted out of its envelope: derive everything
            # from this call's own pattern
            plan_mod.note_drift_retune()
            env = None
    sharded = isinstance(a, ShardedBSM) or isinstance(b, ShardedBSM)
    if sharded:
        if not (isinstance(a, ShardedBSM) and isinstance(b, ShardedBSM)):
            raise TypeError(
                "mixed ShardedBSM / BlockSparseMatrix operands; shard both "
                "(bsm.shard_bsm) or neither"
            )
        if a.mesh != b.mesh:
            raise ValueError("operands sharded on different meshes")
        if mesh is not None and mesh != a.mesh:
            raise ValueError("mesh argument conflicts with operand mesh")
        mesh = a.mesh
    elif mesh is None and assignment not in (None, "identity"):
        raise ValueError(
            "assignment needs a mesh: a block->rank distribution has no "
            "meaning on a single device"
        )
    if engine == "auto":
        if mesh is None:
            engine = "twofive"  # single device: the engine is vestigial
        else:
            from repro_torch.tuner import resolve_multiply

            # None: the caller left the backend open to the tuner
            engine, kw = resolve_multiply(
                a, b, mesh, threshold=threshold, backend=backend, l=l,
                stack_capacity=stack_capacity, tile=tile,
                transport=transport, assignment=assignment, envelope=env)
            return multiply(a, b, mesh, engine=engine,
                            filter_eps=filter_eps, c_layout=c_layout, **kw)
    # None: the caller left the backend open — "dense" for a named engine
    if backend is None:
        backend = "dense"
    eps = threshold if filter_eps is None else filter_eps
    if sharded:
        if backend == "auto":
            # without an envelope the heuristic would walk the pattern on
            # the host, a round trip the sharded path avoids
            backend = ("dense" if env is None
                       else choose_backend(a, b, threshold, ok=env.cube))
        if (backend in ("stacks", "cuda") and stack_capacity is None
                and env is not None):
            stack_capacity = plan_mod.get_device_capacity(env.cube, mesh,
                                                          engine)
        if env is not None:
            transport = _envelope_transport(env.mask_a, env.mask_b,
                                            transport, mesh, engine, l)
        c = plan_mod.execute_sharded(
            a, b, engine, threshold=threshold, backend=backend,
            c_layout=c_layout, l=l, stack_capacity=stack_capacity,
            transport=transport, assignment=assignment, tile=tile,
        )
        return c.filter(eps) if eps > 0.0 else c
    if backend == "auto":
        backend = choose_backend(a, b, threshold,
                                 ok=None if env is None else env.cube)
    compacted = backend in ("stacks", "cuda") and stack_capacity is None
    if mesh is None:
        if compacted and env is not None:
            # one capacity for the whole stream the envelope covers
            stack_capacity = env.local_capacity()
        c = multiply_reference(a, b, threshold=threshold, backend=backend,
                               stack_capacity=stack_capacity, tile=tile)
    else:
        asg = plan_mod.resolve_assignment(assignment, a, b, mesh)
        if env is not None:
            cube, em_a, em_b = env.cube, env.mask_a, env.mask_b
            if asg is not None:  # the layout the engine partitions
                from repro_torch.core.distribute import permute_cube

                p = np.asarray(asg.perm)
                cube = permute_cube(cube, p)
                em_a, em_b = em_a[p][:, p], em_b[p][:, p]
            if compacted:
                stack_capacity = plan_mod.get_device_capacity(cube, mesh,
                                                              engine)
            transport = _envelope_transport(em_a, em_b, transport, mesh,
                                            engine, l)
        c = plan_mod.execute(
            a, b, mesh, engine, threshold=threshold, backend=backend,
            c_layout=c_layout, l=l, stack_capacity=stack_capacity,
            transport=transport, assignment=asg, tile=tile,
        )
    if eps > 0.0:
        c = filter_bsm(c, eps)
    return c


def _envelope_transport(mask_a, mask_b, transport, mesh, engine: str,
                        l: int | None):
    """A transport spec resolved against ENVELOPE operand-mask unions:
    capacities that cover every panel of the stream the envelope covers,
    with no host copy of this call's masks.  A ``PanelTransport`` passes
    through."""
    if isinstance(transport, T.PanelTransport):
        return transport
    if transport is None:
        from repro_torch.config import transport_mode

        transport = transport_mode()
    if transport == "dense":
        return T.DENSE
    if transport not in ("auto", "compressed"):
        raise ValueError(
            f"unknown transport {transport!r}; a PanelTransport or one of "
            "auto | dense | compressed"
        )
    return plan_mod.get_transport(mask_a, mask_b, mesh, engine, l, transport)


def _transport_pin(transport) -> str | None:
    """The tuner constraint a caller's transport implies: an explicit mode
    (or a ready ``PanelTransport``'s) pins it, None / "auto" leave it to
    the tuner."""
    if isinstance(transport, T.PanelTransport):
        return transport.mode
    if transport in ("dense", "compressed"):
        return transport
    return None


def _assign_pin(assignment) -> str | None:
    """The tuner constraint a caller's assignment implies: an explicit
    mode (or a ready ``Assignment``'s) pins it, None leaves the layout to
    the tuner."""
    if assignment is None:
        return None
    return getattr(assignment, "mode", assignment)
