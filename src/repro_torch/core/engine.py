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
(``plan.execute_sharded``).  Still later slices, each raising
``NotImplementedError`` that names its ROADMAP.md Queue A item: the
compressed panel transport (item 8), block assignments (item 9), the
tuner behind ``engine="auto"`` with a mesh (item 10) and pattern envelopes
(item 11).
"""
from __future__ import annotations

import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core import transport as T
from repro_torch.core.bsm import (
    _ITEM_9,
    BlockSparseMatrix,
    ShardedBSM,
    block_norms,
    filter_bsm,
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

_ITEM_10 = ("engine='auto' with a mesh is the tuner, ROADMAP.md Queue A item "
            "10; name an engine")
_ITEM_11 = "pattern envelopes are ROADMAP.md Queue A item 11"


def _pair_filter(a: BlockSparseMatrix, b: BlockSparseMatrix,
                 threshold: float) -> torch.Tensor:
    """(i, k, j) filter cube on the operands' device."""
    return pair_cube(a.mask, b.mask, a.norms, b.norms, threshold)


def choose_backend(a: BlockSparseMatrix, b: BlockSparseMatrix,
                   threshold: float = 0.0, *, ok=None) -> str:
    """Cost-model-driven local-backend selection (the ``"auto"`` policy):
    ``dense`` when the full-cube work undercuts the compacted path's
    gathered products, else the compacted flavour of the operands' device —
    the CUDA kernel on a CUDA device (where the reference picks ``pallas``
    on a TPU), ``stacks`` on the CPU.

    ``ok`` — optional precomputed filter cube.
    """
    if ok is None:
        ok = _pair_filter(a, b, threshold)
    fill = float(ok.float().mean()) if ok.numel() else 0.0
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
) -> BlockSparseMatrix:
    """Single-device stacks/cuda path over the plan layer's pattern cache:
    compaction at the exact bucketed capacity, product list cached per
    pattern signature."""
    from repro_torch.core.local_mm import stacks_mm
    from repro_torch.kernels.block_spgemm import block_spgemm_stacks

    if ok is None:
        ok = _pair_filter(a, b, threshold)
    ni, _nk, nj = ok.shape
    stacks, _n = plan_mod.get_product_stacks(ok)
    cm = ok.any(dim=1)
    mm = block_spgemm_stacks if backend == "cuda" else stacks_mm
    # both start from zero, so tiles without a survivor are already zero
    # (the reference zeroes them here: its Pallas grid never visits them)
    cb = mm(a.blocks, b.blocks, stacks, ni=ni, nj=nj)
    return BlockSparseMatrix(blocks=cb, mask=cm, norms=block_norms(cb))


def multiply_reference(
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    threshold: float = 0.0,
    backend: str = "dense",
    *,
    stack_capacity: int | None = None,
    ok: torch.Tensor | None = None,
) -> BlockSparseMatrix:
    """Single-device filtered block multiply (oracle).

    ``ok`` — optional precomputed filter cube; one derivation then serves
    backend choice, compaction and the C mask.
    """
    if backend == "auto":
        if ok is None:
            ok = _pair_filter(a, b, threshold)
        backend = choose_backend(a, b, threshold, ok=ok)
    if backend in ("stacks", "cuda") and stack_capacity is None:
        return _reference_compacted(a, b, threshold, backend, ok)
    cb, cm = local_filtered_mm(
        a.blocks, a.mask, a.norms, b.blocks, b.mask, b.norms,
        threshold=threshold, backend=backend, stack_capacity=stack_capacity,
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
                 as the reference's None is "jnp".
    c_layout   — stacked 2.5D only: "2d" or "scatter" (``twofive``).
    l          — depth of the 2D-mesh ``twofive`` pull engine on square
                 grids (non-square grids force L = mx/mn).
    stack_capacity — product bound for the compacted backends; derived
                 exactly from each local multiply's pattern when omitted.
    transport  — None / "auto" / "dense": dense panels (the port's only
                 mode; "compressed" raises, item 8).

    With no mesh the engine is vestigial, as in the reference.
    ShardedBSM operands (both, on one mesh) run on their shards and come
    back sharded, post-filtered rank-local; replicated operands with a
    mesh are sharded once, multiplied and gathered.  ``assignment``
    other than None / "identity", ``envelope`` and ``engine="auto"`` with
    a mesh raise ``NotImplementedError``.
    """
    if engine != "auto" and engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; one of {ENGINES} or 'auto'"
        )
    if envelope is not None:
        raise NotImplementedError(_ITEM_11)
    if assignment not in (None, "identity"):
        raise NotImplementedError(_ITEM_9)
    tr = T.resolve(transport)
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
    if engine == "auto":
        if mesh is not None:
            raise NotImplementedError(_ITEM_10)
        engine = "twofive"  # single device: the engine is vestigial
    if backend is None:
        backend = "dense"
    eps = threshold if filter_eps is None else filter_eps
    if sharded:
        c = plan_mod.execute_sharded(
            a, b, engine, threshold=threshold,
            backend="dense" if backend == "auto" else backend,
            c_layout=c_layout, l=l, stack_capacity=stack_capacity,
            transport=tr,
        )
        return c.filter(eps) if eps > 0.0 else c
    if mesh is None:
        c = multiply_reference(a, b, threshold=threshold, backend=backend,
                               stack_capacity=stack_capacity)
    else:
        if backend == "auto":
            backend = choose_backend(a, b, threshold)
        c = plan_mod.execute(
            a, b, mesh, engine, threshold=threshold, backend=backend,
            c_layout=c_layout, l=l, stack_capacity=stack_capacity,
            transport=tr,
        )
    if eps > 0.0:
        c = filter_bsm(c, eps)
    return c
