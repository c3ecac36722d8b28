"""The public ``multiply`` entry point, single device — the torch twin of
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

The distributed engines (``cannon``, ``onesided``, ``gather``,
``twofive``), the tuner (``engine="auto"`` with a mesh), pattern
envelopes, panel transports and block assignments arrive with later
slices; asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core.bsm import BlockSparseMatrix, block_norms, filter_bsm
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

_LATER = "ROADMAP.md Queue A items 7-11"


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
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    mesh=None,
    *,
    engine: str = "twofive",
    threshold: float = 0.0,
    filter_eps: float | None = None,
    backend: str | None = None,
    stack_capacity: int | None = None,
    transport=None,
    assignment=None,
    envelope=None,
) -> BlockSparseMatrix:
    """Filtered C = A . B on one device.

    threshold  — on-the-fly filter: skip block products with
                 norm(A_ik) * norm(B_kj) <= threshold.
    filter_eps — post-multiplication filter: drop result blocks with
                 norm <= filter_eps (defaults to ``threshold``).
    backend    — local stage: "dense" | "stacks" | "cuda" | "auto"
                 (occupancy heuristic, see ``choose_backend``); None is
                 "dense", as the reference's None is "jnp".
    stack_capacity — product bound for the compacted backends; derived
                 exactly from the concrete pattern when omitted.

    ``mesh``, ``transport``, ``assignment`` and ``envelope`` belong to the
    distributed slices and raise ``NotImplementedError``; with no mesh the
    engine is vestigial, as in the reference.
    """
    if engine != "auto" and engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; one of {ENGINES} or 'auto'"
        )
    for name, value in (("mesh", mesh), ("transport", transport),
                        ("assignment", assignment), ("envelope", envelope)):
        if value is not None:
            raise NotImplementedError(
                f"multiply({name}=...) belongs to the distributed slices of "
                f"the port ({_LATER}); this slice multiplies on one device"
            )
    c = multiply_reference(
        a, b, threshold=threshold,
        backend="dense" if backend is None else backend,
        stack_capacity=stack_capacity,
    )
    eps = threshold if filter_eps is None else filter_eps
    if eps > 0.0:
        c = filter_bsm(c, eps)
    return c
