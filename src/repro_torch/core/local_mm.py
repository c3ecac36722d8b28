"""Local (per-device) filtered block multiplication — the torch twin of
``repro/core/local_mm.py``.

DBCSR's "batched small-block GEMM with on-the-fly filtering" stage.  Three
backends, the twins of the reference's ``("jnp", "stacks", "pallas")``:

* ``dense``  (reference ``jnp``) — a masked dense contraction: product
  (i,k,j) counts only if both blocks are occupied AND
  ``norm(A_ik)*norm(B_kj) > threshold``.  Contracts the full cube, one k
  at a time (a single three-operand einsum could build an (i,k,j,a,b)
  intermediate), so it is for test sizes and high fill.
* ``stacks`` (reference ``stacks``) — compact the filter cube into a padded
  product list (``kernels/stacks.py``), gather the surviving A/B blocks,
  one f32 batched GEMM, ``index_add_`` into C tiles.
* ``cuda``   (reference ``pallas``) — the hand-written Hopper kernel
  (``kernels/block_spgemm.py``) over the same list; on CPU tensors its
  plain version runs instead.

Every backend accumulates in f32 and returns ``(c_blocks, c_mask)``.
Blocks may be rectangular: a_blocks (ni, nk, bs_r, bs_k) times b_blocks
(nk, nj, bs_k, bs_c) gives c_blocks (ni, nj, bs_r, bs_c).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.block_spgemm import (
    PANEL,
    block_spgemm_stacks_plain,
    kernel_tile,
)
from repro_torch.kernels.stacks import (
    ProductStacks,
    bucket_capacity,
    compact_pair_mask,
    product_count,
    resolve_capacity,
)
from repro_torch.obs import span

BACKENDS = ("dense", "stacks", "cuda")

# local-stage calls since the last reset (a plain counter): a sharded
# multiply makes one per rank per tick and panel product.  Each call of
# the ``cuda`` backend syncs the host three times (product count,
# ``nonzero`` in the compaction and in the group masks), ``stacks`` twice
calls = 0

# --- cost-model constants: PLACEHOLDERS carried from the TPU v5e model ----
# None of them is an H100 fact; each is to be measured on the card (the
# tuner slice).  They keep the ranking logic in the reference's shape.
# Effective-FLOP penalty of the gather/scatter stage against the dense
# contraction (placeholder: the reference's TPU calibration).
GATHER_OVERHEAD = 4.0
# Throughput multiplier per storage itemsize (placeholder: TPU MXU packing).
_DTYPE_SPEEDUP = {4: 1.0, 2: 2.0, 1: 4.0}
# FLOP-equivalents of one device-memory byte (placeholder: TPU v5e
# 197e12 / 819e9).
_FLOPS_PER_BYTE = 240.0
# Fast-memory budget of a kernel's working set (placeholder: TPU VMEM).
VMEM_BUDGET_BYTES = 16 * 2**20


@dataclass(frozen=True)
class LocalCost:
    """Cost breakdown of one local-stage call: logical ``flops``
    (2 * MACs), device-memory bytes at storage width, the ``effective``
    FLOP-equivalent ranking cost, and ``feasible``."""

    flops: float
    hbm_bytes: float
    effective: float
    feasible: bool = True


def tile_working_set_bytes(bs_r: int, bs_k: int, bs_c: int,
                           tile: tuple[int, int, int] | None,
                           dtype: torch.dtype = torch.float32) -> float:
    """Bytes a tile pipeline holds resident: double-buffered A/B/C tiles at
    storage width plus one f32 accumulator (the reference's VMEM model)."""
    tm, tk, tn = tile or (bs_r, bs_k, bs_c)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2.0 * (tm * tk + tk * tn + tm * tn) * itemsize + tm * tn * 4.0


def local_stage_cost(
    ni: int, nk: int, nj: int, bs_r: int, bs_k: int, bs_c: int, *,
    fill: float,
    backend: str,
    dtype: torch.dtype = torch.float32,
    tile: tuple[int, int] | None = None,
    capacity: int | None = None,
) -> LocalCost:
    """Analytic cost of one local-stage call, in the reference's shape:
    ``dense`` pays the whole cube; the compacted backends pay the
    surviving products (``capacity``, else ``fill`` times the cube) times
    the gather overhead; ``cuda`` adds the operand re-reads of its output
    sub-tiles (at most ``PANEL`` per block edge) and the working-set
    pressure terms.

    ``tile`` is the ``cuda`` kernel's group layout ``(g_r, g_c)``
    (``kernels.block_spgemm.kernel_tile``; None the default group, where
    the reference's is a Pallas MXU tile).  A group stages each A block
    once for its ``g_c`` outputs and each B block once for its ``g_r``, so
    a group smaller than the default re-reads operands, priced like the
    sub-tile re-reads; the default group adds nothing."""
    itemsize = float(torch.empty((), dtype=dtype).element_size())
    speed = _DTYPE_SPEEDUP.get(int(itemsize), 1.0)
    cube = float(ni) * nk * nj
    block = float(bs_r) * bs_k * bs_c
    dense_flops = 2.0 * cube * block
    if backend == "dense":
        hbm = (ni * nk * bs_r * bs_k + nk * nj * bs_k * bs_c
               + ni * nj * bs_r * bs_c) * itemsize
        return LocalCost(dense_flops, hbm, dense_flops / speed)
    if backend not in ("stacks", "cuda"):
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    cap = float(capacity) if capacity is not None else fill * cube
    flops = 2.0 * cap * block
    compute = GATHER_OVERHEAD * fill * dense_flops / speed
    per_product = (bs_r * bs_k + bs_k * bs_c + bs_r * bs_c) * itemsize
    if backend == "stacks":
        return LocalCost(flops, cap * per_product, compute)
    tm, tk, tn = min(bs_r, PANEL), bs_k, min(bs_c, PANEL)
    n_tm, n_tn = -(-bs_r // tm), -(-bs_c // tn)
    hbm = cap * (n_tn * bs_r * bs_k + n_tm * bs_k * bs_c
                 + bs_r * bs_c) * itemsize
    extra = cap * ((n_tn - 1) * bs_r * bs_k
                   + (n_tm - 1) * bs_k * bs_c) * itemsize
    if tile is not None:
        g_r, g_c = kernel_tile(bs_r, bs_c, group=tile)[:2]
        d_r, d_c = kernel_tile(bs_r, bs_c)[:2]
        extra += cap * (bs_r * bs_k * (1.0 / g_c - 1.0 / d_c)
                        + bs_k * bs_c * (1.0 / g_r - 1.0 / d_r)) * itemsize
    ws = tile_working_set_bytes(bs_r, bs_k, bs_c, (tm, tk, tn), dtype)
    if ws > VMEM_BUDGET_BYTES:
        return LocalCost(flops, hbm, float("inf"), feasible=False)
    if ws > VMEM_BUDGET_BYTES / 2:
        return LocalCost(flops, hbm, compute + hbm * _FLOPS_PER_BYTE)
    return LocalCost(flops, hbm, compute + extra * _FLOPS_PER_BYTE)


def backend_local_cost(
    ni: int, nk: int, nj: int, bs_r: int, bs_k: int, bs_c: int, *,
    fill: float,
    backend: str,
    dtype: torch.dtype = torch.float32,
    tile: tuple[int, int] | None = None,
) -> float:
    """Effective-FLOP ranking cost (``local_stage_cost(...).effective``)."""
    return local_stage_cost(
        ni, nk, nj, bs_r, bs_k, bs_c, fill=fill, backend=backend,
        dtype=dtype, tile=tile,
    ).effective


def pair_filter(
    a_mask: torch.Tensor,
    a_norms: torch.Tensor,
    b_mask: torch.Tensor,
    b_norms: torch.Tensor,
    threshold: float,
) -> torch.Tensor:
    """On-the-fly filter mask over (i, k, j) block-product triples."""
    ok = a_mask[:, :, None] & b_mask[None, :, :]
    if threshold > 0.0:
        ok = ok & (a_norms[:, :, None] * b_norms[None, :, :] > threshold)
    return ok


def stacks_mm(
    a_blocks: torch.Tensor,
    b_blocks: torch.Tensor,
    stacks: ProductStacks,
    *,
    ni: int,
    nj: int,
) -> torch.Tensor:
    """Gather -> batched f32 GEMM -> ``index_add_`` over a compacted
    product list, padding weighted by ``valid``: the CUDA kernel's plain
    version (``kernels.block_spgemm.block_spgemm_stacks_plain``)."""
    return block_spgemm_stacks_plain(a_blocks, b_blocks, stacks, ni=ni, nj=nj)


def _dense_mm(a_blocks, b_blocks, ok) -> torch.Tensor:
    """sum_k ok[:, k, :] * A[:, k] @ B[k] in f32, one k at a time."""
    ni, nk, bs_r, _ = a_blocks.shape
    nj, bs_c = b_blocks.shape[1], b_blocks.shape[3]
    okf = ok.to(torch.float32)
    c = torch.zeros((ni, nj, bs_r, bs_c), dtype=torch.float32,
                    device=a_blocks.device)
    for k in range(nk):
        term = torch.einsum("iab,jbc->ijac", a_blocks[:, k].float(),
                            b_blocks[k].float())
        c += term * okf[:, k, :, None, None]
    return c.to(a_blocks.dtype)


def local_filtered_mm(
    a_blocks: torch.Tensor,
    a_mask: torch.Tensor,
    a_norms: torch.Tensor,
    b_blocks: torch.Tensor,
    b_mask: torch.Tensor,
    b_norms: torch.Tensor,
    *,
    threshold: float = 0.0,
    backend: str = "dense",
    stack_capacity: int | None = None,
    tile: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """C_ij = sum_k A_ik B_kj with on-the-fly norm filtering.

    Shapes: a_blocks (ni, nk, bs_r, bs_k), b_blocks (nk, nj, bs_k, bs_c).
    Returns: c_blocks (ni, nj, bs_r, bs_c), c_mask (ni, nj) bool.

    ``stack_capacity`` bounds the listed products of the compacted
    backends; None takes the exact bucketed count of this call's cube (one
    sync), where the reference's traced callers took the full cube.
    Padding adds nothing, so the result is the same.  Every backend
    accumulates in f32 regardless of the storage dtype.  ``tile`` is the
    ``cuda`` kernel's group layout (None the default; ignored by the other
    backends, as the reference's Pallas tile is).
    """
    global calls
    calls += 1
    with span("repro.local_mm.multiply"):
        ni, nk = a_blocks.shape[:2]
        nj = b_blocks.shape[1]
        with span("repro.local_mm.list_build"):
            ok = pair_filter(a_mask, a_norms, b_mask, b_norms, threshold)
        if backend == "cuda":
            from repro_torch.kernels import ops as kops

            c_blocks = kops.block_spgemm(a_blocks, b_blocks, ok,
                                         capacity=stack_capacity, group=tile)
        elif backend == "stacks":
            with span("repro.local_mm.list_build"):
                if stack_capacity is None:
                    cap = bucket_capacity(product_count(ok))
                else:
                    cap = resolve_capacity(stack_capacity, ni * nk * nj)
                stacks = compact_pair_mask(ok, capacity=cap)
            c_blocks = stacks_mm(a_blocks, b_blocks, stacks, ni=ni, nj=nj)
        elif backend == "dense":
            c_blocks = _dense_mm(a_blocks, b_blocks, ok)
        else:
            raise ValueError(f"unknown backend {backend!r}; one of "
                             f"{BACKENDS}")
        c_mask = ok.any(dim=1)
    return c_blocks, c_mask
