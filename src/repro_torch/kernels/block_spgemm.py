"""Hopper kernel: filtered block-sparse matmul over the compacted product list.

Replaces the Pallas TPU kernel ``repro/kernels/block_spgemm.py::
_tiled_kernel`` (launched there by ``block_spgemm_stacks``).  The kernel is
CUDA C++ for ``sm_90a`` in ``csrc/block_spgemm.cu``, built by ``nvcc`` at
first use (``kernels/_build.py``) and bound with ``ctypes``.

The TPU kernel carries one accumulator across a k-run on a sequential
grid; CUDA blocks run in parallel and in no order.  So one CTA owns a
group of ``g_r x g_c`` output blocks (``kernel_tile``: 4 x 4 for the
paper's 23 x 23 blocks) and walks k in increasing order with the f32
accumulators in registers, staging each A_ik and B_kj of the group once
per k for the whole group.  The wrapper turns the product list into
per-group k masks (``group_masks``: one ``(n_groups, nk)`` int32 array, bit
``(i % g_r) * g_c + j % g_c`` set for each surviving product, built with
torch ops on the list's device) and launches one CTA per group with a
survivor (one host sync, for their number).

What bounds it on the H100: f32 FMA issue on the CUDA cores (67 TFLOP/s
peak; f32 parity with the reference rules out TF32) and what feeds them —
a small block pair does about 11.5 FMAs per word read, so the design
reuses each staged block across a group.  The source note in the ``.cu``
file says more.

Storage dtypes: f32, bf16 and f8 (``float8_e4m3fn``, ``float8_e5m2``), as
the reference's kernel takes; every element is widened to f32 as it is
staged, the sum runs in f32 and is cast to the storage dtype once, at
write-back.  The operands' block grids may have any strides, each block
row-major and contiguous (``rowmajor_blocks``): a stride-0 view, such as
the MoE layer's block-diagonal expert bank whose every column aliases one
expert's weights, is read in place and never materialised.

Beside the kernel, in this module: ``block_spgemm_stacks_plain``, the same
function in plain PyTorch (gather, upcast, f32 ``bmm``, ``index_add_``,
cast back — the ``stacks`` backend's algorithm), chunked so a full 512^3
cube never gathers all operands at once.  A wrapper uses the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels.stacks import (
    ProductStacks,
    bucket_capacity,
    compact_pair_mask,
    product_count,
    resolve_capacity,
)
from repro_torch.obs import span

launches = 0  # kernel launches since the last reset (a plain counter)

# gathered f32 operand and product words per chunk of the plain version
# (2**28 words = 1 GiB; about 169k products of 23 x 23 blocks)
PLAIN_CHUNK_WORDS = 2**28

# storage dtypes the kernel takes, by the launcher's code; every one is
# widened to f32 as it is staged and the f32 sum cast back at write-back
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1,
               torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}


# the kernel's CTA covers a PANEL x PANEL panel of output (16 x 8 threads,
# MICRO = (6 rows, 12 columns) each); a group edge has at most GROUP_MAX
# blocks (16 mask bits)
PANEL = 96
MICRO = (6, 12)
GROUP_MAX = 4


class KernelTile(NamedTuple):
    """What one CTA covers, per axis (rows, then columns): ``g_*`` output
    blocks of a group, each at a panel stride ``stride_*`` (the block edge
    rounded up to a multiple of the thread's micro-tile edge, 6 rows or 12
    columns, so a micro-tile lies in one block pair), and ``n_sub_*``
    sub-tiles of ``PANEL`` for a block edge above ``PANEL`` (then one
    block per CTA)."""

    g_r: int
    g_c: int
    stride_r: int
    stride_c: int
    n_sub_r: int
    n_sub_c: int


class GroupMasks(NamedTuple):
    """A product list as the kernel walks it: ``masks`` (n_groups, nk)
    int32, where group ``(i // g_r) * n_gc + j // g_c`` has bit
    ``(i % g_r) * g_c + j % g_c`` set at k for each valid product
    (i, k, j); ``groups`` (int32, ascending) the groups with one."""

    masks: torch.Tensor
    groups: torch.Tensor
    g_r: int
    g_c: int


def _check_operands(a_blocks: torch.Tensor, b_blocks: torch.Tensor) -> None:
    if a_blocks.dim() != 4 or b_blocks.dim() != 4:
        raise ValueError(
            f"blocks must be (n, n, bs, bs) grids, got {tuple(a_blocks.shape)}"
            f" and {tuple(b_blocks.shape)}")
    if a_blocks.shape[1] != b_blocks.shape[0] or (
            a_blocks.shape[3] != b_blocks.shape[2]):
        raise ValueError(
            f"contraction mismatch: A {tuple(a_blocks.shape)} x "
            f"B {tuple(b_blocks.shape)}")
    if a_blocks.dtype != b_blocks.dtype:
        raise TypeError(f"operand dtypes differ: {a_blocks.dtype} vs "
                        f"{b_blocks.dtype}")
    if a_blocks.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported block dtype {a_blocks.dtype}: float32 "
                        "or bfloat16, or f8 (float8_e4m3fn, float8_e5m2)")
    if a_blocks.device != b_blocks.device:
        raise ValueError(f"operands on different devices: {a_blocks.device}"
                         f" vs {b_blocks.device}")


def rowmajor_blocks(t: torch.Tensor) -> bool:
    """Whether every block of a (n, n, rows, cols) grid is row-major and
    contiguous: what the kernel needs of an operand, whatever the strides
    of the grid itself."""
    rows, cols = t.shape[2:]
    return (cols == 1 or t.stride(3) == 1) and (rows == 1
                                                 or t.stride(2) == cols)


def _edge(bs: int, micro: int) -> tuple[int, int, int]:
    """(default group edge, panel stride, sub-tiles) of one block edge."""
    if bs > PANEL:
        return 1, PANEL, -(-bs // PANEL)
    stride = micro * -(-bs // micro)
    return min(PANEL // stride, GROUP_MAX), stride, 1


def validate_tile(bs_r: int, bs_c: int, tile,
                  dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """Check a group layout ``(g_r, g_c)`` against a block shape up front:
    the rules the kernel's launcher applies (``edge_ok`` in
    ``csrc/block_spgemm.cu``) at the layout's own panel strides — at least
    one block per edge, ``g * stride`` within the ``PANEL``, one block per
    CTA for an edge above ``PANEL``, at most 16 mask bits, and a storage
    dtype the kernel takes.  Returns ``(g_r, g_c)``; raises ``ValueError``
    otherwise, so a refused layout never reaches a launch."""
    try:
        g_r, g_c = (int(g) for g in tile)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"a group layout is a (g_r, g_c) integer pair, got {tile!r}"
        ) from e
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes float32 or bfloat16 blocks, or "
                         f"f8 (float8_e4m3fn, float8_e5m2), not {dtype}")
    for name, bs, g, micro in (("bs_r", bs_r, g_r, MICRO[0]),
                               ("bs_c", bs_c, g_c, MICRO[1])):
        _, stride, _ = _edge(bs, micro)
        if g < 1:
            raise ValueError(f"group edge {g} for {name}={bs}: at least 1")
        if g * stride > PANEL:
            raise ValueError(
                f"group edge {g} x stride {stride} for {name}={bs} exceeds "
                f"the kernel's {PANEL}-wide panel")
    if g_r * g_c > GROUP_MAX * GROUP_MAX:
        raise ValueError(f"group {g_r} x {g_c} needs more than "
                         f"{GROUP_MAX * GROUP_MAX} mask bits")
    return g_r, g_c


def kernel_tile(bs_r: int, bs_c: int, group=None) -> KernelTile:
    """The kernel's group and panel layout for one block shape.  A block
    edge up to ``PANEL`` is stacked ``min(PANEL // stride, GROUP_MAX)``
    times into the panel by default (4 x 23-row blocks at stride 24 fill 96
    rows); a larger edge is cut into ``PANEL`` sub-tiles.  ``group`` — a
    ``(g_r, g_c)`` layout (``validate_tile``) in place of the default
    group; None is the default."""
    g_r, stride_r, n_sub_r = _edge(bs_r, MICRO[0])
    g_c, stride_c, n_sub_c = _edge(bs_c, MICRO[1])
    if group is not None:
        g_r, g_c = validate_tile(bs_r, bs_c, group)
    return KernelTile(g_r, g_c, stride_r, stride_c, n_sub_r, n_sub_c)


def tile_candidates(bs_r: int, bs_c: int,
                    dtype: torch.dtype = torch.float32) -> list:
    """Group layouts the tuner ranks for one block shape: only None, the
    default ``kernel_tile`` group.  The kernel launches any layout
    ``validate_tile`` accepts, but a smaller group only re-stages
    operands: on the H100 at H2O-DFT-LS's H.H (2 % of the cube, the sparse
    case a smaller group was meant for) 2 x 2 took 1.64x and 1 x 1 2.70x
    the default's time (``chip_smoke.py`` phase 14.4).  A layout joins
    this list once a measured pattern shows it winning."""
    del bs_r, bs_c, dtype  # the reference's signature; one layout for all
    return [None]


def group_masks(stacks: ProductStacks, *, ni: int, nk: int, nj: int,
                g_r: int, g_c: int) -> GroupMasks:
    """Per-group k masks of a product list, on the list's device (any
    device; no sync), and the groups with a survivor in increasing order,
    then -1 up to every group's count (the kernel's CTAs of a -1 exit at
    once).

    One accumulating ``index_add_`` of ``valid << bit`` over the whole
    list: each (group, k, bit) occurs at most once among the valid
    entries, so the sum is the OR, and padding (valid 0) adds nothing."""
    n_gr, n_gc = -(-ni // g_r), -(-nj // g_c)
    if n_gr * n_gc * nk >= 2**31:
        raise ValueError(f"{n_gr * n_gc} groups x {nk} k's overflow the "
                         "int32 mask index")
    dev = stacks.ia.device
    flat = torch.zeros(n_gr * n_gc * nk, dtype=torch.int32, device=dev)
    if stacks.capacity:
        ia, ij = stacks.ia, stacks.ij
        group = (ia // g_r) * n_gc + ij // g_c
        bit = torch.bitwise_left_shift(stacks.valid,
                                       (ia % g_r) * g_c + ij % g_c)
        flat.index_add_(0, group * nk + stacks.ik, bit)
    masks = flat.view(n_gr * n_gc, nk)
    groups = torch.nonzero_static(masks.any(1), size=n_gr * n_gc,
                                  fill_value=-1).squeeze(1).to(torch.int32)
    return GroupMasks(masks, groups, g_r, g_c)


def _launcher():
    from repro_torch.kernels import _build

    fn = _build.load("block_spgemm").block_spgemm_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 5 + [ctypes.c_longlong] * 5 + [i] * 13 + [vp]
        fn.restype = ctypes.c_int
    return fn


def block_spgemm_groups(
    a_blocks: torch.Tensor,  # (ni, nk, bs_r, bs_k), CUDA
    b_blocks: torch.Tensor,  # (nk, nj, bs_k, bs_c), CUDA
    gm: GroupMasks,
    *,
    ni: int,
    nj: int,
) -> torch.Tensor:
    """Launch the CUDA kernel over prepared group masks (CUDA tensors
    only), in the masks' group layout (``gm.g_r x gm.g_c``).

    The operands' block grids may have any strides (a stride-0 view, such
    as one block aliased across a grid axis, is read in place); each block
    must be row-major and contiguous (``rowmajor_blocks``).

    The output starts at zero, so blocks without a product stay zero.
    Launches on PyTorch's current stream without synchronising; raises if
    the launch is refused.  The kernel has no backward: with grad enabled
    and an operand that requires grad it raises rather than return a C
    cut off from A and B (MoE ``spgemm`` training needs a backward kernel,
    ROADMAP.md Queue A item 15b; the CPU path's plain version is
    differentiable).
    """
    global launches
    _check_operands(a_blocks, b_blocks)
    dev = a_blocks.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if torch.is_grad_enabled() and (a_blocks.requires_grad
                                    or b_blocks.requires_grad):
        raise NotImplementedError(
            "block_spgemm's CUDA kernel has no backward: an operand requires"
            " grad (MoE spgemm training is ROADMAP.md Queue A item 15b; run "
            "under torch.no_grad(), or train MoE layers with impl tp or "
            "dense)")
    ni_a, nk, bs_r, bs_k = a_blocks.shape
    _, nj_b, _, bs_c = b_blocks.shape
    if (ni_a, nj_b) != (ni, nj):
        raise ValueError(f"grid ({ni_a}, {nj_b}) != (ni={ni}, nj={nj})")
    # any layout the kernel takes (validate_tile raises on the others)
    tile = kernel_tile(bs_r, bs_c, group=(gm.g_r, gm.g_c))
    n_groups = -(-ni // tile.g_r) * -(-nj // tile.g_c)
    if tuple(gm.masks.shape) != (n_groups, nk):
        raise ValueError(f"masks {tuple(gm.masks.shape)} != {(n_groups, nk)}")
    for name, t in (("a_blocks", a_blocks), ("b_blocks", b_blocks),
                    ("masks", gm.masks), ("groups", gm.groups)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, operands on {dev}")
    for name, t in (("a_blocks", a_blocks), ("b_blocks", b_blocks)):
        if not rowmajor_blocks(t):
            raise ValueError(f"{name}: each block must be row-major and "
                             f"contiguous, strides {t.stride()}")
    for name, t in (("masks", gm.masks), ("groups", gm.groups)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("masks", gm.masks), ("groups", gm.groups)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    with span("repro.block_spgemm.launch"):
        out = torch.zeros((ni, nj, bs_r, bs_c), dtype=a_blocks.dtype,
                          device=dev)
        n_active = gm.groups.shape[0]
        if n_active == 0:
            return out
        launch = _launcher()
        with torch.cuda.device(dev):
            err = launch(
                a_blocks.data_ptr(), b_blocks.data_ptr(), out.data_ptr(),
                gm.masks.data_ptr(), gm.groups.data_ptr(), n_active,
                *a_blocks.stride()[:2], *b_blocks.stride()[:2], ni, nk, nj,
                bs_r, bs_k, bs_c, *tile, _DTYPE_CODE[a_blocks.dtype],
                torch.cuda.current_stream(dev).cuda_stream,
            )
    if err != 0:
        raise RuntimeError(f"block_spgemm kernel launch failed: CUDA error "
                           f"{err} (groups={n_active}, blocks=({bs_r}, {bs_k},"
                           f" {bs_c}), dtype={a_blocks.dtype})")
    launches += 1
    return out


def _gather(blocks: torch.Tensor, i: torch.Tensor,
            k: torch.Tensor) -> torch.Tensor:
    """``blocks[i, k]`` widened to f32.  1-byte floats are gathered as
    their bytes, since not every device indexes float8 tensors."""
    if blocks.element_size() == 1:
        return blocks.view(torch.uint8)[i, k].view(blocks.dtype).float()
    return blocks[i, k].float()


def _zero_blocks(c: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Zero the (ni, nj) blocks of ``c`` where ``keep`` is False, in place
    (1-byte floats through their bytes: +0.0 is the zero byte in both f8
    formats)."""
    raw = c.view(torch.uint8) if c.element_size() == 1 else c
    raw.masked_fill_(~keep[:, :, None, None], 0)
    return c


def block_spgemm_stacks_plain(
    a_blocks: torch.Tensor,
    b_blocks: torch.Tensor,
    stacks: ProductStacks,
    *,
    ni: int,
    nj: int,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather the listed A/B
    blocks, one f32 batched GEMM per chunk of products
    (``PLAIN_CHUNK_WORDS``), and an
    ``index_add_`` into the output tiles; padding entries are weighted 0
    and routed to a spare tile.  Full f32 needs TF32 off on CUDA
    (``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's default).
    """
    _check_operands(a_blocks, b_blocks)
    bs_r, bs_k = a_blocks.shape[2:]
    bs_c = b_blocks.shape[3]
    dtype, dev = a_blocks.dtype, a_blocks.device
    if stacks.capacity == 0:
        return torch.zeros((ni, nj, bs_r, bs_c), dtype=dtype, device=dev)
    per_product = bs_r * bs_k + bs_k * bs_c + bs_r * bs_c
    chunk = max(1, PLAIN_CHUNK_WORDS // per_product)
    c = torch.zeros((ni * nj + 1, bs_r, bs_c), dtype=torch.float32,
                    device=dev)
    seg = torch.where(stacks.valid == 1, stacks.tile, ni * nj).long()
    for s in range(0, stacks.capacity, chunk):
        ia = stacks.ia[s:s + chunk].long()
        ik = stacks.ik[s:s + chunk].long()
        ij = stacks.ij[s:s + chunk].long()
        prod = torch.bmm(_gather(a_blocks, ia, ik), _gather(b_blocks, ik, ij))
        prod *= stacks.valid[s:s + chunk].float()[:, None, None]
        c.index_add_(0, seg[s:s + chunk], prod)
    return c[: ni * nj].reshape(ni, nj, bs_r, bs_c).to(dtype)


def block_spgemm_stacks(
    a_blocks: torch.Tensor,  # (ni, nk, bs_r, bs_k)
    b_blocks: torch.Tensor,  # (nk, nj, bs_k, bs_c)
    stacks: ProductStacks,
    *,
    ni: int,
    nj: int,
    group=None,
) -> torch.Tensor:
    """C tiles of the compacted product list: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  Only tiles with a
    surviving product get a value; the rest are zero.  ``group`` — the
    kernel's group layout (``kernel_tile``; None the default); the plain
    version ignores it, since the result does not depend on it."""
    _check_operands(a_blocks, b_blocks)
    dev = a_blocks.device
    if dev.type == "cpu":
        return block_spgemm_stacks_plain(a_blocks, b_blocks, stacks,
                                         ni=ni, nj=nj)
    if dev.type != "cuda":
        raise ValueError(f"block_spgemm runs on cpu or cuda tensors, not "
                         f"{dev}")
    nk, bs_r, bs_c = a_blocks.shape[1], a_blocks.shape[2], b_blocks.shape[3]
    tile = kernel_tile(bs_r, bs_c, group=group)
    if stacks.capacity == 0:  # no product: no group, no launch
        return torch.zeros((ni, nj, bs_r, bs_c), dtype=a_blocks.dtype,
                           device=dev)
    with span("repro.local_mm.list_build"):
        gm = group_masks(stacks, ni=ni, nk=nk, nj=nj, g_r=tile.g_r,
                         g_c=tile.g_c)
    a_blocks, b_blocks = (t if rowmajor_blocks(t) else t.contiguous()
                          for t in (a_blocks, b_blocks))
    return block_spgemm_groups(a_blocks, b_blocks, gm, ni=ni, nj=nj)


def block_spgemm(
    a_blocks: torch.Tensor,  # (ni, nk, bs_r, bs_k)
    b_blocks: torch.Tensor,  # (nk, nj, bs_k, bs_c)
    pair_ok: torch.Tensor,  # (ni, nk, nj) bool
    *,
    capacity: int | None = None,
    group=None,
) -> torch.Tensor:
    """C_ij = sum_k ok[i,k,j] * A_ik @ B_kj via the compacted product list.

    ``capacity`` bounds the listed products.  None takes the exact
    bucketed count of ``pair_ok`` (one sync): PyTorch runs eagerly, so the
    count is always at hand, where the reference's None meant the full
    cube for its traced callers.  Padding adds nothing, so both give the
    same C.  Tiles with no surviving product are zeroed through the tile
    mask, as in the reference.  ``group`` is ``block_spgemm_stacks``'s.
    """
    ni, nk = a_blocks.shape[:2]
    nj = b_blocks.shape[1]
    if tuple(pair_ok.shape) != (ni, nk, nj):
        raise ValueError(f"pair_ok {tuple(pair_ok.shape)} != {(ni, nk, nj)}")
    with span("repro.local_mm.list_build"):
        if capacity is None:
            cap = bucket_capacity(product_count(pair_ok))
        else:
            cap = resolve_capacity(capacity, ni * nk * nj)
        stacks = compact_pair_mask(pair_ok, capacity=cap)
    c = block_spgemm_stacks(a_blocks, b_blocks, stacks, ni=ni, nj=nj,
                            group=group)
    c_mask = pair_ok.to(torch.bool).any(dim=1)
    # in place: c is this call's own fresh output
    return _zero_blocks(c, c_mask)
