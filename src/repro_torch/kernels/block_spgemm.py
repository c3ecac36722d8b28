"""Hopper kernel: filtered block-sparse matmul over the compacted product list.

Replaces the Pallas TPU kernel ``repro/kernels/block_spgemm.py::
_tiled_kernel`` (launched there by ``block_spgemm_stacks``).  The kernel is
CUDA C++ for ``sm_90a`` in ``csrc/block_spgemm.cu``, built by ``nvcc`` at
first use (``kernels/_build.py``) and bound with ``ctypes``.

The TPU kernel carries one accumulator across a k-run on a sequential
grid; CUDA blocks run in parallel and in no order.  So the wrapper turns
the product list into per-output-tile runs (``tile_runs``: a row pointer
over the valid entries, built with torch ops on the device) and the kernel
gives each CTA one (non-empty output tile, tm sub-tile, tn sub-tile), which
walks its run with the f32 accumulator in registers and writes once.

What bounds it on the H100: f32 FMA issue on the CUDA cores (67 TFLOP/s
peak; f32 parity with the reference rules out TF32) and the shared-memory
loads that feed them — the bytes of a product's two small blocks are few
against its 2 * bs^3 operations.  The source note in the ``.cu`` file says
what the design does about it.

Beside the kernel, in this module: ``block_spgemm_stacks_plain``, the same
function in plain PyTorch (gather, f32 ``bmm``, ``index_add_`` — the
``stacks`` backend's algorithm), chunked so a full 512^3 cube never
gathers all operands at once.  A wrapper uses the plain version only for
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

launches = 0  # kernel launches since the last reset (a plain counter)

# gathered f32 operand and product words per chunk of the plain version
# (2**28 words = 1 GiB; about 169k products of 23 x 23 blocks)
PLAIN_CHUNK_WORDS = 2**28

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_F8 = tuple(getattr(torch, n) for n in ("float8_e4m3fn", "float8_e5m2")
            if hasattr(torch, n))


class TileRuns(NamedTuple):
    """Per-output-tile k-runs of a product list (int32, one entry per
    non-empty output tile, in list order): the tile's block coordinates
    and the [run_start, run_start + run_len) slice of the list."""

    tile_ia: torch.Tensor
    tile_ij: torch.Tensor
    run_start: torch.Tensor
    run_len: torch.Tensor


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
    if a_blocks.dtype in _F8:
        raise NotImplementedError(
            "f8 (e4m3) block storage is not ported yet: the kernel takes "
            "float32 and bfloat16 (ROADMAP.md Queue B, f8 leg)")
    if a_blocks.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported block dtype {a_blocks.dtype}: float32 "
                        "or bfloat16")
    if a_blocks.device != b_blocks.device:
        raise ValueError(f"operands on different devices: {a_blocks.device}"
                         f" vs {b_blocks.device}")


def kernel_tile(bs_r: int, bs_c: int) -> tuple[int, int, int]:
    """(r, ty, tx): the register micro-tile edge and the thread-block shape
    the kernel runs for one block shape.  Blocks up to 24 x 24 take r = 3
    on at most 8 x 8 threads; larger ones r = 4 on at most 16 x 16 threads
    over 64 x 64 sub-tiles (the ``.cu`` file instantiates exactly these)."""
    r, cap = (3, 24) if max(bs_r, bs_c) <= 24 else (4, 64)
    return r, -(-min(bs_r, cap) // r), -(-min(bs_c, cap) // r)


def tile_runs(stacks: ProductStacks) -> TileRuns:
    """Row pointer over the valid entries of a product list, on its device
    (one sync, for the number of non-empty tiles).  The list is sorted by
    output tile, so each tile's products are one contiguous run."""
    starts = torch.nonzero((stacks.first == 1) & (stacks.valid == 1))
    starts = starts.squeeze(1)
    n_valid = stacks.valid.sum().view(1)
    ends = torch.cat([starts[1:], n_valid])[: starts.numel()]
    i32 = torch.int32
    return TileRuns(
        tile_ia=stacks.ia[starts],
        tile_ij=stacks.ij[starts],
        run_start=starts.to(i32),
        run_len=(ends - starts).to(i32),
    )


def _launcher():
    from repro_torch.kernels import _build

    fn = _build.load("block_spgemm").block_spgemm_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [ctypes.c_longlong] + [i] * 9 + [vp]
        fn.restype = ctypes.c_int
    return fn


def block_spgemm_runs(
    a_blocks: torch.Tensor,  # (ni, nk, bs_r, bs_k), CUDA
    b_blocks: torch.Tensor,  # (nk, nj, bs_k, bs_c), CUDA
    ik: torch.Tensor,  # (capacity,) int32: the list's k indices
    runs: TileRuns,
    *,
    ni: int,
    nj: int,
) -> torch.Tensor:
    """Launch the CUDA kernel over prepared tile runs (CUDA tensors only).

    The output starts at zero, so tiles without a run stay zero.  Launches
    on PyTorch's current stream without synchronising; raises if the
    launch is refused.
    """
    global launches
    _check_operands(a_blocks, b_blocks)
    dev = a_blocks.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    ni_a, nk, bs_r, bs_k = a_blocks.shape
    _, nj_b, _, bs_c = b_blocks.shape
    if (ni_a, nj_b) != (ni, nj):
        raise ValueError(f"grid ({ni_a}, {nj_b}) != (ni={ni}, nj={nj})")
    for name, t in (("a_blocks", a_blocks), ("b_blocks", b_blocks),
                    ("ik", ik), *zip(runs._fields, runs)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, operands on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t is not a_blocks and t is not b_blocks and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    out = torch.zeros((ni, nj, bs_r, bs_c), dtype=a_blocks.dtype, device=dev)
    n_tiles = runs.run_start.shape[0]
    if n_tiles == 0:
        return out
    r, ty, tx = kernel_tile(bs_r, bs_c)
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(
            a_blocks.data_ptr(), b_blocks.data_ptr(), out.data_ptr(),
            ik.data_ptr(), *(t.data_ptr() for t in runs),
            n_tiles, nk, nj, bs_r, bs_k, bs_c, _DTYPE_CODE[a_blocks.dtype],
            r, ty, tx, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"block_spgemm kernel launch failed: CUDA error "
                           f"{err} (tiles={n_tiles}, blocks=({bs_r}, {bs_k},"
                           f" {bs_c}), dtype={a_blocks.dtype})")
    launches += 1
    return out


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
        prod = torch.bmm(a_blocks[ia, ik].float(), b_blocks[ik, ij].float())
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
) -> torch.Tensor:
    """C tiles of the compacted product list: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  Only tiles with a
    surviving product get a value; the rest are zero."""
    _check_operands(a_blocks, b_blocks)
    dev = a_blocks.device
    if dev.type == "cpu":
        return block_spgemm_stacks_plain(a_blocks, b_blocks, stacks,
                                         ni=ni, nj=nj)
    if dev.type != "cuda":
        raise ValueError(f"block_spgemm runs on cpu or cuda tensors, not "
                         f"{dev}")
    return block_spgemm_runs(a_blocks.contiguous(), b_blocks.contiguous(),
                             stacks.ik, tile_runs(stacks), ni=ni, nj=nj)


def block_spgemm(
    a_blocks: torch.Tensor,  # (ni, nk, bs_r, bs_k)
    b_blocks: torch.Tensor,  # (nk, nj, bs_k, bs_c)
    pair_ok: torch.Tensor,  # (ni, nk, nj) bool
    *,
    capacity: int | None = None,
) -> torch.Tensor:
    """C_ij = sum_k ok[i,k,j] * A_ik @ B_kj via the compacted product list.

    ``capacity`` bounds the listed products.  None takes the exact
    bucketed count of ``pair_ok`` (one sync): PyTorch runs eagerly, so the
    count is always at hand, where the reference's None meant the full
    cube for its traced callers.  Padding adds nothing, so both give the
    same C.  Tiles with no surviving product are zeroed through the tile
    mask, as in the reference.
    """
    ni, nk = a_blocks.shape[:2]
    nj = b_blocks.shape[1]
    if tuple(pair_ok.shape) != (ni, nk, nj):
        raise ValueError(f"pair_ok {tuple(pair_ok.shape)} != {(ni, nk, nj)}")
    if capacity is None:
        cap = bucket_capacity(product_count(pair_ok))
    else:
        cap = resolve_capacity(capacity, ni * nk * nj)
    stacks = compact_pair_mask(pair_ok, capacity=cap)
    c = block_spgemm_stacks(a_blocks, b_blocks, stacks, ni=ni, nj=nj)
    c_mask = pair_ok.to(torch.bool).any(dim=1)
    # in place: c is this call's own fresh output
    return c.masked_fill_(~c_mask[:, :, None, None], 0)
