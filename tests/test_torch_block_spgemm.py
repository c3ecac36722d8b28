"""The block-SpGEMM kernel module on the CPU: its plain version against the
JAX reference (the Pallas kernel in interpret mode and the ``ref``
oracle), the wrapper's dispatch and checks, and the pure-Python parts the
CUDA launch depends on (the per-group k masks, the group layout).

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bsm import random_bsm
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.stacks import bucket_capacity
from repro_torch import interop
from repro_torch.core import bsm as B
from repro_torch.kernels import block_spgemm as K
from repro_torch.kernels import ops, ref, stacks

# the reference's documented tolerances (tests/test_local_mm.py): f32 up to
# summation order, bf16 one output rounding of unit-scaled blocks
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _operands(seed, ni, nk, nj, shape, occupancy):
    """f32 numpy operands (zero where unoccupied) and the pair cube."""
    bs_r, bs_k, bs_c = shape
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((ni, nk, bs_r, bs_k)).astype(np.float32)
    b = rng.standard_normal((nk, nj, bs_k, bs_c)).astype(np.float32)
    a /= np.sqrt(bs_k)
    b /= np.sqrt(bs_k)
    am = rng.random((ni, nk)) < occupancy
    bm = rng.random((nk, nj)) < occupancy
    a *= am[:, :, None, None]
    b *= bm[:, :, None, None]
    ok = am[:, :, None] & bm[None, :, :]
    return a, b, ok


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("occupancy", [0.0, 0.2, 0.7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 8, 8), (4, 16, 8), (23, 23, 23)])
def test_block_spgemm_matches_reference(shape, dtype, occupancy):
    a, b, ok = _operands(17, 3, 4, 3, shape, occupancy)
    cap = bucket_capacity(int(ok.sum()))
    jdt = jnp.dtype(dtype)
    ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
    want_kernel = ref_ops.block_spgemm(ja, jb, jnp.asarray(ok), capacity=cap,
                                       interpret=True)
    want_oracle = ref_ref.block_spgemm_ref(ja, jb, jnp.asarray(ok))
    ta = torch.from_numpy(a).to(TORCH_DT[dtype])
    tb = torch.from_numpy(b).to(TORCH_DT[dtype])
    got = ops.block_spgemm(ta, tb, torch.from_numpy(ok))
    assert got.dtype == TORCH_DT[dtype]  # storage dtype round-trips
    got32 = got.float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got32, _f32(want_kernel), rtol=tol, atol=tol)
    np.testing.assert_allclose(got32, _f32(want_oracle), rtol=tol, atol=tol)
    # the port's own oracle agrees with the reference's
    mine = ref.block_spgemm_ref(ta, tb, torch.from_numpy(ok)).float().numpy()
    np.testing.assert_allclose(mine, _f32(want_oracle), rtol=tol, atol=tol)
    assert K.launches == 0  # CPU tensors never reach the kernel


# f8 storage: (torch dtype, jax dtype, mantissa bits, least normal exponent)
F8 = {
    "float8_e4m3fn": (torch.float8_e4m3fn, jnp.float8_e4m3fn, 3, -6),
    "float8_e5m2": (torch.float8_e5m2, jnp.float8_e5m2, 2, -14),
}
F8_ORACLE_TOL = 2e-1  # the reference's f8 tolerance against the f32 oracle


def f8_ulp(x: np.ndarray, mant: int, emin: int) -> np.ndarray:
    """One f8 ulp at |x| (the subnormal spacing below the least normal)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** emin)))
    return 2.0 ** (e - mant)


@pytest.mark.parametrize("occupancy", [0.2, 0.7])
@pytest.mark.parametrize("dtype", sorted(F8))
@pytest.mark.parametrize("shape", [(8, 8, 8), (4, 16, 8), (23, 23, 23)])
def test_block_spgemm_f8_storage_matches_reference(shape, dtype, occupancy):
    """f8 blocks: the plain version upcasts, sums in f32 and casts back.
    Against the reference's oracle on the same f8 operands it is within
    one f8 ulp (the two f32 sums differ in order only); against the f32
    oracle of the unrounded operands within the reference's 2e-1."""
    tdt, jdt, mant, emin = F8[dtype]
    a, b, ok = _operands(23, 3, 4, 3, shape, occupancy)
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    got = ops.block_spgemm(ta, tb, torch.from_numpy(ok))
    assert got.dtype == tdt
    got32 = got.float().numpy()
    ja, jb, jok = jnp.asarray(a), jnp.asarray(b), jnp.asarray(ok)
    # the operands round to the same f8 values on both sides
    np.testing.assert_array_equal(ta.float().numpy(),
                                  _f32(ja.astype(jdt)))
    want = _f32(ref_ref.block_spgemm_ref(ja, jb, jok, storage_dtype=jdt))
    ulp = f8_ulp(np.maximum(np.abs(got32), np.abs(want)), mant, emin)
    assert (np.abs(got32 - want) <= ulp).all()
    exact = _f32(ref_ref.block_spgemm_ref(ja, jb, jok))
    np.testing.assert_allclose(got32, exact, rtol=F8_ORACLE_TOL,
                               atol=F8_ORACLE_TOL)
    assert K.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_reads_a_stride0_operand_in_place(dtype):
    """A block-diagonal bank whose every column aliases one block (a
    stride-0 view, as the MoE layer builds it) gives the plain version the
    same C as its contiguous copy, and the kernel's layout check takes
    it."""
    rng = np.random.default_rng(5)
    e, bs_r, bs_k, bs_c = 4, 4, 16, 8
    w = torch.from_numpy(rng.standard_normal((e, bs_k, bs_c)).astype(
        np.float32)).to(TORCH_DT[dtype])
    bank = w.unsqueeze(0).expand(e, e, bs_k, bs_c)
    assert bank.stride()[:2] == (0, bs_k * bs_c) and K.rowmajor_blocks(bank)
    a = torch.from_numpy(rng.standard_normal((3, e, bs_r, bs_k)).astype(
        np.float32)).to(TORCH_DT[dtype])
    ok = torch.from_numpy(rng.random((3, e)) < 0.6)[:, :, None] & torch.eye(
        e, dtype=torch.bool)[None]
    got = ops.block_spgemm(a, bank, ok)
    assert torch.equal(got, ops.block_spgemm(a, bank.contiguous(), ok))
    assert not K.rowmajor_blocks(bank.transpose(2, 3))


def test_module_imports_without_nvcc_and_never_launches_on_cpu():
    # a fresh interpreter: importing builds and loads nothing, and a CPU
    # call takes the plain version (a CPU-only machine may have no nvcc)
    code = (
        "import torch\n"
        "from repro_torch.kernels import _build, block_spgemm as K\n"
        "assert _build._libs == {}\n"
        "a = torch.ones(2, 3, 4, 4); b = torch.ones(3, 2, 4, 4)\n"
        "c = K.block_spgemm(a, b, torch.ones(2, 3, 2, dtype=torch.bool))\n"
        "assert float(c[0, 0, 0, 0]) == 12.0\n"
        "assert K.launches == 0 and _build._libs == {}\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
    assert K.launches == 0


def test_wrapper_checks():
    a, b, ok = _operands(2, 2, 3, 2, (4, 4, 4), 0.8)
    ta, tb, tok = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(ok)
    with pytest.raises(TypeError):
        ops.block_spgemm(ta.double(), tb.double(), tok)
    with pytest.raises(TypeError):
        ops.block_spgemm(ta, tb.to(torch.bfloat16), tok)
    with pytest.raises(ValueError):
        ops.block_spgemm(ta, tb[:, :, :3], tok)
    with pytest.raises(ValueError):
        ops.block_spgemm(ta, tb, tok[:, :, :1])
    st = stacks.compact_pair_mask(tok, capacity=8)
    gm = K.group_masks(st, ni=2, nk=3, nj=2, g_r=4, g_c=4)
    with pytest.raises(ValueError, match="CUDA"):  # the launcher is CUDA-only
        K.block_spgemm_groups(ta, tb, gm, ni=2, nj=2)


def _bits(gm, ni, nj):
    """Every set bit of the group masks as an (i, k, j) triple."""
    n_gc = -(-nj // gm.g_c)
    found = []
    masks = gm.masks.numpy()
    for g, k in zip(*np.nonzero(masks)):
        m = int(masks[g, k])
        for bit in range(gm.g_r * gm.g_c):
            if m >> bit & 1:
                i = (g // n_gc) * gm.g_r + bit // gm.g_c
                j = (g % n_gc) * gm.g_c + bit % gm.g_c
                found.append((i, int(k), j))
    return found


@pytest.mark.parametrize("capacity", ["exact", "padded", "tight"])
def test_tile_runs_cover_the_valid_list(capacity):
    """The kernel's walk (the per-group k masks) covers the valid entries
    of the list: each once, as one bit of one group's mask at its k, and
    nothing else — padding and the entries a tight capacity dropped appear
    nowhere; the active groups are exactly those with a bit, in order,
    then -1 up to every group's count."""
    _, _, ok = _operands(5, 5, 6, 4, (2, 2, 2), 0.5)
    n = int(ok.sum())
    cap = {"exact": bucket_capacity(n), "padded": 4 * bucket_capacity(n),
           "tight": n - 5}[capacity]
    st = stacks.compact_pair_mask(torch.from_numpy(ok), capacity=cap)
    gm = K.group_masks(st, ni=5, nk=6, nj=4, g_r=2, g_c=3)
    assert gm.masks.dtype == torch.int32 and gm.groups.dtype == torch.int32
    assert tuple(gm.masks.shape) == (3 * 2, 6)
    valid = st.valid.numpy() == 1
    want = sorted(zip(st.ia.numpy()[valid], st.ik.numpy()[valid],
                      st.ij.numpy()[valid]))
    got = _bits(gm, 5, 4)
    assert sorted(got) == want and len(set(got)) == len(got)
    active = np.flatnonzero(gm.masks.numpy().any(1))
    want = np.full(gm.masks.shape[0], -1)
    want[:active.size] = active
    np.testing.assert_array_equal(gm.groups.numpy(), want)


@pytest.mark.parametrize("bs_r,bs_c", [(4, 4), (8, 8), (23, 23), (24, 24),
                                       (4, 8), (25, 25), (64, 64), (128, 128),
                                       (4, 128), (30, 7)])
def test_kernel_tile_fits_the_cuda_instantiations(bs_r, bs_c):
    """The layout obeys the launcher's checks (``csrc/block_spgemm.cu``):
    per axis, g blocks at a stride that is a multiple of the micro-tile
    edge (6 rows, 12 columns), at least the block edge, within the 96-wide
    panel, at most 16 mask bits; an edge above 96 takes one block in
    ceil(edge / 96) sub-tiles."""
    t = K.kernel_tile(bs_r, bs_c)
    assert t.g_r * t.g_c <= 16
    for bs, g, stride, n_sub, micro in (
            (bs_r, t.g_r, t.stride_r, t.n_sub_r, K.MICRO[0]),
            (bs_c, t.g_c, t.stride_c, t.n_sub_c, K.MICRO[1])):
        assert g >= 1 and stride % micro == 0 and g * stride <= K.PANEL
        if bs > K.PANEL:
            assert (g, stride, n_sub) == (1, K.PANEL, -(-bs // K.PANEL))
        else:
            assert stride >= bs and n_sub == 1
            # as many blocks as fit, up to GROUP_MAX
            assert g == min(K.PANEL // stride, K.GROUP_MAX)


def _walk_group_masks(a, b, gm, ni, nj):
    """Plain evaluator of the kernel's walk: every active group, its k's
    with a non-zero mask in increasing order, and every set bit (i, j) of
    the mask adding A_ik @ B_kj in f32; cast to the storage dtype once."""
    n_gc = -(-nj // gm.g_c)
    bs_r, bs_c = a.shape[2], b.shape[3]
    c = torch.zeros((ni, nj, bs_r, bs_c), dtype=torch.float32)
    masks = gm.masks.numpy()
    for g in gm.groups.tolist():
        if g < 0:  # padding past the active groups
            break
        gi, gj = divmod(g, n_gc)
        for k in np.flatnonzero(masks[g]):
            m = int(masks[g, k])
            for bit in range(gm.g_r * gm.g_c):
                if m >> bit & 1:
                    i = gi * gm.g_r + bit // gm.g_c
                    j = gj * gm.g_c + bit % gm.g_c
                    c[i, j] += a[i, k].float() @ b[k, j].float()
    return c.to(a.dtype)


def _mask_case(case):
    """(a, b, stacks, ni, nk, nj) for one group-mask case."""
    if case == "reference":  # the reference's own generator, carried over
        m = random_bsm(jax.random.PRNGKey(3), nb=10, bs=5, occupancy=0.4,
                       pattern="decay")
        t = interop.bsm_from_arrays(m.blocks, m.mask, m.norms, device="cpu")
        ok = stacks.pair_cube(t.mask, t.mask, t.norms, t.norms, 1e-9)
        a = b = t.blocks
        ni = nk = nj = 10
    else:
        ni, nk, nj, shape, dtype = {
            "ragged": (9, 6, 7, (23, 23, 23), torch.float32),
            "threshold": (8, 5, 8, (6, 6, 6), torch.float32),
            "empty_groups": (12, 4, 12, (4, 4, 4), torch.float32),
            "rectangular": (7, 5, 5, (30, 7, 25), torch.float32),
            "bf16": (9, 6, 7, (23, 23, 23), torch.bfloat16),
        }[case]
        bs_r, bs_k, bs_c = shape
        rng = np.random.default_rng(11)
        an = rng.standard_normal((ni, nk, bs_r, bs_k)) / np.sqrt(bs_k)
        bn = rng.standard_normal((nk, nj, bs_k, bs_c)) / np.sqrt(bs_k)
        an *= 10.0 ** rng.uniform(-2, 0, (ni, nk, 1, 1))
        bn *= 10.0 ** rng.uniform(-2, 0, (nk, nj, 1, 1))
        a = torch.from_numpy(an.astype(np.float32)).to(dtype)
        b = torch.from_numpy(bn.astype(np.float32)).to(dtype)
        am = torch.from_numpy(rng.random((ni, nk)) < 0.7)
        bm = torch.from_numpy(rng.random((nk, nj)) < 0.7)
        if case == "empty_groups":  # block rows / cols 4-7 hold nothing
            am[4:8] = False
            bm[:, 4:8] = False
        thr = 0.05 if case in ("threshold", "bf16") else 0.0
        ok = stacks.pair_cube(am, bm, B.block_norms(a), B.block_norms(b), thr)
        if case == "threshold":  # the screen filters part of a group
            assert 0 < int(ok.sum()) < int((am[:, :, None] & bm[None]).sum())
    st = stacks.compact_pair_mask(
        ok, capacity=stacks.bucket_capacity(stacks.product_count(ok)))
    return a, b, st, ni, nk, nj


MASK_CASES = ["reference", "ragged", "threshold", "empty_groups",
              "rectangular", "bf16"]


@pytest.mark.parametrize("case", MASK_CASES)
def test_group_masks_hold_each_valid_product_once(case):
    a, b, st, ni, nk, nj = _mask_case(case)
    t = K.kernel_tile(a.shape[2], b.shape[3])
    gm = K.group_masks(st, ni=ni, nk=nk, nj=nj, g_r=t.g_r, g_c=t.g_c)
    valid = st.valid.numpy() == 1
    want = sorted(zip(st.ia.numpy()[valid], st.ik.numpy()[valid],
                      st.ij.numpy()[valid]))
    got = _bits(gm, ni, nj)
    assert sorted(got) == want and len(set(got)) == len(got)
    assert all(i < ni and j < nj for i, _, j in got)  # ragged edges unset
    n_groups = -(-ni // t.g_r) * -(-nj // t.g_c)
    assert gm.groups.numel() == n_groups
    if case == "empty_groups":
        assert 0 < int((gm.groups >= 0).sum()) < n_groups


@pytest.mark.parametrize("case", MASK_CASES)
def test_group_mask_walk_matches_plain(case):
    """Walking the group masks gives the plain version's product: f32 up
    to summation order (1e-5); bf16 within one output rounding (2e-2), as
    both sum in f32 and cast once."""
    a, b, st, ni, nk, nj = _mask_case(case)
    t = K.kernel_tile(a.shape[2], b.shape[3])
    gm = K.group_masks(st, ni=ni, nk=nk, nj=nj, g_r=t.g_r, g_c=t.g_c)
    got = _walk_group_masks(a, b, gm, ni, nj)
    want = K.block_spgemm_stacks_plain(a, b, st, ni=ni, nj=nj)
    tol = TOL["float32"] if a.dtype == torch.float32 else TOL["bfloat16"]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("chunk", [1, 3, 1000])
def test_plain_chunking_does_not_change_the_result(chunk, monkeypatch):
    a, b, ok = _operands(9, 4, 5, 3, (8, 4, 6), 0.6)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    st = stacks.compact_pair_mask(torch.from_numpy(ok),
                                  capacity=bucket_capacity(int(ok.sum())))
    whole = K.block_spgemm_stacks_plain(ta, tb, st, ni=4, nj=3)
    # chunk products: the words of one product (8*4 + 4*6 + 8*6) times chunk
    monkeypatch.setattr(K, "PLAIN_CHUNK_WORDS", chunk * 104)
    parts = K.block_spgemm_stacks_plain(ta, tb, st, ni=4, nj=3)
    # summation order differs across chunks only in index_add_ order
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_build_names_the_missing_compiler(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))  # no nvcc on it
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.lib_path("block_spgemm").parent == tmp_path
    assert _build.lib_path("block_spgemm").name.startswith("libblock_spgemm-")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert list(tmp_path.iterdir()) == []


def test_build_digest_covers_included_headers(monkeypatch, tmp_path):
    """Both flash sources include ``csrc/hopper.cuh``: editing it changes
    their library paths (a stale ``.so`` is never loaded), and leaves the
    path of a source that does not include it as it was."""
    import shutil

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.sources("flash_attention_bwd")] == [
        "flash_attention_bwd.cu", "hopper.cuh"]
    names = ("flash_attention", "flash_attention_bwd", "block_spgemm")
    before = {n: _build.lib_path(n) for n in names}
    header = csrc / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"// edited\n")
    after = {n: _build.lib_path(n) for n in names}
    assert after["flash_attention"] != before["flash_attention"]
    assert after["flash_attention_bwd"] != before["flash_attention_bwd"]
    assert after["block_spgemm"] == before["block_spgemm"]


def _edge_ok(bs: int, g: int, stride: int, n_sub: int, micro: int) -> bool:
    """``edge_ok`` of ``csrc/block_spgemm.cu``'s launcher, transcribed."""
    if g < 1 or stride < micro or stride % micro != 0 \
            or g * stride > K.PANEL:
        return False
    if bs > K.PANEL:
        return g == 1 and stride == K.PANEL \
            and n_sub == (bs + K.PANEL - 1) // K.PANEL
    return stride >= bs and n_sub == 1


@pytest.mark.parametrize("bs_r,bs_c", [(4, 4), (8, 8), (23, 23), (24, 24),
                                       (4, 8), (25, 25), (64, 64), (128, 128),
                                       (4, 128), (30, 7)])
def test_validate_tile_mirrors_the_launchers_checks(bs_r, bs_c):
    """``validate_tile`` accepts exactly the group layouts the launcher
    accepts at the layout's strides (``edge_ok`` per edge, at most 16 mask
    bits), and ``kernel_tile(group=...)`` hands the launcher those."""
    for g_r in range(0, 18):
        for g_c in range(0, 18):
            t = K.kernel_tile(bs_r, bs_c)
            want = (_edge_ok(bs_r, g_r, t.stride_r, t.n_sub_r, K.MICRO[0])
                    and _edge_ok(bs_c, g_c, t.stride_c, t.n_sub_c,
                                 K.MICRO[1])
                    and g_r * g_c <= 16)
            try:
                got = K.validate_tile(bs_r, bs_c, (g_r, g_c)) == (g_r, g_c)
            except ValueError:
                got = False
            assert got == want, (g_r, g_c)
            if want:
                assert K.kernel_tile(bs_r, bs_c, group=(g_r, g_c)) == \
                    t._replace(g_r=g_r, g_c=g_c)
    for bad in ("4x4", (1, 2, 3), None):
        with pytest.raises(ValueError, match="pair"):
            K.validate_tile(bs_r, bs_c, bad)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K.validate_tile(bs_r, bs_c, (1, 1), torch.float64)
    # the tuner ranks the default group only; it is always a valid layout
    assert K.tile_candidates(bs_r, bs_c) == [None]
    d = K.kernel_tile(bs_r, bs_c)[:2]
    assert K.validate_tile(bs_r, bs_c, d) == d


def test_group_layouts_on_the_cpu():
    """The plain version ignores the layout (the result does not depend on
    it); the 23 x 23 blocks of H2O-DFT-LS take 4 x 4, 2 x 2 and 1 x 1."""
    assert K.kernel_tile(23, 23)[:2] == (4, 4)
    a, b, ok = _operands(4, 5, 6, 4, (23, 23, 23), 0.4)
    ta, tb, tok = map(torch.from_numpy, (a, b, ok))
    want = ops.block_spgemm(ta, tb, tok)
    for g in (None, (4, 4), (2, 2), (1, 1)):
        assert torch.equal(ops.block_spgemm(ta, tb, tok, group=g), want)
    with pytest.raises(ValueError, match="panel"):
        K.kernel_tile(23, 23, group=(5, 5))  # 5 x 24 rows > 96


def test_cpu_path_is_differentiable():
    """The CPU path (the plain version) carries gradients to both
    operands: dA_ik = sum_j ok[i,k,j] G_ij B_kj^T and dB_kj = sum_i
    ok[i,k,j] A_ik^T G_ij, against a dense einsum's autograd.  The CUDA
    launch raises instead (tests/test_torch_cuda.py): the kernel has no
    backward."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((3, 4, 5, 6))).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((4, 2, 6, 7))).requires_grad_()
    ok = torch.from_numpy(rng.random((3, 4, 2)) < 0.5)
    g = torch.from_numpy(rng.standard_normal((3, 2, 5, 7)))
    c = K.block_spgemm(a.float(), b.float(), ok)
    got = torch.autograd.grad(c, (a, b), g.float())
    a2, b2 = (t.detach().clone().requires_grad_() for t in (a, b))
    dense = torch.einsum("ikj,ikrs,kjst->ijrt", ok.double(), a2, b2)
    want = torch.autograd.grad(dense, (a2, b2), g)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
