"""The block-SpGEMM kernel module on the CPU: its plain version against the
JAX reference (the Pallas kernel in interpret mode and the ``ref``
oracle), the wrapper's dispatch and checks, and the pure-Python parts the
CUDA launch depends on (tile runs, thread-block shapes).

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.stacks import bucket_capacity
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
    if hasattr(torch, "float8_e4m3fn"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ops.block_spgemm(ta.to(torch.float8_e4m3fn),
                             tb.to(torch.float8_e4m3fn), tok)
    with pytest.raises(TypeError):
        ops.block_spgemm(ta.double(), tb.double(), tok)
    with pytest.raises(TypeError):
        ops.block_spgemm(ta, tb.to(torch.bfloat16), tok)
    with pytest.raises(ValueError):
        ops.block_spgemm(ta, tb[:, :, :3], tok)
    with pytest.raises(ValueError):
        ops.block_spgemm(ta, tb, tok[:, :, :1])
    st = stacks.compact_pair_mask(tok, capacity=8)
    with pytest.raises(ValueError, match="CUDA"):  # the launcher is CUDA-only
        K.block_spgemm_runs(ta, tb, st.ik, K.tile_runs(st), ni=2, nj=2)


@pytest.mark.parametrize("capacity", ["exact", "padded", "tight"])
def test_tile_runs_cover_the_valid_list(capacity):
    _, _, ok = _operands(5, 5, 6, 4, (2, 2, 2), 0.5)
    n = int(ok.sum())
    cap = {"exact": bucket_capacity(n), "padded": 4 * bucket_capacity(n),
           "tight": n - 5}[capacity]
    st = stacks.compact_pair_mask(torch.from_numpy(ok), capacity=cap)
    runs = K.tile_runs(st)
    for t in runs:
        assert t.dtype == torch.int32
    ia, ij = st.ia.numpy(), st.ij.numpy()
    tile, valid, ik = st.tile.numpy(), st.valid.numpy(), st.ik.numpy()
    n_valid = int(valid.sum())
    # numpy walk of the valid entries: one run per distinct tile, in order
    want = []
    for p in range(n_valid):
        if p == 0 or tile[p] != tile[p - 1]:
            want.append([ia[p], ij[p], p, 0])
        want[-1][3] += 1
    got = np.stack([t.numpy() for t in runs], axis=1)
    np.testing.assert_array_equal(got, np.array(want).reshape(-1, 4))
    # each run lists exactly the surviving k's of its tile, ascending
    for i, j, s, ln in got:
        if capacity != "tight" or s + ln < n_valid:
            np.testing.assert_array_equal(ik[s:s + ln], np.flatnonzero(ok[i, :, j]))


@pytest.mark.parametrize("bs_r,bs_c", [(4, 4), (8, 8), (23, 23), (24, 24),
                                       (4, 8), (25, 25), (64, 64), (128, 128),
                                       (4, 128), (30, 7)])
def test_kernel_tile_fits_the_cuda_instantiations(bs_r, bs_c):
    r, ty, tx = K.kernel_tile(bs_r, bs_c)
    tmax, max_threads = {3: (24, 64), 4: (64, 256)}[r]
    assert ty * r <= tmax and tx * r <= tmax
    assert ty * tx <= max_threads
    # the sub-tiles cover the block; a block within one sub-tile has one
    assert -(-bs_r // (ty * r)) * ty * r >= bs_r
    if bs_r <= tmax and bs_c <= tmax:
        assert ty * r >= bs_r and tx * r >= bs_c


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
