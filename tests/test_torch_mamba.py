"""Parity of the port's mamba mixer (``repro_torch.models.mamba``) with the
reference's, on the reduced jamba-v0.1-52b (d 128, d_inner 256, d_state
16, chunk 8) on the CPU.

The reference draws the parameters and the port gets them bit for bit;
inputs and carried states come from numpy.  Tolerances: 1e-4 at f32 (the
reference scans a chunk associatively, the port in token order: the same
recurrence in another association order); 3e-2 at bf16, relative to each
tensor's largest magnitude (the two packages round bf16 matmul outputs at
other places).  The reference's prefill runs as its own tests run it,
eagerly on the CPU; it has no Pallas kernel.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as jget_arch
from repro.models import mamba as JM
from repro_torch.configs import get_arch
from repro_torch.models import mamba as M

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(jget_arch("jamba-v0.1-52b").reduced(),
                               dtype=dtype)
    cfg = dataclasses.replace(get_arch("jamba-v0.1-52b").reduced(),
                              dtype=dtype)
    return jcfg, cfg


def _to_torch(tree):
    """numpy / jax leaves -> tensors of the same dtype (bf16 through f32,
    exact)."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _params(dtype, seed=0):
    jcfg, cfg = _cfgs(dtype)
    jp = JM.init_mamba(jcfg, jax.random.key(seed), jnp.dtype(dtype))
    return jcfg, jp, cfg, _to_torch(jp)


def _state(cfg, dtype, rng):
    """A carried state that is not zero: a conv tail in the model dtype
    and an f32 SSM state."""
    di, n, dc, _ = M.mamba_dims(cfg)
    conv = rng.standard_normal((B, dc - 1, di)).astype(np.float32)
    ssm = rng.standard_normal((B, di, n)).astype(np.float32)
    jst = {"conv": jnp.asarray(conv, jnp.dtype(dtype)),
           "ssm": jnp.asarray(ssm)}
    return jst, _to_torch(jst)


def _close(got, want, dtype):
    tol = TOL[dtype]
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max())) if dtype == "bfloat16" \
        else tol
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=atol)


def _x(cfg, s, dtype, rng):
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(TDT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [5, 8, 24, 40])
@pytest.mark.parametrize("carried", [False, True])
def test_apply_mamba_matches_reference(dtype, s, carried):
    """Output and final state (conv tail, SSM state) over one chunk, a
    few chunks and a sequence below the chunk, from zero or from a
    carried state."""
    jcfg, jp, cfg, p = _params(dtype)
    rng = np.random.default_rng(s)
    jx, x = _x(cfg, s, dtype, rng)
    jst, st = _state(cfg, dtype, rng) if carried else (None, None)
    jy, jnew = JM.apply_mamba(jcfg, jp, jx, jst)
    y, new = M.apply_mamba(cfg, p, x, st)
    assert y.dtype == TDT[dtype] and tuple(y.shape) == (B, s, cfg.d_model)
    _close(y, jy, dtype)
    assert new["conv"].dtype == TDT[dtype] and new["ssm"].dtype == torch.float32
    _close(new["conv"], jnew["conv"], dtype)
    _close(new["ssm"], jnew["ssm"], dtype)
    if carried:  # the state it was given is left as it was
        assert torch.equal(st["ssm"], _to_torch(jst)["ssm"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_mamba_matches_reference(dtype):
    jcfg, jp, cfg, p = _params(dtype, seed=1)
    rng = np.random.default_rng(7)
    jst, st = _state(cfg, dtype, rng)
    for _ in range(3):
        jx, x = _x(cfg, 1, dtype, rng)
        jy, jst = JM.decode_mamba(jcfg, jp, jx, jst)
        y, st = M.decode_mamba(cfg, p, x, st)
        _close(y, jy, dtype)
        _close(st["conv"], jst["conv"], dtype)
        _close(st["ssm"], jst["ssm"], dtype)


@pytest.mark.parametrize("split", [7, 16])
def test_prefill_then_decode_equals_one_prefill(split):
    """Prefill of ``split`` tokens, then one decode step per token, gives
    the outputs and state of a prefill over all 24 (7 + 17 decode steps,
    16 + 8): the carried state is the whole history."""
    _, _, cfg, p = _params("float32", seed=2)
    rng = np.random.default_rng(3)
    _, x = _x(cfg, 24, "float32", rng)
    want, want_st = M.apply_mamba(cfg, p, x)
    got, st = M.apply_mamba(cfg, p, x[:, :split])
    outs = [got]
    for t in range(split, 24):
        y, st = M.decode_mamba(cfg, p, x[:, t:t + 1], st)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), want, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(st["ssm"], want_st["ssm"], rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(st["conv"], want_st["conv"])


def test_decay_underflow_stays_finite():
    """dt large enough that exp(dt A) underflows to 0 within a chunk: the
    scan multiplies and adds only (no division by a running decay), so
    the output stays finite and equal to the reference's."""
    jcfg, jp, cfg, p = _params("float32", seed=4)
    jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"], 12.0))
    p = dict(p, dt_bias=torch.full_like(p["dt_bias"], 12.0))
    rng = np.random.default_rng(5)
    jx, x = _x(cfg, 16, "float32", rng)
    di, _, _, _ = M.mamba_dims(cfg)
    da, _, _ = M._ssm_coeffs(cfg, p, torch.zeros((B, 8, di)))
    assert float(da.min()) == 0.0  # exp(-12 * 16) is below f32's range
    jy, jst = JM.apply_mamba(jcfg, jp, jx)
    y, st = M.apply_mamba(cfg, p, x)
    assert bool(torch.isfinite(y).all() and torch.isfinite(st["ssm"]).all())
    _close(y, jy, "float32")
    _close(st["ssm"], jst["ssm"], "float32")


class _Largest(TorchDispatchMode):
    """Records the element count of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.sizes.append(t.numel())
        return out


def test_prefill_builds_coefficients_per_chunk():
    """Over 5 chunks, no op returns a (B, S, d_inner, d_state) tensor: the
    largest is one chunk's (B, chunk, d_inner, d_state)."""
    _, _, cfg, p = _params("float32", seed=6)
    di, n, _, _ = M.mamba_dims(cfg)
    chunk, s = cfg.mamba.chunk, 5 * cfg.mamba.chunk
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32))
    with _Largest() as seen:
        M.apply_mamba(cfg, p, x)
    assert max(seen.sizes) == B * chunk * di * n < B * s * di * n


def test_sequence_not_a_multiple_of_the_chunk_raises():
    _, _, cfg, p = _params("float32")
    x = torch.zeros((B, 12, cfg.d_model))
    with pytest.raises(ValueError, match="multiple"):
        M.apply_mamba(cfg, p, x)
    with pytest.raises(AssertionError):  # the reference refuses it too
        jcfg, jp, _, _ = _params("float32")
        JM.apply_mamba(jcfg, jp, jnp.zeros((B, 12, cfg.d_model)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_matches_reference_layout(dtype):
    """Names, shapes and dtypes of the parameters and the state; the
    deterministic leaves (A, D, conv bias) equal the reference's."""
    _, jp, cfg, want = _params(dtype)
    got = M.init_mamba(cfg, torch.Generator().manual_seed(0), TDT[dtype])
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in want.items()}
    for name in ("d_skip", "conv_b"):
        assert torch.equal(got[name], want[name])
    # log(1 .. d_state): the two libraries' logs may differ by an ulp
    torch.testing.assert_close(got["a_log"], want["a_log"], rtol=2e-7,
                               atol=0.0)
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    jcfg, _ = _cfgs(dtype)
    jst = JM.init_mamba_state(jcfg, B, jnp.dtype(dtype))
    st = M.init_mamba_state(cfg, B, TDT[dtype], device="cpu")
    for name in ("conv", "ssm"):
        want_t = _to_torch(jst)[name]
        assert st[name].dtype == want_t.dtype and st[name].shape == want_t.shape
        assert not st[name].any()
