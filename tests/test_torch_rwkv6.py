"""Parity of the port's RWKV-6 mixer (``repro_torch.models.rwkv6``) with the
reference's, on the reduced rwkv6-7b (d 128, 4 heads of 32, decay LoRA
64, chunk 8) on the CPU.

The reference draws the parameters and the port gets them bit for bit;
inputs and carried states come from numpy, with the bonus ``u`` and the
interpolation factors drawn too (the init's constants would leave parts
of the recurrence untested).  Tolerances: 1e-4 at f32 (the same token
loop, other summation orders in the matmuls); 3e-2 at bf16, relative to
each tensor's largest magnitude.  The reference runs as its own tests run
it, eagerly on the CPU; it has no Pallas kernel here.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import rwkv6 as JR
from repro_torch.configs import get_arch
from repro_torch.models import rwkv6 as R

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _params(dtype, seed=0):
    jcfg = dataclasses.replace(jget_arch("rwkv6-7b").reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_arch("rwkv6-7b").reduced(), dtype=dtype)
    jp = JR.init_rwkv(jcfg, jax.random.key(seed), jnp.dtype(dtype))
    rng = np.random.default_rng(seed + 100)
    # f32 leaves the init sets to constants: drawn, so that every term of
    # the recurrence and the shift mix is exercised
    for name in ("mu_rkvg", "mu_w", "mu_c"):
        jp[name] = jnp.asarray(rng.uniform(0, 1, jp[name].shape), jnp.float32)
    jp["bonus_u"] = jnp.asarray(rng.standard_normal(jp["bonus_u"].shape),
                                jnp.float32)
    jp["decay_base"] = jnp.asarray(rng.uniform(-3, 0.5, jp["decay_base"].shape),
                                   jnp.float32)
    jp["ln_x_w"] = jnp.asarray(rng.uniform(0.5, 1.5, jp["ln_x_w"].shape),
                               jnp.float32)
    return jcfg, jp, cfg, _to_torch(jp)


def _state(cfg, dtype, rng):
    h, hd, _ = R.rwkv_dims(cfg)
    d = cfg.d_model
    jst = {
        "shift_t": jnp.asarray(rng.standard_normal((B, d)), jnp.dtype(dtype)),
        "shift_c": jnp.asarray(rng.standard_normal((B, d)), jnp.dtype(dtype)),
        "wkv": jnp.asarray(rng.standard_normal((B, h, hd, hd)), jnp.float32),
    }
    return jst, _to_torch(jst)


def _x(cfg, s, dtype, rng):
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(TDT[dtype])


def _close(got, want, dtype):
    tol = TOL[dtype]
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max())) if dtype == "bfloat16" \
        else tol
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=atol)


def _close_state(got, want, dtype):
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == _to_torch(want)[name].dtype, name
        _close(got[name], want[name], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [5, 8, 24])
def test_time_mix_matches_reference(dtype, s):
    """Output and new state (shift_t, wkv; shift_c untouched) from a
    carried state, over one chunk, a few and a sequence below the
    chunk."""
    jcfg, jp, cfg, p = _params(dtype)
    rng = np.random.default_rng(s)
    jx, x = _x(cfg, s, dtype, rng)
    jst, st = _state(cfg, dtype, rng)
    jy, jnew = JR.apply_rwkv_time_mix(jcfg, jp, jx, jst)
    y, new = R.apply_rwkv_time_mix(cfg, p, x, st)
    assert y.dtype == TDT[dtype] and tuple(y.shape) == (B, s, cfg.d_model)
    _close(y, jy, dtype)
    _close_state(new, jnew, dtype)
    assert torch.equal(new["shift_c"], st["shift_c"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 8, 24])
def test_channel_mix_matches_reference(dtype, s):
    jcfg, jp, cfg, p = _params(dtype, seed=1)
    rng = np.random.default_rng(10 + s)
    jx, x = _x(cfg, s, dtype, rng)
    jst, st = _state(cfg, dtype, rng)
    jy, jnew = JR.apply_rwkv_channel_mix(jcfg, jp, jx, jst)
    y, new = R.apply_rwkv_channel_mix(cfg, p, x, st)
    _close(y, jy, dtype)
    _close_state(new, jnew, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_functions_match_reference(dtype):
    """Three tokens through both decode functions, the state carried."""
    jcfg, jp, cfg, p = _params(dtype, seed=2)
    rng = np.random.default_rng(20)
    jst, st = _state(cfg, dtype, rng)
    for _ in range(3):
        jx, x = _x(cfg, 1, dtype, rng)
        jy, jst = JR.decode_rwkv_time_mix(jcfg, jp, jx, jst)
        y, st = R.decode_rwkv_time_mix(cfg, p, x, st)
        _close(y, jy, dtype)
        _close_state(st, jst, dtype)
        jy, jst = JR.decode_rwkv_channel_mix(jcfg, jp, jy, jst)
        y, st = R.decode_rwkv_channel_mix(cfg, p, y, st)
        _close(y, jy, dtype)
        _close_state(st, jst, dtype)


def test_prefill_then_decode_equals_one_prefill():
    """8 tokens of prefill then 16 decode steps give the outputs and the
    state of one 24-token prefill."""
    _, _, cfg, p = _params("float32", seed=3)
    rng = np.random.default_rng(30)
    _, x = _x(cfg, 24, "float32", rng)
    _, st0 = _state(cfg, "float32", rng)
    want, want_st = R.apply_rwkv_time_mix(cfg, p, x, st0)
    got, st = R.apply_rwkv_time_mix(cfg, p, x[:, :8], st0)
    outs = [got]
    for t in range(8, 24):
        y, st = R.decode_rwkv_time_mix(cfg, p, x[:, t:t + 1], st)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), want, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(st["wkv"], want_st["wkv"], rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(st["shift_t"], want_st["shift_t"])


def test_group_norm_uses_the_population_variance():
    """ln_x divides by hd, not hd - 1 (torch's default ``var`` would)."""
    rng = np.random.default_rng(40)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    gain = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = JR._group_norm(jnp.asarray(x), 4, 16, jnp.asarray(gain))
    got = R._group_norm(torch.from_numpy(x), 4, 16, torch.from_numpy(gain))
    _close(got, want, "float32")
    xs = torch.from_numpy(x).reshape(3, 5, 4, 16)
    unbiased = ((xs - xs.mean(-1, keepdim=True))
                * torch.rsqrt(xs.var(-1, keepdim=True) + 1e-5))
    assert float((got.reshape(3, 5, 4, 16) / torch.from_numpy(gain).reshape(
        4, 16) - unbiased).abs().max()) > 1e-2


def test_sequence_not_a_multiple_of_the_chunk_raises():
    _, _, cfg, p = _params("float32")
    rng = np.random.default_rng(50)
    _, st = _state(cfg, "float32", rng)
    with pytest.raises(ValueError, match="multiple"):
        R.apply_rwkv_time_mix(cfg, p, torch.zeros((B, 12, cfg.d_model)), st)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_matches_reference_layout(dtype):
    """Names, shapes and dtypes of the parameters and of the state; the
    constant leaves equal the reference's init."""
    jcfg = dataclasses.replace(jget_arch("rwkv6-7b").reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_arch("rwkv6-7b").reduced(), dtype=dtype)
    want = _to_torch(JR.init_rwkv(jcfg, jax.random.key(0), jnp.dtype(dtype)))
    got = R.init_rwkv(cfg, torch.Generator().manual_seed(0), TDT[dtype])
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in want.items()}
    for name in ("mu_rkvg", "mu_w", "mu_c", "decay_base", "bonus_u",
                 "ln_x_w"):
        assert torch.equal(got[name], want[name]), name
    jst = _to_torch(JR.init_rwkv_state(jcfg, B, jnp.dtype(dtype)))
    st = R.init_rwkv_state(cfg, B, TDT[dtype], device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in st.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in jst.items()}
    assert not any(t.any() for t in st.values())


def _loop(r, k, v, w, u, s0):
    """The token loop the time mix ran before the chunk op: ``_wkv_step``
    on each token's views, (outputs (T, B, h, hd), the last state)."""
    st, outs = s0, []
    for t in range(r.shape[0]):
        st, o = R._wkv_step(st, r[t][..., None, :], k[t][..., :, None],
                            v[t][..., None, :], w[t][..., :, None],
                            u[None, :, :, None])
        outs.append(o[..., 0, :])
    return torch.stack(outs), st


def _wkv_inputs(t=24, b=2, h=3, hd=8, seed=11):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.05, 0.95, (t, b, h, hd))
                         .astype(np.float32))
    return [f(t, b, h, hd), f(t, b, h, hd), f(t, b, h, hd), w, f(h, hd),
            f(b, h, hd, hd)]


def test_wkv_chunk_equals_the_token_loop_bit_for_bit():
    """``rwkv_wkv_chunk`` (and its op) in f32: the token loop's outputs
    and last state exactly, from a nonzero entry state."""
    ins = _wkv_inputs()
    want = _loop(*ins)
    for run in (R.rwkv_wkv_chunk, R._wkv_chunk_op):
        got = run(*ins)
        assert all(torch.equal(g, x) for g, x in zip(got, want))


def test_wkv_chunk_gradient_matches_autograd_through_the_loop():
    """Three chunks of 8 through ``rwkv_wkv_chunk`` (each backward
    recomputing its states and running the reverse recurrence) against
    autograd through the token loop, every input's gradient (r, k, v, the
    decay, the bonus, the entry state) within 1e-5 of its largest entry."""
    ins = _wkv_inputs()
    rng = np.random.default_rng(12)
    gy = torch.from_numpy(rng.standard_normal(ins[0].shape)
                          .astype(np.float32))
    gs = torch.from_numpy(rng.standard_normal(ins[5].shape)
                          .astype(np.float32))
    a = [t.clone().requires_grad_() for t in ins]
    st, ys = a[5], []
    for c0 in range(0, a[0].shape[0], 8):
        y, st = R.rwkv_wkv_chunk(*(t[c0:c0 + 8] for t in a[:4]), a[4], st)
        ys.append(y)
    got = torch.autograd.grad((torch.cat(ys) * gy).sum() + (st * gs).sum(),
                              a)
    b = [t.clone().requires_grad_() for t in ins]
    y, st = _loop(*b)
    want = torch.autograd.grad((y * gy).sum() + (st * gs).sum(), b)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_time_mix_saves_no_per_token_state():
    """Under autograd the time mix saves one (B, h, hd, hd) state a chunk
    (its entry state), not the token loop's state and update a token."""
    cfg = get_arch("rwkv6-7b").reduced()
    _, _, _, p = _params("float32")
    p = {k: v.requires_grad_() for k, v in p.items()}
    h, hd, _ = R.rwkv_dims(cfg)
    s = 64
    x = torch.randn(B, s, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    st = R.init_rwkv_state(cfg, B, torch.float32, device="cpu")
    states = []

    def pack(t):
        if tuple(t.shape) == (B, h, hd, hd):
            states.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        R.apply_rwkv_time_mix(cfg, p, x, st)
    assert 0 < len(states) <= s // cfg.rwkv.chunk
