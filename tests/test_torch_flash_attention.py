"""Parity of the port's flash attention (plain version, ``ops`` wrapper on
CPU tensors) with the reference's Pallas kernel (interpret mode), its
``ops.flash_attention`` and ``ref.attention_ref``, on the same numpy
inputs.

Tolerances: 2e-4 at f32 (3e-4 with the softcap, whose tanh adds
rounding), as the reference's own kernel tests; 3e-2 at bf16 — the Pallas
kernel rounds p to bf16 before P.V, the plain loop (like the JAX model's
``chunked_attention``) keeps p in f32.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_single
from repro.models import attention as JA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(shapes):
        x = rng.standard_normal(s).astype(np.float32)
        out.append(x * scale if i < 2 else x)
    if dtype == "bfloat16":  # round once, so both sides see the same values
        out = [np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
               for x in out]
    return out


def _t(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(_TORCH[dtype])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _single(q, k, v, dtype, **kw):
    """The port's plain version and wrapper on one head, as (sq, d)."""
    tq, tk, tv = (_t(x, dtype)[None, None] for x in (q, k, v))
    plain = FA.flash_attention_plain(tq, tk, tv, **kw)[0, 0]
    wrapped = ops.flash_attention(tq, tk, tv, **kw)[0, 0]
    return plain.float().numpy(), wrapped.float().numpy()


@pytest.mark.parametrize("sq,skv,d", [(128, 128, 64), (256, 128, 32),
                                      (128, 256, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_shapes_match_pallas(sq, skv, d, causal):
    q, k, v = _inputs(0, [(sq, d), (skv, d), (skv, d)], "float32")
    want = flash_attention_single(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, bq=64,
                                  bkv=64, interpret=True)
    oracle = jref.attention_ref(q, k, v, causal=causal)
    for got in _single(q, k, v, "float32", causal=causal):
        _close(got, want, TOL["float32"])
        _close(got, oracle, TOL["float32"])


@pytest.mark.parametrize("window", [32, 128])
def test_flash_sliding_window_matches_pallas(window):
    q, k, v = _inputs(1, [(256, 64)] * 3, "float32")
    want = flash_attention_single(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=window,
                                  bq=64, bkv=64, interpret=True)
    oracle = jref.attention_ref(q, k, v, causal=True, window=window)
    for got in _single(q, k, v, "float32", causal=True, window=window):
        _close(got, want, TOL["float32"])
        _close(got, oracle, TOL["float32"])


def test_flash_softcap_matches_pallas():
    q, k, v = _inputs(2, [(128, 64)] * 3, "float32", scale=4.0)
    want = flash_attention_single(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, softcap=50.0,
                                  bq=64, bkv=64, interpret=True)
    oracle = jref.attention_ref(q, k, v, causal=True, softcap=50.0)
    for got in _single(q, k, v, "float32", causal=True, softcap=50.0):
        _close(got, want, 3e-4)
        _close(got, oracle, 3e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dtypes_match_pallas(dtype):
    q, k, v = _inputs(3, [(128, 64)] * 3, dtype)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = flash_attention_single(*(jnp.asarray(x, jd) for x in (q, k, v)),
                                  causal=True, interpret=True)
    oracle = jref.attention_ref(*(jnp.asarray(x, jd) for x in (q, k, v)),
                                causal=True)
    for got in _single(q, k, v, dtype, causal=True):
        _close(got, want, TOL[dtype])
        _close(got, oracle, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gqa_batched_matches_ops(dtype):
    """GQA without a repeated K/V, against the reference's repeat + vmap."""
    b, h, hkv, s, d = 2, 8, 2, 128, 32
    q, k, v = _inputs(4, [(b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)],
                      dtype)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jops.flash_attention(*(jnp.asarray(x, jd) for x in (q, k, v)),
                                causal=True, interpret=True)
    got = ops.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                              causal=True)
    assert got.shape == (b, h, s, d) and got.dtype == _TORCH[dtype]
    _close(got.float().numpy(), want, TOL[dtype])
    rep = h // hkv
    oracle = ref.attention_ref(_t(q, dtype), _t(k, dtype).repeat_interleave(
        rep, 1), _t(v, dtype).repeat_interleave(rep, 1), causal=True)
    _close(got.float().numpy(), oracle.float().numpy(), TOL[dtype])


@pytest.mark.parametrize("sq,skv,window,softcap", [
    (200, 200, None, None),  # ragged against both chunks
    (77, 77, 16, None),
    (300, 300, None, 30.0),
    (64, 130, None, None),  # sq != skv, top-left causal
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_ragged_matches_jax(sq, skv, window, softcap,
                                              dtype):
    """The model's ``chunked_attention`` with small chunks, so the ragged
    lengths pad (reference) or slice (port) the last chunk."""
    b, h, hkv, d = 2, 4, 2, 32
    q, k, v = _inputs(5, [(b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)],
                      dtype)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    kw = dict(causal=True, window=window, softcap=softcap, q_chunk=64,
              kv_chunk=48)
    want = JA.chunked_attention(*(jnp.asarray(x, jd) for x in (q, k, v)),
                                **kw)
    got = A.chunked_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype), **kw)
    # the plain loop keeps p in f32 like chunked_attention: f32 tolerance
    # at f32, one output rounding at bf16
    _close(got.float().numpy(), want, TOL[dtype] if dtype == "bfloat16"
           else 2e-5)


def test_attention_ref_matches_reference():
    q, k, v = _inputs(6, [(96, 32), (96, 32), (96, 32)], "float32")
    for kw in (dict(causal=True), dict(causal=False),
               dict(causal=True, window=8), dict(causal=True, softcap=5.0),
               dict(causal=True, window=1, q_offset=0)):
        want = jref.attention_ref(q, k, v, **kw)
        got = ref.attention_ref(_t(q, "float32"), _t(k, "float32"),
                                _t(v, "float32"), **kw)
        _close(got.numpy(), want, 1e-5)


def test_fully_masked_rows_are_zero():
    """A row that keeps no key (q beyond the keys, narrow window, no
    causal link) gives zeros in the plain version, as in the oracle."""
    q, k, v = _inputs(7, [(64, 16), (16, 16), (16, 16)], "float32")
    kw = dict(causal=True, window=4)
    got = FA.flash_attention_plain(*(_t(x, "float32")[None, None]
                                     for x in (q, k, v)), **kw)[0, 0]
    want = ref.attention_ref(_t(q, "float32"), _t(k, "float32"),
                             _t(v, "float32"), **kw)
    assert bool((got[24:] == 0).all())
    _close(got.numpy(), want.numpy(), 1e-5)


def test_cpu_wrapper_launches_no_kernel():
    q, k, v = (torch.randn(1, 2, 16, 32) for _ in range(3))
    before = FA.launches
    ops.flash_attention(q, k, v, causal=True)
    assert FA.launches == before


def test_kernel_entry_refuses_cpu_tensors():
    q = torch.randn(1, 1, 8, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        FA.flash_attention_cuda(q, q, q)


def test_serving_limit_fails_a_wrong_kv_walk():
    """chip_smoke.py's phase 9 holds the bf16 kernel at the serving shape to
    ``flash_serve_limit`` alone (the f32 check runs the other kernel).  The
    limit passes the kernel's own rounding — here p rounded to bf16 before
    P.V, relative to the row's final max — and fails a kernel whose rows
    from 200 on lose their keys past 192 (b 1, h 2, s 256, d 64, causal)."""
    import chip_smoke

    b, h, s, d = 1, 2, 256, 64
    q, k, v = _inputs(8, [(b, h, s, d)] * 3, "bfloat16")
    q, k, v = (_t(x, "bfloat16") for x in (q, k, v))
    plain = FA.flash_attention_plain(q, k, v, causal=True)
    keys = torch.arange(1, s + 1, dtype=torch.float32)
    limit = chip_smoke.flash_serve_limit(plain, keys,
                                         **chip_smoke.FLASH_SERVE_TOL_BF16)

    # p rounded to bf16 before P.V, the running sum unrounded
    logits = (q.float() @ k.float().transpose(-1, -2)) * d**-0.5
    logits = logits.masked_fill(torch.ones(s, s).triu(1).bool(), -1e30)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    rounded = ((p.to(torch.bfloat16).float() @ v.float())
               / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    ratio = (rounded.float() - plain.float()).abs() / limit
    assert float(ratio.max()) <= 1.0

    wrong = plain.clone()
    wrong[:, :, 200:] = FA.flash_attention_plain(
        q[:, :, 200:], k[:, :, :192], v[:, :, :192], causal=False)
    ratio = (wrong.float() - plain.float()).abs() / limit
    assert float(ratio.max()) > 10.0


@pytest.mark.parametrize("sq", [32, 200])
def test_serving_limit_fails_a_dropped_ragged_tail(sq):
    """chip_smoke.py holds the bf16 kernel at whisper's cross-attention (32
    queries) and encoder (1,500) shapes to ``flash_serve_limit`` with every
    row keeping all 1,500 keys (b 1, h 2, skv 1,500, d 64, non-causal, here
    200 queries for the encoder).  The limit passes the kernel's own
    rounding (p rounded to bf16 before P.V) and fails a kernel that drops
    the 92 keys past the last 128-key tile."""
    import chip_smoke

    b, h, skv, d = 1, 2, 1500, 64
    q, k, v = _inputs(9, [(b, h, sq, d), (b, h, skv, d), (b, h, skv, d)],
                      "bfloat16")
    q, k, v = (_t(x, "bfloat16") for x in (q, k, v))
    plain = FA.flash_attention_plain(q, k, v, causal=False)
    keys = torch.full((sq,), float(skv))
    limit = chip_smoke.flash_serve_limit(plain, keys,
                                         **chip_smoke.FLASH_SERVE_TOL_BF16)

    logits = (q.float() @ k.float().transpose(-1, -2)) * d**-0.5
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    rounded = ((p.to(torch.bfloat16).float() @ v.float())
               / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    ratio = (rounded.float() - plain.float()).abs() / limit
    assert float(ratio.max()) <= 1.0

    tiled = skv // 128 * 128  # 1,408: the keys of the full tiles
    wrong = FA.flash_attention_plain(q, k[:, :, :tiled], v[:, :, :tiled],
                                     causal=False)
    ratio = (wrong.float() - plain.float()).abs() / limit
    assert float(ratio.max()) > 10.0


@pytest.mark.parametrize("shape,causal,want_ms", [
    ((8, 20, 20, 1500, 1500, 64), False, 0.0932),  # whisper's encoder
    ((8, 32, 8, 1024, 1024, 128), True, 0.0696),  # pixtral's text prefill
])
def test_flash_bound_counts_kept_pairs(shape, causal, want_ms):
    """chip_smoke.py's bound: 4 d operations per kept (q, k) pair at the
    bf16 tensor rate, which binds at these shapes (9.22e10 operations for
    whisper's encoder, 6.88e10 for pixtral's 524,800 pairs a head)."""
    import chip_smoke

    ms, by = chip_smoke._flash_bound(*shape, 2, causal)
    assert by == "operations"
    assert ms == pytest.approx(want_ms, abs=5e-5)
