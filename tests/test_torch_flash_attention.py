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

import jax
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


# ---------------------------------------------------------------------------
# the backward: plain version, lse, the autograd Function
# ---------------------------------------------------------------------------

# (b, h, hkv, sq, skv, d, causal, window, softcap, q_offset); chunks of 48
# queries and 40 keys make every length ragged against them
BWD_CASES = [
    (2, 4, 2, 100, 100, 32, True, None, None, 0),  # GQA 2:1, causal
    (1, 2, 2, 70, 90, 16, False, None, None, 0),  # sq != skv, no mask
    (1, 4, 1, 96, 96, 16, True, 24, None, 0),  # window, GQA 4:1
    (1, 2, 2, 80, 80, 32, True, None, 30.0, 0),  # softcap
    (1, 2, 1, 60, 60, 16, True, 16, 50.0, 0),  # window and softcap
    (1, 2, 2, 50, 120, 16, True, None, None, 70),  # query offset
    (1, 2, 2, 90, 40, 16, True, 8, None, 0),  # rows 47+ keep no key
]


def _dense64(q, k, v, *, causal, window, softcap, q_offset):
    """float64 softmax attention with the kernel's masks; a row that keeps
    no key gives zeros (and an lse of +inf)."""
    b, h, sq, d = q.shape
    g = h // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    x = q @ k.transpose(-1, -2) * d**-0.5
    if softcap is not None:
        x = torch.tanh(x / softcap) * softcap
    keep = FA._keep_mask(q_offset + torch.arange(sq),
                         torch.arange(k.shape[2]), k.shape[2], causal, window)
    any_key = keep.any(-1)
    x = x.masked_fill(~keep, float("-inf"))
    p = torch.softmax(torch.where(any_key[:, None], x, 0.0), -1)
    out = torch.where(keep, p, 0.0) @ v
    lse = torch.where(any_key, torch.logsumexp(x, -1), float("inf"))
    return out, lse


def _bwd_inputs(case, seed=0, dtype=torch.float64):
    b, h, hkv, sq, skv, d, *_ = case
    rng = np.random.default_rng(seed)
    amp = 3.0 if case[8] else 1.0  # logits that reach the cap
    mk = lambda shape, a=1.0: torch.from_numpy(
        rng.standard_normal(shape) * a).to(dtype)
    return (mk((b, h, sq, d), amp), mk((b, hkv, skv, d), amp),
            mk((b, hkv, skv, d)), mk((b, h, sq, d)))


def _kw(case):
    return dict(causal=case[6], window=case[7], softcap=case[8],
                q_offset=case[9])


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_plain_backward_matches_float64_autograd(case):
    """lse, dq, dk and dv of the plain versions (f32, small chunks)
    against autograd through float64 dense attention, within 1e-5
    relative to each tensor's largest magnitude; a row that keeps no key
    has lse +inf and no gradient."""
    q, k, v, do = _bwd_inputs(case)
    kw = _kw(case)
    q64, k64, v64 = (t.clone().requires_grad_() for t in (q, k, v))
    out64, lse64 = _dense64(q64, k64, v64, **kw)
    want = torch.autograd.grad(out64, (q64, k64, v64), do)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    out, lse = FA.flash_attention_plain_lse(q32, k32, v32, q_chunk=48,
                                            kv_chunk=40, **kw)
    torch.testing.assert_close(out.double(), out64.detach(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse64))
    fin = torch.isfinite(lse64)
    torch.testing.assert_close(lse.double()[fin], lse64[fin], rtol=1e-6,
                               atol=1e-5)
    got = FA.flash_attention_backward_plain(q32, k32, v32, out, lse, do32,
                                            q_chunk=48, kv_chunk=40, **kw)
    for g, w, like in zip(got, want, (q, k, v)):
        assert g.dtype == torch.float32 and g.shape == like.shape
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g.double(), w, rtol=1e-5,
                                   atol=1e-5 * scale)
    if not fin.all():  # the rows without a key pass no gradient
        assert bool((got[0][:, :, ~fin[0, 0]] == 0).all())


@pytest.mark.parametrize("case", [c for c in BWD_CASES if c[9] == 0
                                  and c[3] <= c[4]], ids=str)
def test_plain_backward_matches_jax_grad_of_reference(case):
    """dq, dk and dv against ``jax.grad`` of the reference's
    ``chunked_attention`` (f32, the same chunks) within 1e-4.  Cases where
    every row keeps a key: the reference gives a row with none the mean of
    its chunk's values where the port gives zeros."""
    q, k, v, do = (t.float().numpy() for t in _bwd_inputs(case, seed=1))
    kw = dict(causal=case[6], window=case[7], softcap=case[8], q_chunk=48,
              kv_chunk=40)

    def jloss(qq, kk, vv):
        return jnp.sum(JA.chunked_attention(qq, kk, vv, **kw) * do)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = FA.flash_attention_plain_lse(tq, tk, tv, **kw)
    got = FA.flash_attention_backward_plain(tq, tk, tv, out, lse, tdo, **kw)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_gradient_on_cpu(dtype):
    """With grad enabled ``flash_attention`` (and the model's
    ``chunked_attention``) goes through ``FlashAttention``: the plain
    forward's values and the plain backward's gradients, in the inputs'
    dtype, and no kernel launch on CPU tensors."""
    case = (2, 4, 2, 64, 64, 32, True, None, 30.0, 0)
    q, k, v, do = (t.to(_TORCH[dtype]) for t in _bwd_inputs(case, seed=2))
    kw = _kw(case)
    leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (FA.launches, FA.bwd_launches)
    out = A.chunked_attention(*leaves_, q_chunk=32, kv_chunk=16, **kw)
    assert out.grad_fn is not None and out.dtype == _TORCH[dtype]
    got = torch.autograd.grad(out, leaves_, do)
    assert (FA.launches, FA.bwd_launches) == before
    plain, lse = FA.flash_attention_plain_lse(q, k, v, q_chunk=32,
                                              kv_chunk=16, **kw)
    assert torch.equal(out.detach(), plain)
    want = FA.flash_attention_backward_plain(q, k, v, plain, lse, do,
                                             q_chunk=32, kv_chunk=16, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == _TORCH[dtype]
        assert torch.equal(g, w)


def test_no_grad_path_is_the_serving_path():
    """No input that requires grad, or grad disabled: the plain forward
    exactly, with no autograd graph."""
    q, k, v, _ = (t.float() for t in _bwd_inputs(BWD_CASES[0]))
    want = FA.flash_attention_plain(q, k, v, causal=True)
    got = FA.flash_attention(q, k, v, causal=True)
    assert got.grad_fn is None and torch.equal(got, want)
    with torch.no_grad():
        got = FA.flash_attention(q.requires_grad_(), k, v, causal=True)
    assert got.grad_fn is None and torch.equal(got, want)


def test_backward_kernel_entry_refuses_cpu_tensors():
    q = torch.randn(1, 1, 8, 32)
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        FA.flash_attention_backward_cuda(q, q, q, q, lse, q)


def test_flash_backward_bound_at_olmo_training_shape():
    """chip_smoke.py's bound of the backward: five products of 2 d
    operations per kept (q, k) pair at the bf16 tensor rate; 3.44e11
    operations at olmo-1b's training shape, 0.347 ms."""
    import chip_smoke

    ms, by = chip_smoke._flash_bwd_bound(8, 16, 16, 2048, 2048, 128, 2, True)
    assert by == "operations"
    assert ms == pytest.approx(0.3475, abs=5e-4)


@pytest.fixture(scope="module")
def olmo_backward():
    """The plain backward at olmo-1b's training sequence and head dim (s
    2,048, d 128, causal, bf16), one batch row and two heads: inputs,
    forward out and lse, (dq, dk, dv), and chip_smoke.py's kept pairs."""
    import chip_smoke

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    b, h, s, d = 1, 2, 2048, 128
    x = [_t(a, "bfloat16") for a in _inputs(10, [(b, h, s, d)] * 4,
                                             "bfloat16")]
    out, lse = FA.flash_attention_plain_lse(*x[:3], causal=True)
    want = FA.flash_attention_backward_plain(*x[:3], out, lse, x[3])
    yield x, out, lse, want, chip_smoke.flash_bwd_kept(torch, s, s, 1)
    torch.set_num_threads(threads)


def test_backward_limit_passes_another_summation_order(olmo_backward):
    """chip_smoke.py holds the bf16 backward kernels at olmo-1b's training
    shape to ``flash_bwd_ratio``'s limit over each row's and key's kept
    pairs.  The kernels compute the same f32 function in 64 x 64 tiles and
    round once: the plain backward in 64 x 64 chunks stands in for them
    and passes."""
    import chip_smoke

    x, out, lse, want, kept = olmo_backward
    tiled = FA.flash_attention_backward_plain(*x[:3], out, lse, x[3],
                                              q_chunk=64, kv_chunk=64)
    ratio, _ = chip_smoke.flash_bwd_ratio(tiled, want, kept, "bfloat16")
    assert ratio <= 1.0


def _backward_bf16_operands(q, k, v, out, lse, dout, *, split, q_chunk=64,
                            kv_chunk=128):
    """The plain backward's f32 algorithm (causal) with P and dS rounded
    to bf16 before their products, as the tensor-core kernels feed them
    to ``wgmma``: once, or (``split``) as hi = bf16(x) plus lo = bf16(x -
    hi); sums in f32 over q_chunk x kv_chunk tiles."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g, scale = h // hkv, d**-0.5

    def rnd(t):
        hi = t.to(torch.bfloat16).float()
        return hi + (t - hi).to(torch.bfloat16).float() if split else hi

    qg, dog = (t.reshape(b, hkv, g, sq, d).float() for t in (q, dout))
    delta = (dog * out.reshape(b, hkv, g, sq, d).float()).sum(-1)
    lseg = lse.reshape(b, hkv, g, sq)
    dq = torch.zeros((b, hkv, g, sq, d))
    dk = torch.zeros((b, hkv, skv, d))
    dv = torch.zeros((b, hkv, skv, d))
    for q0 in range(0, sq, q_chunk):
        qi, doi = qg[:, :, :, q0:q0 + q_chunk], dog[:, :, :, q0:q0 + q_chunk]
        cq = qi.shape[3]
        li = lseg[:, :, :, q0:q0 + cq, None]
        di = delta[:, :, :, q0:q0 + cq, None]
        qpos = q0 + torch.arange(cq)
        for k0 in range(0, skv, kv_chunk):
            ki = k[:, :, None, k0:k0 + kv_chunk].float()
            vi = v[:, :, None, k0:k0 + kv_chunk].float()
            keep = FA._keep_mask(qpos, k0 + torch.arange(ki.shape[3]), skv,
                                 True, None)
            p = torch.where(keep, torch.exp(
                torch.matmul(qi, ki.transpose(-1, -2)) * scale - li), 0.0)
            ds = p * (torch.matmul(doi, vi.transpose(-1, -2)) - di) * scale
            p, ds = rnd(p), rnd(ds)
            dv[:, :, k0:k0 + kv_chunk] += torch.matmul(
                p.transpose(-1, -2), doi).sum(2)
            dq[:, :, :, q0:q0 + cq] += torch.matmul(ds, ki)
            dk[:, :, k0:k0 + kv_chunk] += torch.matmul(
                ds.transpose(-1, -2), qi).sum(2)
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@pytest.mark.parametrize("split", [True, False])
def test_backward_limit_holds_bf16_operands_only_split(olmo_backward, split):
    """The tensor-core backward feeds P and dS to its dV, dK and dQ
    products as bf16 hi + lo pairs, in 64 x 128 tiles: that stays inside
    the unchanged limit at olmo-1b's training shape (about 0.71 of it).
    One bf16 rounding of each (2^-9 relative a term) would not: an early
    key's dK / dV sums ~2,000 queries whose first terms are large and
    cancel, and the rounding moves it to about 12 times its limit."""
    import chip_smoke

    x, out, lse, want, kept = olmo_backward
    got = _backward_bf16_operands(*x[:3], out, lse, x[3], split=split)
    ratio, _ = chip_smoke.flash_bwd_ratio(got, want, kept, "bfloat16")
    assert (ratio <= 1.0) == split, ratio


@pytest.mark.parametrize("fault", ["dk_dv_past_1280", "dq_misses_keys"])
def test_backward_limit_fails_a_dropped_key_range(olmo_backward, fault):
    """The same limit fails a kernel that leaves dK and dV zero past key
    1,280, or whose dQ rows from 1,280 on miss the keys past 1,024: the
    late keys' and rows' gradients (|dK|, |dV| about 0.013 on average
    here) are small beside the early keys' (up to 4.6), so a limit that
    is a share of each tensor's largest entry would let such faults
    pass."""
    import chip_smoke

    x, out, lse, want, kept = olmo_backward
    dq, dk, dv = (t.clone() for t in want)
    if fault == "dk_dv_past_1280":
        dk[:, :, 1280:] = 0
        dv[:, :, 1280:] = 0
    else:
        q, k, v, do = x
        dq[:, :, 1280:] = FA.flash_attention_backward_plain(
            q[:, :, 1280:], k[:, :, :1024], v[:, :, :1024],
            out[:, :, 1280:], lse[:, :, 1280:], do[:, :, 1280:],
            causal=False)[0]
    ratio, _ = chip_smoke.flash_bwd_ratio((dq, dk, dv), want, kept,
                                          "bfloat16")
    assert ratio > 10.0
