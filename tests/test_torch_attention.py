"""Parity of the port's attention module (``repro_torch.models.attention``)
with the reference's, on the same numpy inputs and weights.

Tolerances: 2e-5 at f32 (same arithmetic, other summation order); 3e-2 at
bf16 (the reference's bf16 tolerance: one rounding of the output, and of
p before P.V in decode, in either package).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ArchConfig as JArchConfig
from repro.models import attention as JA
from repro_torch.config import ArchConfig
from repro_torch.models import attention as A

_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _pair(x, dtype):
    """The same values on both sides (rounded once to the dtype)."""
    j = jnp.asarray(x, _J[dtype])
    return j, torch.from_numpy(np.array(j, np.float32)).to(_T[dtype])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("hkv", [4, 2])
def test_projections_match(qkv_bias, hkv):
    base = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=hkv, d_ff=96, vocab=50, qkv_bias=qkv_bias,
                dtype="float32")
    jcfg, cfg = JArchConfig(**base), ArchConfig(**base)
    rng = np.random.default_rng(0)
    shapes = {"wq": (64, 64), "wk": (64, hkv * 16), "wv": (64, hkv * 16),
              "wo": (64, 64)}
    if qkv_bias:
        shapes.update(bq=(64,), bk=(hkv * 16,), bv=(hkv * 16,))
    p = {k: (rng.standard_normal(s) / 8).astype(np.float32)
         for k, s in shapes.items()}
    init = A.init_attention(cfg, torch.Generator().manual_seed(0),
                            torch.float32)
    assert {k: tuple(v.shape) for k, v in init.items()} == shapes
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = JA.qkv_proj(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    got = A.qkv_proj(cfg, tp, torch.from_numpy(x), torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w, TOL["float32"])
    o = rng.standard_normal((2, 4, 9, 16)).astype(np.float32)
    _close(A.out_proj(cfg, tp, torch.from_numpy(o)).numpy(),
           JA.out_proj(jcfg, jp, jnp.asarray(o)), TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,window", [(45, None), (45, 8), (130, 40)])
def test_chunked_attention_padding_and_window(dtype, sq, window):
    """Lengths that do not divide the chunks: the reference pads and masks
    the padded keys, the port slices; GQA 4:2."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 4, sq, 16))
    k = rng.standard_normal((2, 2, sq, 16))
    v = rng.standard_normal((2, 2, sq, 16))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    kw = dict(causal=True, window=window, q_chunk=32, kv_chunk=16)
    want = JA.chunked_attention(jq, jk, jv, **kw)
    got = A.chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == _T[dtype] and tuple(got.shape) == want.shape
    _close(got.float().numpy(), want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vector", [False, True])
@pytest.mark.parametrize("window,softcap", [(None, None), (6, None),
                                            (None, 20.0)])
def test_decode_attention_matches(dtype, vector, window, softcap):
    rng = np.random.default_rng(2)
    b, h, hkv, smax, d = 3, 4, 2, 24, 16
    q = rng.standard_normal((b, h, 1, d))
    kc = rng.standard_normal((b, hkv, smax, d))
    vc = rng.standard_normal((b, hkv, smax, d))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kc, vc))
    length = np.array([5, 17, 24], np.int32) if vector else np.int32(11)
    kw = dict(window=window, softcap=softcap)
    want = JA.decode_attention(jq, jk, jv, jnp.asarray(length), **kw)
    got = A.decode_attention(tq, tk, tv, torch.as_tensor(length), **kw)
    assert got.dtype == _T[dtype] and tuple(got.shape) == want.shape
    _close(got.float().numpy(), want, TOL[dtype])
