"""Parity of the port's model primitives (``repro_torch.models.layers``)
with the reference's, on the same numpy inputs and parameters.

Tolerances: 1e-5 at f32 (the same arithmetic, other summation order and
transcendental implementations); the norms and rope are computed in f32
in both packages.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ArchConfig as JArchConfig
from repro.models import layers as JL
from repro_torch.config import ArchConfig
from repro_torch.models import layers as L

TOL = 1e-5


def _cfgs(**kw):
    base = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, d_ff=96, vocab=50, dtype="float32")
    base.update(kw)
    return JArchConfig(**base), ArchConfig(**base)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparametric_ln"])
def test_norms_match(norm):
    jcfg, cfg = _cfgs(norm=norm)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    p = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in JL.init_norm(jcfg, 64).items()}
    want = JL.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = L.apply_norm(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x))
    _close(got.numpy(), want)
    init = L.init_norm(cfg, 64, device="cpu")
    assert sorted(init) == sorted(JL.init_norm(jcfg, 64))
    for k, v in init.items():
        _close(v.numpy(), JL.init_norm(jcfg, 64)[k], 0)


@pytest.mark.parametrize("pos_shape", ["1d", "2d"])
def test_rope_matches(pos_shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 7, 32)).astype(np.float32)
    if pos_shape == "1d":
        pos = np.arange(7, dtype=np.int32) + 5
    else:  # per-slot positions (serving refill)
        pos = rng.integers(0, 500, (3, 7)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    # angles up to ~500 rad: f32 sin/cos of the same f32 angle
    _close(got.numpy(), want, 2e-4)
    _close(L.rope_freqs(32, 10_000.0).numpy(), JL.rope_freqs(32, 10_000.0))


def test_sinusoidal_positions_match():
    _close(L.sinusoidal_positions(40, 16).numpy(),
           JL.sinusoidal_positions(40, 16))


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu"])
def test_mlps_match(mlp):
    jcfg, cfg = _cfgs(mlp=mlp)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = {"w_in": rng.standard_normal((64, 96)) / 8,
         "w_out": rng.standard_normal((96, 64)) / 10}
    if mlp != "gelu":
        p["w_gate"] = rng.standard_normal((64, 96)) / 8
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = JL.apply_mlp(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    got = L.apply_mlp(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x))
    _close(got.numpy(), want)
    init = L.init_mlp(cfg, torch.Generator().manual_seed(0), 64, 96,
                      torch.float32)
    assert sorted(init) == sorted(p)


@pytest.mark.parametrize("tied,softcap", [(True, None), (False, 30.0)])
def test_embed_and_logits_match(tied, softcap):
    jcfg, cfg = _cfgs(tie_embeddings=tied, final_softcap=softcap)
    rng = np.random.default_rng(3)
    p = {"tok": rng.standard_normal((50, 64)).astype(np.float32)}
    if not tied:
        p["out"] = rng.standard_normal((50, 64)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 6)).astype(np.int32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    x = L.embed_tokens(tp, torch.from_numpy(toks).long())
    _close(x.numpy(), JL.embed_tokens(jp, jnp.asarray(toks)), 0)
    want = JL.logits_matmul(jcfg, jp, jnp.asarray(x.numpy()))
    _close(L.logits_matmul(cfg, tp, x).numpy(), want, 1e-4)
    init = L.init_embed(cfg, torch.Generator().manual_seed(0), torch.float32)
    assert sorted(init) == sorted(p)
    assert init["tok"].shape == (50, 64)


def test_init_draws_on_the_generator_and_casts():
    _, cfg = _cfgs()
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    a = L.init_mlp(cfg, g1, 64, 96, torch.bfloat16)
    b = L.init_mlp(cfg, g2, 64, 96, torch.bfloat16)
    for k in a:
        assert a[k].dtype == torch.bfloat16 and torch.equal(a[k], b[k])
    # the reference's scale: N(0, 1) / sqrt(fan_in)
    big = L.init_mlp(dataclasses.replace(cfg, mlp="gelu"),
                     torch.Generator().manual_seed(1), 256, 512,
                     torch.float32)
    assert abs(float(big["w_in"].std()) - 256**-0.5) < 0.01 * 256**-0.5 * 10
