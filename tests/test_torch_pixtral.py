"""Parity of pixtral-12b's early fusion in the port with the reference, on
the reduced config (2 layers, d 128, GQA 4:2 at head dim 32, 8 patches,
rope theta 1e9) with the reference's parameters carried across by
``interop.params_from_jax``.

The stub patch embeddings replace the first ``n_patches`` token
embeddings.  Compared: ``forward`` with patches, ``prefill`` with patches
(logits and the K/V cache), decode steps at per-slot and at scalar
positions, and the serving engine's greedy tokens on text-only prompts.
Tolerances are ``test_torch_transformer.py``'s: 1e-4 at f32, 3e-2 of the
tensor's largest magnitude at bf16.  Patches and tokens come from numpy
with a seed; bf16 patches are the f32 draws rounded once, the same way in
both packages.  A prompt shorter than the prefix raises ``ValueError`` in
the port (the reference's concatenation lengthens the sequence instead).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import transformer as JT
from repro.serving.engine import GenerationConfig as JGen
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.launch import serve as serve_launch
from repro_torch.models import transformer as T
from repro_torch.serving.engine import GenerationConfig, ServingEngine

ARCH = "pixtral-12b"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
B, S, MAX_LEN = 2, 21, 32


def _models(dtype="float32"):
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype=dtype)
    jp = JT.init_params(jcfg, jax.random.key(0))
    p = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    return jcfg, jp, cfg, p


def _close(got, want, tol, dtype="float32"):
    want = np.asarray(want, np.float32)
    atol = tol
    if dtype == "bfloat16":
        atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=atol)


def _patches(cfg, seed=0, batch=B):
    """The same patch embeddings for both packages, in the model dtype."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, cfg.n_patches, cfg.d_model),
                            dtype=np.float32) * 0.02
    return (jnp.asarray(x, dtype=cfg.dtype),
            torch.from_numpy(x).to(getattr(torch, cfg.dtype)))


def _tokens(cfg, shape, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, shape)
    return toks.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_patches_matches(dtype):
    jcfg, jp, cfg, p = _models(dtype)
    jx_p, x_p = _patches(cfg, seed=1)
    toks = _tokens(cfg, (B, S), 1)
    jx, _ = JT.forward(jcfg, jp, jnp.asarray(toks), patch_embeds=jx_p)
    x, aux = T.forward(cfg, p, torch.from_numpy(toks).long(),
                       patch_embeds=x_p)
    assert tuple(x.shape) == jx.shape == (B, S, cfg.d_model)
    _close(x, jx, TOL[dtype], dtype)
    assert float(aux) == 0.0
    # the prefix takes effect: text-only hidden states differ
    x0, _ = T.forward(cfg, p, torch.from_numpy(toks).long())
    assert not torch.allclose(x0.float(), x.float(), atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_cache_and_decode_match(dtype):
    """Prefill logits and K/V with the patch prefix, four decode steps at
    per-slot positions [s, s - 5] and one at a scalar position."""
    jcfg, jp, cfg, p = _models(dtype)
    tol = TOL[dtype]
    jx_p, x_p = _patches(cfg, seed=2)
    toks = _tokens(cfg, (B, S), 2)
    jl, jc = JT.prefill(jcfg, jp, jnp.asarray(toks),
                        JT.init_cache(jcfg, B, MAX_LEN), patch_embeds=jx_p)
    cache = T.init_cache(cfg, B, MAX_LEN, device="cpu")
    logits, cache = T.prefill(cfg, p, torch.from_numpy(toks).long(), cache,
                              patch_embeds=x_p)
    assert tuple(logits.shape) == jl.shape == (B, 1, cfg.vocab)
    _close(logits, jl, tol, dtype)
    want_cache = interop.cache_from_jax(cfg, jax.tree.map(np.asarray, jc),
                                        device="cpu")
    for got_l, want_l in zip(cache["blocks"], want_cache["blocks"],
                             strict=True):
        assert set(got_l) == set(want_l) == {"k", "v"}
        for name in want_l:
            assert got_l[name].dtype == want_l[name].dtype, name
            _close(got_l[name], want_l[name].float().numpy(), tol, dtype)
    rng = np.random.default_rng(3)
    pos = np.array([S, S - 5], np.int32)
    for _ in range(4):
        t = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(t), jc,
                                jnp.asarray(pos))
        logits, cache = T.decode_step(cfg, p, torch.from_numpy(t).long(),
                                      cache, torch.from_numpy(pos).long())
        _close(logits, jl, tol, dtype)
        pos = pos + 1
    t = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    jl, _ = JT.decode_step(jcfg, jp, jnp.asarray(t), jc, S + 4)
    logits, _ = T.decode_step(cfg, p, torch.from_numpy(t).long(), cache,
                              S + 4)
    _close(logits, jl, tol, dtype)


def test_bf16_prefix_embeddings_equal_the_reference():
    """The patches, cast to the model dtype, replace the first positions
    bit for bit; the rest are the token embeddings."""
    jcfg, jp, cfg, p = _models("bfloat16")
    jx_p, x_p = _patches(cfg, seed=4)
    toks = _tokens(cfg, (B, S), 4)
    want = JT._embed_inputs(jcfg, jp, jnp.asarray(toks), jx_p)
    got = T._embed_inputs(cfg, p, torch.from_numpy(toks).long(), x_p)
    assert torch.equal(got.float(),
                       torch.from_numpy(np.asarray(want, np.float32)))
    assert torch.equal(got[:, :cfg.n_patches], x_p)


def test_prompt_shorter_than_the_prefix_raises():
    _, _, cfg, p = _models()
    _, x_p = _patches(cfg)
    toks = torch.from_numpy(_tokens(cfg, (B, cfg.n_patches - 1), 5)).long()
    with pytest.raises(ValueError, match="prefix"):
        T.forward(cfg, p, toks, patch_embeds=x_p)
    with pytest.raises(ValueError, match="prefix"):
        T.prefill(cfg, p, toks, T.init_cache(cfg, B, MAX_LEN, device="cpu"),
                  patch_embeds=x_p)
    # a prompt exactly the prefix's length is all patches
    toks = torch.from_numpy(_tokens(cfg, (B, cfg.n_patches), 5)).long()
    x, _ = T.forward(cfg, p, toks, patch_embeds=x_p)
    assert x.shape == (B, cfg.n_patches, cfg.d_model)


def test_init_params_shapes_match_reference():
    jcfg, jp, cfg, want = _models()
    p = T.init_params(cfg, 0, device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), p)
    assert shapes == jax.tree.map(lambda t: tuple(t.shape), want)
    assert "encoder" not in p and "xattn" not in p["blocks"][0]
    assert p["blocks"][0]["attn"]["wk"].shape == (cfg.d_model,
                                                  cfg.n_kv_heads * cfg.hd)


# -- serving: text-only prompts, as the reference's launcher serves them --


@pytest.fixture(scope="module")
def models():
    return _models()


def _prompts(n, plen, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=plen).astype(np.int32)
            for _ in range(n)]


def _engines(models, batch, **gen):
    jcfg, jp, cfg, p = models
    return (JEngine(jcfg, jp, batch=batch, max_len=MAX_LEN, gen=JGen(**gen)),
            ServingEngine(cfg, p, batch=batch, max_len=MAX_LEN,
                          gen=GenerationConfig(**gen)))


def test_served_tokens_match_reference(models):
    """``generate`` and ``serve`` (five requests through two slots,
    arriving at steps 0, 0, 2, 2, 7) give the reference engine's greedy
    tokens."""
    jeng, eng = _engines(models, 2, max_new_tokens=6)
    prompts = _prompts(5, 10, models[2].vocab, seed=6)
    assert eng.generate(prompts[:2]) == jeng.generate(prompts[:2])
    arrivals = [0, 0, 2, 2, 7]
    want = jeng.serve(prompts, arrivals)
    got = eng.serve(prompts, arrivals)
    assert got == want and all(len(o) == 6 for o in got)
    assert eng.last_serve_stats["n_refills"] == \
        jeng.last_serve_stats["n_refills"] >= 3


def test_served_request_equals_solo(models):
    _, eng = _engines(models, 2, max_new_tokens=5)
    prompts = _prompts(3, 9, models[2].vocab, seed=8)
    outs = eng.serve(prompts)
    for i in (0, 2):
        assert outs[i] == eng.generate([prompts[i]])[0]


def test_launcher_rehearsal_on_cpu():
    report = serve_launch.run(["--device", "cpu", "--reduced", "--arch",
                               ARCH, "--batch", "2", "--queue", "3",
                               "--prompt-len", "8", "--max-new", "4",
                               "--max-len", "32"])
    assert report["ok"] and report["arch"] == "pixtral-12b"
    assert report["tokens"] == 12 and report["refills"] == 2
    assert report["flash_launches"] == 0
