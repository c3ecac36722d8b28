"""Parity of the port's LM stack (``repro_torch.models.transformer``) with
the reference's, on reduced dense decoders whose parameters the reference
draws and ``interop.params_from_jax`` carries across.

Prefill logits, the K/V cache it writes and four decode steps with per-slot
(vector) positions are compared.  Tolerances: 1e-4 at f32 (the same
arithmetic through a few layers, other summation orders); 3e-2 at bf16,
the reference's bf16 tolerance, taken relative to each tensor's largest
magnitude: the two packages round bf16 matmul outputs at other places, and
from the second layer on over half the cache entries differ by an ulp or
two of the residual stream (up to 0.036 where the cache reaches 4.2).
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
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
B, S, MAX_LEN = 2, 37, 48


def _models(arch, dtype):
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype)
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


@pytest.mark.parametrize("arch,dtype", [
    ("olmo-1b", "float32"),
    ("olmo-1b", "bfloat16"),
    ("gemma2-27b", "float32"),  # window, softcaps, post-norms, geglu, GQA
    ("qwen2-72b", "float32"),  # qkv bias, GQA
])
def test_prefill_cache_and_decode_match(arch, dtype):
    jcfg, jp, cfg, p = _models(arch, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jl, jc = JT.prefill(jcfg, jp, jnp.asarray(toks),
                        JT.init_cache(jcfg, B, MAX_LEN))
    cache = T.init_cache(cfg, B, MAX_LEN, device="cpu")
    logits, cache = T.prefill(cfg, p, torch.from_numpy(toks).long(), cache)
    assert tuple(logits.shape) == jl.shape == (B, 1, cfg.vocab)
    _close(logits, jl, tol, dtype)
    want_cache = interop.cache_from_jax(cfg, jax.tree.map(np.asarray, jc),
                                        device="cpu")
    for got_l, want_l in zip(cache["blocks"], want_cache["blocks"]):
        for name in ("k", "v"):
            _close(got_l[name], want_l[name].float().numpy(), tol, dtype)
    pos = np.array([S, S - 5], np.int32)  # slots at their own fill levels
    for _ in range(4):
        t = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(t), jc,
                                jnp.asarray(pos))
        logits, cache = T.decode_step(cfg, p, torch.from_numpy(t).long(),
                                      cache, torch.from_numpy(pos).long())
        _close(logits, jl, tol, dtype)
        pos = pos + 1


def test_scalar_position_decode_and_forward_match():
    jcfg, jp, cfg, p = _models("olmo-1b", "float32")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jx, _ = JT.forward(jcfg, jp, jnp.asarray(toks))
    x, aux = T.forward(cfg, p, torch.from_numpy(toks).long())
    _close(x, jx, TOL["float32"])
    assert float(aux) == 0.0
    _, jc = JT.prefill(jcfg, jp, jnp.asarray(toks),
                       JT.init_cache(jcfg, B, MAX_LEN))
    _, cache = T.prefill(cfg, p, torch.from_numpy(toks).long(),
                         T.init_cache(cfg, B, MAX_LEN, device="cpu"))
    for i in range(3):
        t = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(t), jc, S + i)
        logits, cache = T.decode_step(cfg, p, torch.from_numpy(t).long(),
                                      cache, S + i)
        _close(logits, jl, TOL["float32"])


def test_params_from_jax_unstacks_layer_order():
    """Layer r * period + i of the port is repetition r of the reference's
    pattern position i (gemma2 alternates local and global layers)."""
    jcfg, jp, cfg, p = _models("gemma2-27b", "float32")
    period = len(jcfg.layer_kinds())
    assert period == 2 and len(p["blocks"]) == cfg.n_layers == 4
    for layer, blk in enumerate(p["blocks"]):
        r, i = divmod(layer, period)
        want = np.asarray(jp["blocks"][i]["attn"]["wq"][r])
        assert np.array_equal(blk["attn"]["wq"].numpy(), want)
    kinds = T.layer_kinds(cfg)
    assert [k["window"] for k in kinds] == [64, None, 64, None]


def test_init_params_shapes_match_reference():
    jcfg, jp, cfg, _ = _models("qwen2-72b", "float32")
    p = T.init_params(cfg, 0, device="cpu")
    want = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    got_shapes = jax.tree.map(lambda t: tuple(t.shape), p)
    want_shapes = jax.tree.map(lambda t: tuple(t.shape), want)
    assert got_shapes == want_shapes
    again = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert torch.equal(again["blocks"][1]["mlp"]["w_in"],
                       p["blocks"][1]["mlp"]["w_in"])


@pytest.mark.parametrize("arch,what", [
    ("deepseek-moe-16b", "MoE"), ("jamba-v0.1-52b", "mamba"),
    ("rwkv6-7b", "rwkv6"), ("whisper-large-v3", "whisper encoder"),
    ("pixtral-12b", "vision prefix")])
def test_unported_parts_raise(arch, what):
    """Each part the port has no code for raises, naming its ROADMAP item;
    MoE is ported, so deepseek-moe-16b registers and passes the check,
    and no message names MoE any more."""
    if what == "MoE":
        cfg = get_arch(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_arch(arch))
        T.check_supported(cfg.reduced())
        with pytest.raises(NotImplementedError) as info:
            T.check_supported(jget_arch("jamba-v0.1-52b").reduced())
        assert "MoE" not in str(info.value)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_arch(arch)
    with pytest.raises(NotImplementedError, match=what):
        T.check_supported(jget_arch(arch).reduced())


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError):
        get_arch("gpt-17")


def test_entry_points_default_to_cuda():
    cfg = get_arch("olmo-1b").reduced()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg, 0)
