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
The recurrent archs (jamba's mamba hybrid, rwkv6) compare every leaf of
their per-layer state too; their prompts are a multiple of the reduced
chunk (8), which the reference's prefill requires past one chunk.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_arch as jget_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
B, S, MAX_LEN = 2, 37, 48
S_RECURRENT = 40  # a multiple of the reduced mamba / rwkv6 chunk


def _models(arch, dtype, moe_impl=None):
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype)
    if moe_impl is not None:
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, impl=moe_impl)) for c in (jcfg, cfg))
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


def _prompt_len(cfg) -> int:
    return S_RECURRENT if cfg.mixer != "attention" else S


@pytest.mark.parametrize("arch,dtype", [
    ("olmo-1b", "float32"),
    ("olmo-1b", "bfloat16"),
    ("gemma2-27b", "float32"),  # window, softcaps, post-norms, geglu, GQA
    ("qwen2-72b", "float32"),  # qkv bias, GQA
    ("jamba-v0.1-52b", "float32"),  # mamba + attention 7:1, MoE (tp)
    ("rwkv6-7b", "float32"),  # time mix + channel mix, no attention
    ("rwkv6-7b", "bfloat16"),
])
def test_prefill_cache_and_decode_match(arch, dtype):
    jcfg, jp, cfg, p = _models(arch, dtype)
    tol = TOL[dtype]
    s = _prompt_len(cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    jl, jc = JT.prefill(jcfg, jp, jnp.asarray(toks),
                        JT.init_cache(jcfg, B, MAX_LEN))
    cache = T.init_cache(cfg, B, MAX_LEN, device="cpu")
    logits, cache = T.prefill(cfg, p, torch.from_numpy(toks).long(), cache)
    assert tuple(logits.shape) == jl.shape == (B, 1, cfg.vocab)
    _close(logits, jl, tol, dtype)
    want_cache = interop.cache_from_jax(cfg, jax.tree.map(np.asarray, jc),
                                        device="cpu")
    for got_l, want_l in zip(cache["blocks"], want_cache["blocks"],
                             strict=True):
        assert set(got_l) == set(want_l)
        for name in want_l:
            assert got_l[name].dtype == want_l[name].dtype, name
            _close(got_l[name], want_l[name].float().numpy(), tol, dtype)
    pos = np.array([s, s - 5], np.int32)  # slots at their own fill levels
    for _ in range(4):
        t = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(t), jc,
                                jnp.asarray(pos))
        logits, cache = T.decode_step(cfg, p, torch.from_numpy(t).long(),
                                      cache, torch.from_numpy(pos).long())
        _close(logits, jl, tol, dtype)
        pos = pos + 1


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-7b"])
def test_recurrent_prefill_equals_forward_and_longer_prefill(arch):
    """Prefill logits are ``forward``'s at the last position (the
    reference's ``test_prefill_decode_consistency`` check, here at 1e-4,
    with ``forward`` held against the reference's too), and a prefill
    then decode steps give the logits of one longer prefill: 7 tokens + 1
    step against 8, and 8 tokens + 8 steps against 16.  jamba's MoE
    layers run ``dense`` here: ``tp``'s capacity is S * top_k * 1.25 /
    n_experts, so a prefill and a decode step drop different choices by
    design."""
    jcfg, jp, cfg, p = _models(arch, "float32",
                               "dense" if arch.startswith("jamba") else None)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (B, 16)).astype(np.int32)
    tt = torch.from_numpy(toks).long()

    def prefill(n):
        return T.prefill(cfg, p, tt[:, :n],
                         T.init_cache(cfg, B, 24, device="cpu"))

    x, _ = T.forward(cfg, p, tt)
    jx, _ = JT.forward(jcfg, jp, jnp.asarray(toks))
    _close(x, jx, TOL["float32"])
    logits, _ = prefill(16)
    want = L.logits_matmul(cfg, p["embed"], x[:, -1:])
    _close(logits, want.numpy(), TOL["float32"])
    for start, stop in ((7, 8), (8, 16)):
        _, cache = prefill(start)
        for t in range(start, stop):
            step, cache = T.decode_step(cfg, p, tt[:, t:t + 1], cache, t)
        _close(step, prefill(stop)[0].numpy(), TOL["float32"])


def test_jamba_bf16_layers_match_reference():
    """The reduced jamba in bf16, layer by layer on the reference's own
    hidden states and caches: each layer's prefill output and state, and
    one decode step, within 3e-2 of the tensor's largest magnitude.
    End to end the two runs part: layer 1's attention input differs by
    one bf16 ulp, which swaps a token's second and third experts (router
    logits 0.0014 apart), and every later layer's mamba state carries
    that token's new output to the tokens after it."""
    jcfg, jp, cfg, p = _models("jamba-v0.1-52b", "bfloat16")
    tol = TOL["bfloat16"]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, S_RECURRENT)).astype(np.int32)
    jcache = JT.init_cache(jcfg, B, MAX_LEN)
    jx = JL.embed_tokens(jp["embed"], jnp.asarray(toks))
    t = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    jxd = JL.embed_tokens(jp["embed"], jnp.asarray(t))
    kinds, period = jcfg.layer_kinds(), len(jcfg.layer_kinds())
    positions = jnp.arange(S_RECURRENT)
    pos = np.array([S_RECURRENT, S_RECURRENT - 5], np.int32)
    seen = set()
    for layer, kind in enumerate(T.layer_kinds(cfg)):
        r, i = divmod(layer, period)
        jpl = jax.tree.map(lambda a, r=r: a[r], jp["blocks"][i])
        jc = jax.tree.map(lambda a, r=r: a[r], jcache["blocks"][i])
        jy, jc = JT._prefill_block(jcfg, kinds[i], jpl, jx, jc, positions)
        jyd, _ = JT._apply_block_decode(jcfg, kinds[i], jpl, jxd, jc,
                                        jnp.asarray(pos))
        blk = p["blocks"][layer]
        cache = T.init_cache(cfg, B, MAX_LEN, device="cpu")["blocks"][layer]
        x = torch.from_numpy(np.asarray(jx, np.float32)).bfloat16()
        y, _ = T._prefill_block(cfg, kind, blk, x, cache,
                                torch.arange(S_RECURRENT))
        _close(y, jy, tol, "bfloat16")
        for name, leaf in jc.items():
            _close(cache[name], leaf, tol, "bfloat16")
        want_c = interop._tree_to_tensors(jax.tree.map(np.asarray, jc), "cpu")
        xd = torch.from_numpy(np.asarray(jxd, np.float32)).bfloat16()
        pv = torch.from_numpy(pos).long()
        yd = T._apply_block_decode(cfg, kind, blk, xd, want_c, pv,
                                   pv[:, None], pv + 1)
        _close(yd, jyd, tol, "bfloat16")
        jx, jxd = jy, jyd
        seen.add((kind["mixer"], kind["moe"]))
    assert seen == {("attention", False), ("mamba", True), ("mamba", False)}


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
    """Each part that was once unported (MoE, mamba, rwkv6, the whisper
    encoder, the vision prefix) is ported: its arch registers with a
    config equal to the reference's, and the check passes it full and
    reduced, in bf16 and f32; what the check still refuses is a dtype the
    kernels do not take."""
    cfg = get_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_arch(arch))
    for c in (cfg, cfg.reduced()):
        for dtype in ("bfloat16", "float32"):
            T.check_supported(dataclasses.replace(c, dtype=dtype))
    with pytest.raises(TypeError, match="float16"):
        T.check_supported(dataclasses.replace(cfg, dtype="float16"))


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_every_reference_arch_registers(arch):
    """The port's registry resolves each of the reference's architectures
    (by id and by alias) to a config equal to the reference's."""
    assert arch in ARCH_IDS
    assert dataclasses.asdict(get_arch(arch)) == \
        dataclasses.asdict(jget_arch(arch))
    alias = get_arch(arch).name
    assert dataclasses.asdict(get_arch(alias)) == \
        dataclasses.asdict(jget_arch(alias))


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError):
        get_arch("gpt-17")


def test_entry_points_default_to_cuda():
    cfg = get_arch("olmo-1b").reduced()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg, 0)
