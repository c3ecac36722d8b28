"""Parity of whisper-large-v3's encoder-decoder in the port with the
reference, on the reduced config (2 encoder and 2 decoder layers, d 128,
16 frames; one case at the full 1,500 frames, which the reference pads to
its 1,024-key chunk and the port's plain loop runs ragged) with the
reference's parameters carried across by ``interop.params_from_jax``.

Compared: ``encode``, ``forward`` with frames, ``prefill`` with frames
(logits and every cache leaf, the cross K/V ``xk`` / ``xv`` included),
decode steps at per-slot and at scalar positions, and the serving engine's
greedy tokens (no frames: decode attends to a zero cross cache, as in the
reference).  Tolerances are ``test_torch_transformer.py``'s: 1e-4 at
f32, 3e-2 of the tensor's largest magnitude at bf16.  Frames and tokens
come from numpy with a seed; bf16 frames are the f32 draws rounded once,
the same way in both packages.
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
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.engine import GenerationConfig, ServingEngine

ARCH = "whisper-large-v3"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
B, S, MAX_LEN = 2, 13, 24


def _models(dtype="float32", n_frames=None):
    cfgs = []
    for c in (jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()):
        c = dataclasses.replace(c, dtype=dtype)
        if n_frames is not None:
            c = dataclasses.replace(c, encoder=dataclasses.replace(
                c.encoder, n_frames=n_frames))
        cfgs.append(c)
    jcfg, cfg = cfgs
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


def _frames(cfg, seed=0, batch=B):
    """The same frame embeddings for both packages, in the model dtype."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((batch, cfg.encoder.n_frames, cfg.d_model),
                            dtype=np.float32)
    return (jnp.asarray(f, dtype=cfg.dtype),
            torch.from_numpy(f).to(getattr(torch, cfg.dtype)))


def _tokens(cfg, shape, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, shape)
    return toks.astype(np.int32)


CASES = [("float32", None), ("bfloat16", None), ("float32", 1500)]
IDS = ["f32", "bf16", "f32-1500-frames"]


@pytest.mark.parametrize("dtype,n_frames", CASES, ids=IDS)
def test_encode_matches(dtype, n_frames):
    jcfg, jp, cfg, p = _models(dtype, n_frames)
    jf, f = _frames(cfg)
    want = JT.encode(jcfg, jp, jf)
    got = T.encode(cfg, p, f)
    assert tuple(got.shape) == want.shape == (B, cfg.encoder.n_frames,
                                              cfg.d_model)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_frames_matches(dtype):
    jcfg, jp, cfg, p = _models(dtype)
    jf, f = _frames(cfg, seed=1)
    toks = _tokens(cfg, (B, S), 1)
    jx, jaux = JT.forward(jcfg, jp, jnp.asarray(toks), frame_embeds=jf)
    x, aux = T.forward(cfg, p, torch.from_numpy(toks).long(), frame_embeds=f)
    _close(x, jx, TOL[dtype], dtype)
    assert float(aux) == float(jaux) == 0.0
    # without frames the decoder runs alone, in both packages
    jx0, _ = JT.forward(jcfg, jp, jnp.asarray(toks))
    x0, _ = T.forward(cfg, p, torch.from_numpy(toks).long())
    _close(x0, jx0, TOL[dtype], dtype)
    assert not np.allclose(np.asarray(jx0, np.float32),
                           np.asarray(jx, np.float32), atol=1e-2)


@pytest.mark.parametrize("dtype,n_frames", CASES, ids=IDS)
def test_prefill_cache_and_decode_match(dtype, n_frames):
    """Prefill logits, every cache leaf (``xk`` / ``xv`` of each layer
    included), four decode steps at per-slot positions [s, s - 5] and one
    at a scalar position."""
    jcfg, jp, cfg, p = _models(dtype, n_frames)
    tol = TOL[dtype]
    jf, f = _frames(cfg, seed=2)
    toks = _tokens(cfg, (B, S), 2)
    jl, jc = JT.prefill(jcfg, jp, jnp.asarray(toks),
                        JT.init_cache(jcfg, B, MAX_LEN), frame_embeds=jf)
    cache = T.init_cache(cfg, B, MAX_LEN, device="cpu")
    logits, cache = T.prefill(cfg, p, torch.from_numpy(toks).long(), cache,
                              frame_embeds=f)
    assert tuple(logits.shape) == jl.shape == (B, 1, cfg.vocab)
    _close(logits, jl, tol, dtype)
    want_cache = interop.cache_from_jax(cfg, jax.tree.map(np.asarray, jc),
                                        device="cpu")
    for got_l, want_l in zip(cache["blocks"], want_cache["blocks"],
                             strict=True):
        assert set(got_l) == set(want_l) == {"k", "v", "xk", "xv"}
        for name in want_l:
            assert got_l[name].shape == want_l[name].shape, name
            assert got_l[name].dtype == want_l[name].dtype, name
            _close(got_l[name], want_l[name].float().numpy(), tol, dtype)
        assert float(got_l["xk"].float().abs().max()) > 0.0
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


def test_bf16_positions_round_as_the_reference():
    """The sinusoidal embeddings are made in f32, cast to bf16 and then
    added, in the reference's order, in a prefill and in a decode step:
    bit for bit the reference's prefill embeddings (an f32 add then one
    cast would round otherwise)."""
    jcfg, jp, cfg, p = _models("bfloat16")
    toks = _tokens(cfg, (B, S), 4)
    want = JT._embed_inputs(jcfg, jp, jnp.asarray(toks))
    got = T._embed_inputs(cfg, p, torch.from_numpy(toks).long())
    want = torch.from_numpy(np.asarray(want, np.float32))
    assert torch.equal(got.float(), want)
    # an f32 add then a cast differs from the reference somewhere
    emb = p["embed"]["tok"][torch.from_numpy(toks).long()]
    pe = L.sinusoidal_positions(S, cfg.d_model)
    assert not torch.equal((emb.float() + pe).bfloat16().float(), want)
    for t, pv in ((5, torch.tensor(5)), (S - 1, torch.tensor([S - 1, 3]))):
        tok = torch.from_numpy(toks[:, t:t + 1]).long()
        step = T._embed_step(cfg, p, tok, pv)
        assert torch.equal(step[0].float(), want[0, t:t + 1])


def test_frames_must_fill_the_cross_cache():
    jcfg, jp, cfg, p = _models()
    _, f = _frames(dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, n_frames=cfg.encoder.n_frames - 4)))
    toks = torch.from_numpy(_tokens(cfg, (B, S), 5)).long()
    with pytest.raises(ValueError, match="frames"):
        T.prefill(cfg, p, toks, T.init_cache(cfg, B, MAX_LEN, device="cpu"),
                  frame_embeds=f)
    x, _ = T.forward(cfg, p, toks, frame_embeds=f)  # no cache: any length
    assert x.shape == (B, S, cfg.d_model)


def test_init_params_shapes_match_reference():
    jcfg, jp, cfg, want = _models()
    p = T.init_params(cfg, 0, device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), p)
    assert shapes == jax.tree.map(lambda t: tuple(t.shape), want)
    assert len(p["encoder"]["blocks"]) == cfg.encoder.n_layers == 2
    assert set(p["blocks"][0]) == {"ln1", "attn", "xattn", "ln_x", "ln2",
                                   "mlp"}
    assert set(p["encoder"]["blocks"][0]) == {"ln1", "attn", "ln2", "mlp"}
    assert "bq" not in p["blocks"][0]["xattn"]  # cross blocks: no bias
    layer = T.init_cache(cfg, B, MAX_LEN, device="cpu")["blocks"][1]
    assert layer["xk"].shape == (B, cfg.n_kv_heads, cfg.encoder.n_frames,
                                 cfg.hd)


def test_cross_blocks_carry_no_qkv_bias():
    """With ``qkv_bias`` set, self-attention gets its biases and the
    cross-attention blocks none, in both packages."""
    jcfg, cfg = (dataclasses.replace(c.reduced(), qkv_bias=True)
                 for c in (jget_arch(ARCH), get_arch(ARCH)))
    jp = JT.init_params(jcfg, jax.random.key(0))
    p = T.init_params(cfg, 0, device="cpu")
    for blk, jblk in ((p["blocks"][0], jp["blocks"][0]),
                      (p["encoder"]["blocks"][0], jp["encoder"]["blocks"][0])):
        assert set(blk) == set(jblk)
        for name in blk:
            assert set(blk[name]) == set(jblk[name]), name
    assert "bq" in p["blocks"][0]["attn"]
    assert set(p["blocks"][0]["xattn"]) == {"wq", "wk", "wv", "wo"}


def test_params_from_jax_unstacks_encoder_in_order():
    jcfg, jp, cfg, p = _models()
    for layer, blk in enumerate(p["encoder"]["blocks"]):
        want = np.asarray(jp["encoder"]["blocks"][0]["attn"]["wq"][layer])
        assert np.array_equal(blk["attn"]["wq"].numpy(), want)
    want = np.asarray(jp["blocks"][0]["xattn"]["wk"][1])
    assert np.array_equal(p["blocks"][1]["xattn"]["wk"].numpy(), want)


# -- serving: no frames, so decode attends to a zero cross cache ----------


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
    prompts = _prompts(5, 9, models[2].vocab, seed=6)
    assert eng.generate(prompts[:2]) == jeng.generate(prompts[:2])
    arrivals = [0, 0, 2, 2, 7]
    want = jeng.serve(prompts, arrivals)
    got = eng.serve(prompts, arrivals)
    assert got == want and all(len(o) == 6 for o in got)
    assert eng.last_serve_stats["n_refills"] == \
        jeng.last_serve_stats["n_refills"] >= 3


def test_zero_cross_cache_adds_nothing(models):
    """A prefill without frames leaves the cross cache at zero, and the
    decode's cross-attention sub-layer then adds exactly zero: the step
    equals one whose blocks skip it."""
    _, _, cfg, p = models
    toks = torch.from_numpy(_tokens(cfg, (B, S), 7)).long()
    cache = T.init_cache(cfg, B, MAX_LEN, device="cpu")
    _, cache = T.prefill(cfg, p, toks, cache)
    assert all(float(c[n].abs().max()) == 0.0 for c in cache["blocks"]
               for n in ("xk", "xv"))
    plain = [{"k": c["k"].clone(), "v": c["v"].clone()}
             for c in cache["blocks"]]
    t = toks[:, :1]
    logits, _ = T.decode_step(cfg, p, t, cache, S)
    want, _ = T.decode_step(cfg, p, t, {"blocks": plain}, S)
    assert torch.equal(logits, want)


def test_served_request_equals_solo(models):
    _, eng = _engines(models, 2, max_new_tokens=5)
    prompts = _prompts(3, 8, models[2].vocab, seed=8)
    outs = eng.serve(prompts)
    for i in (0, 2):
        assert outs[i] == eng.generate([prompts[i]])[0]


def test_launcher_rehearsal_on_cpu():
    report = serve_launch.run(["--device", "cpu", "--reduced", "--arch",
                               ARCH, "--batch", "2", "--queue", "3",
                               "--prompt-len", "8", "--max-new", "4",
                               "--max-len", "32"])
    assert report["ok"] and report["arch"] == "whisper-large-v3"
    assert report["tokens"] == 12 and report["refills"] == 2
    assert report["flash_launches"] == 0
