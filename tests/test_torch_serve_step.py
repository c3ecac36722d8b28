"""The serving steps of the dry run (``launch.steps.build_prefill_step`` /
``build_serve_step``), on one device against the reference's and on a
mesh of ranks against the port's one-device steps.

One device: the reference's steps run on a 1 x 1 ``jax.sharding.Mesh`` of
Auto axes (as ``tests/test_torch_train_step.py`` holds the training
step), both packages from the reference's parameters; a prompt of 20
tokens into a 24-deep cache, then three greedy decode steps on the
reference's tokens.  Logits and every cache leaf within 1e-4 (f32) or
3e-2 (bf16) relative to the largest magnitude, for the four dense archs
reduced.

A mesh of ranks: the sharded steps (``parallel/runtime.py``'s ``prefill``
/ ``decode``, parameters laid out by ``abstract_state`` and the cache by
``cache_specs``) on (2, 2) and (2, 1, 2) ranks against the port's
one-device steps from the same parameters, f32: logits (assembled from
the ranks' rows) and the gathered cache within 1e-4 after the prefill and
after each decode step.  A config whose heads do not divide ``model``
runs attention whole on every model rank with the cache's sequence split
over ``model`` (the decode steps crossing from one rank's chunk into the
next) or, where the sequence does not divide either, whole.  MoE's
spgemm impl on a mesh raises naming its ROADMAP.md item; the ssm, audio
and vlm families serve (their parity: ``tests/test_torch_sharded_ssm.py``,
``_audio.py``, ``_vlm.py``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.config import ShapeConfig as JShapeConfig
from repro.configs import get_arch as jget_arch
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T
from repro_torch.optim.tree import leaves, named_leaves, tree_map
from repro_torch.parallel import runtime as RT
from repro_torch.parallel import sharding as SH

DENSE = ["olmo-1b", "gemma2-27b", "qwen1.5-4b", "qwen2-72b"]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PROMPT, DEPTH, BATCH, N_DECODE = 20, 24, 4, 3
MESHES = [((2, 2), ("data", "model")), ((2, 1, 2), ("pod", "data", "model"))]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=what)


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_one_device_steps_match_reference(arch, dtype):
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype)
    tol = TOL[dtype]
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jpre, (_, jc_sds, jb_sds) = JS.build_prefill_step(
        jcfg, mesh, JShapeConfig("p", DEPTH, BATCH, "prefill"))
    jdec, _ = JS.build_serve_step(jcfg, mesh,
                                  JShapeConfig("d", DEPTH, BATCH, "decode"))
    pre, (p_sds, c_sds, b_sds) = S.build_prefill_step(
        cfg, ShapeConfig("p", DEPTH, BATCH, "prefill"), device="cpu")
    dec, _ = S.build_serve_step(cfg, ShapeConfig("d", DEPTH, BATCH, "decode"),
                                device="cpu")
    assert {k: tuple(v.shape) for k, v in b_sds.items()} == {
        k: tuple(v.shape) for k, v in jb_sds.items()}
    jp = JT.init_params(jcfg, jax.random.key(0))
    params = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    assert {n: x.shape for n, x in named_leaves(p_sds)} == {
        n: tuple(x.shape) for n, x in named_leaves(params)}
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jc_sds)
    cache = S.sds_zeros(None, c_sds, device="cpu")
    toks = _tokens(cfg.vocab, (BATCH, PROMPT))
    jl, jcache = jpre(jp, jcache, {"tokens": jnp.asarray(toks, jnp.int32)})
    logits, cache = pre(params, cache, {"tokens": torch.from_numpy(toks)})
    _close(logits, jl, tol, "prefill logits")
    for i in range(N_DECODE):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
        jl, jcache = jdec(jp, jcache, jnp.asarray(nxt, jnp.int32),
                          jnp.int32(PROMPT + i))
        logits, cache = dec(params, cache, torch.from_numpy(nxt.copy()),
                            PROMPT + i)
        _close(logits, jl, tol, f"decode {i} logits")
    want = interop.cache_from_jax(cfg, jax.tree.map(np.asarray, jcache),
                                  device="cpu")
    for got, ref in zip(leaves(cache), leaves(want)):
        _close(got, ref.float().numpy(), tol, "cache")


def _sharded_vs_one_device(cfg, dims, names, prompt=PROMPT, depth=DEPTH,
                           batch=BATCH, embeds=None):
    """The sharded prefill and decode steps against the one-device steps,
    logits within 1e-4 and greedy tokens equal (``embeds``: whisper's
    frames / pixtral's patches, name -> rows a sample, drawn with numpy
    and given to both prefills); returns the cache's specs."""
    mesh = M.make_mesh(dims, names, "cpu")
    shape = ShapeConfig("s", depth, batch, "prefill")
    params = T.init_params(cfg, 0, device="cpu")
    pre1, _ = S.build_prefill_step(cfg, shape, device="cpu")
    dec1, _ = S.build_serve_step(cfg, shape, device="cpu")
    pre, (p_sds, c_sds, _) = S.build_prefill_step(cfg, shape, device="cpu",
                                                  mesh=mesh)
    dec, _ = S.build_serve_step(cfg, shape, device="cpu", mesh=mesh)
    p_spec = tree_map(lambda x: x.spec, p_sds)
    c_spec = tree_map(lambda x: x.spec, c_sds)
    sharded = SH.shard_tree(mesh, params, p_spec)
    cache1 = T.init_cache(cfg, batch, depth, device="cpu")
    cache = S.init_sharded_cache(cfg, mesh, batch, depth)
    rows = SH.batch_spec(mesh, batch, 1, cfg.vocab)
    toks = torch.from_numpy(_tokens(cfg.vocab, (batch, prompt)))
    rng = np.random.default_rng(3)
    inputs = {"tokens": toks, **{
        name: torch.from_numpy(rng.standard_normal(
            (batch, n, cfg.d_model)).astype(np.float32))
        for name, n in (embeds or {}).items()}}
    want, cache1 = pre1(params, cache1, inputs)
    got, cache = pre(sharded, cache, inputs)
    steps = [(got, want)]
    for i in range(N_DECODE):
        nxt = torch.argmax(want[:, -1], -1)[:, None]
        want, cache1 = dec1(params, cache1, nxt, prompt + i)
        got, cache = dec(sharded, cache, nxt, prompt + i)
        steps.append((got, want))
    for i, (got, want) in enumerate(steps):
        assert isinstance(got, SH.Shards)
        got = SH.unshard(mesh, got, rows)
        _close(got, want.numpy(), TOL["float32"], f"step {i} logits")
        assert torch.equal(got[:, -1].argmax(-1), want[:, -1].argmax(-1)), (
            f"step {i}: greedy tokens differ")
    gathered = SH.unshard_tree(mesh, cache, c_spec)
    for g, w in zip(leaves(gathered), leaves(cache1)):
        _close(g, w.numpy(), TOL["float32"], "cache")
    return c_spec


@pytest.mark.parametrize("dims,names", MESHES, ids=["d2m2", "p2d1m2"])
@pytest.mark.parametrize("arch", DENSE)
def test_sharded_steps_match_one_device(arch, dims, names):
    c_spec = _sharded_vs_one_device(get_arch(arch).reduced(), dims, names)
    heads = tuple(leaves(c_spec)[0])
    assert heads[1] == "model"  # reduced heads divide the model axis


@pytest.mark.parametrize("dims,depth,layout", [
    ((1, 2), 24, "seq"), ((2, 2), 24, "seq"), ((2, 2), 25, "whole")],
    ids=["m2-seq", "d2m2-seq", "d2m2-whole"])
def test_heads_that_do_not_divide_model(dims, depth, layout):
    """6 heads over 3 kv heads on a model axis of 2: attention whole on
    every model rank, the cache's sequence over ``model`` (an 11-token
    prompt ends in the first rank's chunk of 12, the decode steps write
    across into the second's) or, at an odd depth, whole."""
    cfg = dataclasses.replace(get_arch("olmo-1b").reduced(), n_heads=6,
                              n_kv_heads=3, head_dim=32)
    mesh = M.make_mesh(dims, ("data", "model"), "cpu")
    runtime = RT.DecoderRuntime(
        cfg, mesh, S.abstract_state(cfg, mesh, None, S.StepOptions())[2],
        SH.activation_rules(cfg, mesh, batch=BATCH), max_len=depth)
    assert runtime.kv_layout(depth) == layout
    c_spec = _sharded_vs_one_device(cfg, dims, ("data", "model"), prompt=11,
                                    depth=depth)
    want = {"seq": (None, "model"), "whole": (None, None)}[layout]
    assert tuple(leaves(c_spec)[0])[1:3] == want


@pytest.mark.parametrize("axes", [(16, 16), (2, 16, 16)], ids=["single",
                                                                "multi"])
@pytest.mark.parametrize("arch", DENSE)
def test_runtime_layout_is_cache_specs(arch, axes):
    """At full width on the production meshes the runtime's K/V layout is
    the one ``cache_specs`` gives the cache (qwen1.5-4b's 20 heads and
    qwen2-72b's 8 kv heads split the sequence over 16 model ranks)."""
    cfg = get_arch(arch)
    names = ("pod", "data", "model")[-len(axes):]
    mesh = M.Mesh(names, axes, (torch.device("meta"),) * int(np.prod(axes)),
                  abstract=True)
    for shape in ("prefill_32k", "decode_32k"):
        from repro_torch.config import SHAPES

        sh = SHAPES[shape]
        _, _, p_spec, _ = S.abstract_state(cfg, mesh, None, S.StepOptions())
        runtime = RT.DecoderRuntime(
            cfg, mesh, p_spec, SH.activation_rules(cfg, mesh,
                                                   batch=sh.global_batch),
            max_len=sh.seq_len)
        spec = leaves(SH.cache_specs(cfg, SH.cache_shapes(
            cfg, sh.global_batch, sh.seq_len), mesh,
            batch=sh.global_batch))[0]
        want = {("model", None): "heads", (None, "model"): "seq",
                (None, None): "whole"}[tuple(spec)[1:3]]
        assert runtime.layout == want, (arch, shape)


@pytest.mark.parametrize("arch,item", [
    ("deepseek-moe-16b", "15c.2"), ("llama4-maverick-400b-a17b", "15c.2"),
    ("jamba-v0.1-52b", "15c.2"), ("rwkv6-7b", None),
    ("whisper-large-v3", None), ("pixtral-12b", None)])
def test_other_families_raise_their_item(arch, item):
    """MoE's spgemm impl on a mesh raises naming its item (the MoE and
    hybrid families run under tp / ep / dense:
    ``tests/test_torch_sharded_moe.py``,
    ``tests/test_torch_sharded_hybrid.py``); the ssm, audio and vlm
    families build and serve a prompt of 16 tokens and one decode step
    (finite logits over the whole vocabulary)."""
    cfg = get_arch(arch).reduced()
    mesh = M.make_mesh((2, 2), ("data", "model"), "cpu")
    shape = ShapeConfig("s", DEPTH, BATCH, "prefill")
    if item is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="spgemm"))
        for build in (S.build_prefill_step, S.build_serve_step):
            with pytest.raises(NotImplementedError, match=item):
                build(cfg, shape, device="cpu", mesh=mesh)
        return
    pre, (p_sds, _, _) = S.build_prefill_step(cfg, shape, device="cpu",
                                              mesh=mesh)
    dec, _ = S.build_serve_step(cfg, shape, device="cpu", mesh=mesh)
    params = SH.shard_tree(mesh, T.init_params(cfg, 0, device="cpu"),
                           tree_map(lambda x: x.spec, p_sds))
    cache = S.init_sharded_cache(cfg, mesh, BATCH, DEPTH)
    toks = torch.from_numpy(_tokens(cfg.vocab, (BATCH, 16)))
    logits, cache = pre(params, cache, {"tokens": toks})
    logits, cache = dec(params, cache, toks[:, -1:], 16)
    rows = SH.unshard(mesh, logits, SH.batch_spec(mesh, BATCH, 1, cfg.vocab))
    assert rows.shape == (BATCH, 1, cfg.vocab)
    assert bool(torch.isfinite(rows).all())


@pytest.mark.parametrize("window,softcap", [(None, None), (5, None),
                                            (None, 30.0), (7, 50.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_partials_combine_to_decode_attention(window, softcap,
                                                      dtype):
    """The sequence-split decode's chunks (``attention.decode_partial``,
    combined by their max as ``DecoderRuntime`` combines the ranks') give
    ``decode_attention`` over the whole cache: 1e-6 in f32; in bf16 the
    cache-dtype rounding falls on P / sum here and on P there, so within
    the bf16 tolerance."""
    from repro_torch.models import attention as A

    rng = np.random.default_rng(7)
    b, h, hkv, n, d, length = 2, 8, 2, 24, 16, 19
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((b, h, 1, d),
                                             dtype=np.float32)).to(dt)
    k, v = (torch.from_numpy(rng.standard_normal((b, hkv, n, d),
                                                 dtype=np.float32)).to(dt)
            for _ in range(2))
    want = A.decode_attention(q, k, v, length, window=window,
                              softcap=softcap)
    parts = [A.decode_partial(q, k[:, :, c:c + 8], v[:, :, c:c + 8], length,
                              key_offset=c, window=window, softcap=softcap)
             for c in range(0, n, 8)]
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    tot = sum(torch.cat([s * torch.exp(m - top), acc * torch.exp(m - top)],
                        dim=-1) for m, s, acc in parts)
    got = (tot[..., 1:] / tot[..., :1]).to(dt)
    tol = 1e-6 if dtype == "float32" else TOL[dtype]
    scale = max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol * scale
