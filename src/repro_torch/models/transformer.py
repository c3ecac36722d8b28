"""The LM stack: init, encode, prefill, decode.

The torch twin of ``repro/models/transformer.py``: attention mixers with
dense MLPs (olmo, qwen, gemma2: ``post_norm``, ``qkv_bias``, sliding
``window``, ``attn_softcap``, ``final_softcap``), MoE blocks
(deepseek-moe, llama4, jamba: ``models/moe.py``, every
``layer_period``-th layer; ``forward`` returns their load-balance loss),
the recurrent mixers: mamba (``models/mamba.py``; jamba's 1:7
attention:mamba pattern) and rwkv6 (``models/rwkv6.py``; time mix and
channel mix, no MLP), whisper's encoder-decoder (``encode`` runs the
encoder's non-causal blocks over stub frame embeddings with absolute
sinusoidal positions; each decoder block adds a cross-attention residual
``xattn`` / ``ln_x`` against the encoder output; the decoder's positions
are sinusoidal too, ``rope=False``) and pixtral's early fusion (stub
patch embeddings replace the first ``n_patches`` token embeddings).  The
reference stacks each pattern position's blocks over the repetitions and
scans them; PyTorch runs eagerly, so here ``params["blocks"]`` is a
plain list with one dict per layer, in layer order (layer ``l`` has kind
``layer_kinds()[l % period]``), ``params["encoder"]["blocks"]`` likewise,
and the cache: ``{"k", "v"}`` for attention (with whisper's encoder K/V
``{"xk", "xv"}`` of (B, hkv, n_frames, hd) beside them), ``{"conv",
"ssm"}`` for mamba and ``{"shift_t", "shift_c", "wkv"}`` for rwkv6,
batch on dim 0.  ``interop.params_from_jax`` unstacks the reference's
pytree into this layout.

The cache is updated in place (``prefill`` and ``decode_step`` return the
same dict they were given, K/V rows and recurrent states written into
its tensors), where the reference returns a new pytree: it saves a copy
of every layer's K/V per step.  ``forward`` starts the recurrent states
at zero, as the reference's train path does.

A whisper cache that no prefill with frames filled keeps ``xk`` / ``xv``
at zero, and decode still attends to it, as the reference does when its
``ServingEngine`` (which passes no frames) serves whisper: uniform
weights over zero values, so that sub-layer adds exactly zero.  A prompt
shorter than the patch prefix raises ``ValueError`` (the reference's
concatenation would lengthen the sequence to the prefix instead).

Training: ``forward(..., remat=)`` and ``loss_fn`` (the chunked
cross-entropy plus ``aux_coef`` times the MoE load-balance loss).  The
reference checkpoints each scanned group of layers; the port runs one
layer at a time and checkpoints each: ``"none"`` keeps every
activation, ``"full"`` recomputes a layer's forward in its backward
(``torch.utils.checkpoint``), ``"dots"`` saves the layer's 2-D matmul
outputs (``aten.mm`` / ``aten.addmm``) and recomputes the rest, batched
(``bmm``) products included — the reference's
``dots_with_no_batch_dims_saveable``.  All three give the same loss and
gradients.  MoE training under ``spgemm`` needs a block-SpGEMM backward
(ROADMAP.md Queue A item 15b.4).  The sharded step runs the dense
family's layers through ``parallel/runtime.py`` on per-rank shards.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.config import ArchConfig, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MoE
from repro_torch.models import rwkv6 as R
from repro_torch.obs import span

Params = dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# the encoder's blocks: attention (non-causal, no window) and a dense MLP
ENCODER_KIND = {"mixer": "attention", "window": None, "moe": False}


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``TypeError`` for a model dtype the port has no kernels for
    (every architecture of the reference runs)."""
    if cfg.dtype not in _DTYPES:
        raise TypeError(f"{cfg.name}: dtype {cfg.dtype!r}, expected one of "
                        f"{sorted(_DTYPES)}")


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def layer_kinds(cfg: ArchConfig) -> list[dict]:
    """The kind of every layer, in order (the pattern repeated)."""
    kinds = cfg.layer_kinds()
    return [kinds[i % len(kinds)] for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_block(cfg: ArchConfig, kind: dict, gen: torch.Generator,
                dtype, cross: bool = False) -> Params:
    dev = gen.device
    p: Params = {"ln1": L.init_norm(cfg, cfg.d_model, device=dev)}
    if kind["mixer"] == "attention":
        p["attn"] = A.init_attention(cfg, gen, dtype)
    elif kind["mixer"] == "mamba":
        p["mamba"] = M.init_mamba(cfg, gen, dtype)
    elif kind["mixer"] == "rwkv6":
        p["rwkv"] = R.init_rwkv(cfg, gen, dtype)
        p["rwkv_ln2"] = L.init_norm(cfg, cfg.d_model, device=dev)
    else:
        raise ValueError(kind)
    if cfg.post_norm:
        p["post_ln1"] = L.init_norm(cfg, cfg.d_model, device=dev)
    if cross:  # whisper's decoder blocks
        p["xattn"] = A.init_attention(cfg, gen, dtype, cross=True)
        p["ln_x"] = L.init_norm(cfg, cfg.d_model, device=dev)
    if kind["mixer"] == "rwkv6":  # the channel mix replaces the MLP
        return p
    p["ln2"] = L.init_norm(cfg, cfg.d_model, device=dev)
    if kind["moe"]:
        p["moe"] = MoE.init_moe(cfg, gen, dtype)
    else:
        p["mlp"] = L.init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dtype)
    if cfg.post_norm:
        p["post_ln2"] = L.init_norm(cfg, cfg.d_model, device=dev)
    return p


def init_params(cfg: ArchConfig, generator, *, device=None) -> Params:
    """Random parameters drawn on ``device`` (CUDA unless asked otherwise).

    ``generator`` is a ``torch.Generator`` on that device or an int seed.
    The draws differ from the reference's ``jax.random`` ones; parity tests
    carry the reference's parameters across with ``params_from_jax``.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(generator))
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, parameters on {dev}")
    dtype = model_dtype(cfg)
    cross = cfg.encoder is not None
    params = {
        "embed": L.init_embed(cfg, gen, dtype),
        "blocks": [_init_block(cfg, kind, gen, dtype, cross)
                   for kind in layer_kinds(cfg)],
        "final_norm": L.init_norm(cfg, cfg.d_model, device=dev),
    }
    if cross:
        params["encoder"] = {
            "blocks": [_init_block(cfg, ENCODER_KIND, gen, dtype)
                       for _ in range(cfg.encoder.n_layers)],
            "final_norm": L.init_norm(cfg, cfg.d_model, device=dev),
        }
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device) -> Params:
    """Zeroed decode state, one dict per layer by its mixer: K/V
    {"k", "v"} of (batch, hkv, max_len, hd) in the model dtype for
    attention (and with an encoder the cross K/V {"xk", "xv"} of (batch,
    hkv, n_frames, hd)), ``mamba.init_mamba_state`` for mamba and
    ``rwkv6.init_rwkv_state`` for rwkv6."""
    check_supported(cfg)
    shape = (batch, cfg.n_kv_heads, max_len, cfg.hd)
    dtype = model_dtype(cfg)
    enc = cfg.encoder
    blocks = []
    for kind in layer_kinds(cfg):
        if kind["mixer"] == "mamba":
            c = M.init_mamba_state(cfg, batch, dtype, device=device)
        elif kind["mixer"] == "rwkv6":
            c = R.init_rwkv_state(cfg, batch, dtype, device=device)
        else:
            c = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
            if enc is not None:
                xshape = (batch, cfg.n_kv_heads, enc.n_frames, cfg.hd)
                c["xk"] = torch.zeros(xshape, dtype=dtype, device=device)
                c["xv"] = torch.zeros(xshape, dtype=dtype, device=device)
        blocks.append(c)
    return {"blocks": blocks}


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _norm_res(cfg, p, name, post_name, x, sub):
    """Pre-norm residual, with gemma2-style sandwich post-norm."""
    y = sub(L.apply_norm(cfg, p[name], x))
    if cfg.post_norm:
        y = L.apply_norm(cfg, p[post_name], y)
    return x + y


def _update_kv(cache_k, cache_v, k, v, position) -> None:
    """Write new K/V in place at ``position`` (decode) or [0, S) (prefill).

    A vector position (B,) writes each batch slot's single new row at its
    own fill level — continuous-batching refill desynchronizes the slots.
    """
    pos = torch.as_tensor(position)
    if pos.dim() == 0:
        p0 = int(pos)
        cache_k[:, :, p0:p0 + k.shape[2]] = k
        cache_v[:, :, p0:p0 + v.shape[2]] = v
        return
    pos = pos.to(cache_k.device)
    bidx = torch.arange(cache_k.shape[0], device=cache_k.device)
    cache_k[bidx, :, pos, :] = k[:, :, 0, :]
    cache_v[bidx, :, pos, :] = v[:, :, 0, :]


def _ffn_res(cfg, kind, p, x):
    """The block's second residual: MoE (with its aux loss) or the dense
    MLP (aux None)."""
    if not kind["moe"]:
        return _norm_res(cfg, p, "ln2", "post_ln2", x,
                         lambda xn: L.apply_mlp(cfg, p["mlp"], xn)), None
    y, aux = MoE.apply_moe(cfg, p["moe"], L.apply_norm(cfg, p["ln2"], x))
    if cfg.post_norm:
        y = L.apply_norm(cfg, p["post_ln2"], y)
    return x + y, aux


def _store(cache, state) -> None:
    """Write a recurrent mixer's new state into its cache dict in place
    (no cache: nothing to keep)."""
    if cache is not None:
        for name, t in state.items():
            cache[name].copy_(t)


def _mamba_res(cfg, p, x, state, step):
    """The mamba mixer's residual (``step`` is ``apply_mamba`` or
    ``decode_mamba``); returns (x, new state)."""
    y, state = step(cfg, p["mamba"], L.apply_norm(cfg, p["ln1"], x), state)
    if cfg.post_norm:
        y = L.apply_norm(cfg, p["post_ln1"], y)
    return x + y, state


def _rwkv_res(cfg, p, x, state, time_mix, channel_mix):
    """rwkv6's two residuals, time mix then channel mix (the prefill or
    the decode pair of functions); returns (x, new state)."""
    y, state = time_mix(cfg, p["rwkv"], L.apply_norm(cfg, p["ln1"], x),
                        state)
    x = x + y
    y, state = channel_mix(cfg, p["rwkv"],
                           L.apply_norm(cfg, p["rwkv_ln2"], x), state)
    return x + y, state


def _cross_res(cfg, p, x, k, v):
    """whisper's cross-attention residual over the prompt: x + out(attn(
    q(ln_x(x)), k, v)), non-causal (the flash kernel on CUDA)."""
    q = A.cross_q(cfg, p["xattn"], L.apply_norm(cfg, p["ln_x"], x))
    o = A.chunked_attention(q, k, v, causal=False)
    return x + A.out_proj(cfg, p["xattn"], o)


def _cross_decode(cfg, p, x, cache):
    """whisper's cross-attention residual for one token, against the
    cached encoder K/V (every frame valid; zeros if no frames filled it)."""
    q = A.cross_q(cfg, p["xattn"], L.apply_norm(cfg, p["ln_x"], x))
    o = A.decode_attention(q, cache["xk"], cache["xv"], cache["xk"].shape[2])
    return x + A.out_proj(cfg, p["xattn"], o)


def _prefill_block(cfg, kind, p, x, cache, positions, enc_out=None):
    """One layer over the prompt; writes its K/V or its recurrent state
    into ``cache`` (None: ``forward``, states from zero), and with the
    encoder output ``enc_out`` its cross K/V.  Returns (x, MoE aux loss or
    None)."""
    if kind["mixer"] == "mamba":
        x, st = _mamba_res(cfg, p, x, cache, M.apply_mamba)
        _store(cache, st)
        return _ffn_res(cfg, kind, p, x)
    if kind["mixer"] == "rwkv6":
        st = cache if cache is not None else R.init_rwkv_state(
            cfg, x.shape[0], x.dtype, device=x.device)
        x, st = _rwkv_res(cfg, p, x, st, R.apply_rwkv_time_mix,
                          R.apply_rwkv_channel_mix)
        _store(cache, st)
        return x, None
    xn = L.apply_norm(cfg, p["ln1"], x)
    q, k, v = A.qkv_proj(cfg, p["attn"], xn, positions)
    if cache is not None:
        _update_kv(cache["k"], cache["v"], k, v, 0)
    o = A.chunked_attention(q, k, v, causal=True, window=kind.get("window"),
                            softcap=cfg.attn_softcap)
    y = A.out_proj(cfg, p["attn"], o)
    if cfg.post_norm:
        y = L.apply_norm(cfg, p["post_ln1"], y)
    x = x + y
    if enc_out is not None:
        ek, ev = A.cross_kv(cfg, p["xattn"], enc_out)
        if cache is not None:
            cache["xk"].copy_(ek)
            cache["xv"].copy_(ev)
        x = _cross_res(cfg, p, x, ek, ev)
    return _ffn_res(cfg, kind, p, x)


def _apply_block_decode(cfg, kind, p, x, cache, position, rope_pos, length):
    """Single-token decode body; updates ``cache`` in place."""
    if kind["mixer"] == "mamba":
        x, st = _mamba_res(cfg, p, x, cache, M.decode_mamba)
        _store(cache, st)
        return _ffn_res(cfg, kind, p, x)[0]
    if kind["mixer"] == "rwkv6":
        x, st = _rwkv_res(cfg, p, x, cache, R.decode_rwkv_time_mix,
                          R.decode_rwkv_channel_mix)
        _store(cache, st)
        return x
    xn = L.apply_norm(cfg, p["ln1"], x)
    q, k, v = A.qkv_proj(cfg, p["attn"], xn, rope_pos)
    _update_kv(cache["k"], cache["v"], k, v, position)
    o = A.decode_attention(q, cache["k"], cache["v"], length,
                           window=kind.get("window"),
                           softcap=cfg.attn_softcap)
    y = A.out_proj(cfg, p["attn"], o)
    if cfg.post_norm:
        y = L.apply_norm(cfg, p["post_ln1"], y)
    x = x + y
    if "xk" in cache:
        x = _cross_decode(cfg, p, x, cache)
    return _ffn_res(cfg, kind, p, x)[0]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def encode(cfg: ArchConfig, params: Params,
           frame_embeds: torch.Tensor) -> torch.Tensor:
    """whisper's encoder over stub frame embeddings (B, F, d): sinusoidal
    positions (f32, cast to the frames' dtype, then added), the encoder's
    non-causal attention + MLP blocks, the final norm."""
    enc = params["encoder"]
    pe = L.sinusoidal_positions(frame_embeds.shape[1], cfg.d_model,
                                device=frame_embeds.device)
    x = frame_embeds + pe.to(frame_embeds.dtype)
    for p in enc["blocks"]:
        def attn(xn, p=p):
            q, k, v = A.qkv_proj(cfg, p["attn"], xn)
            o = A.chunked_attention(q, k, v, causal=False,
                                    softcap=cfg.attn_softcap)
            return A.out_proj(cfg, p["attn"], o)

        x = _norm_res(cfg, p, "ln1", "post_ln1", x, attn)
        x = _ffn_res(cfg, ENCODER_KIND, p, x)[0]
    return L.apply_norm(cfg, enc["final_norm"], x)


def _embed_inputs(cfg, params, tokens, patch_embeds=None):
    """Token embeddings; pixtral's patch embeddings in place of the first
    ``patch_embeds.shape[1]`` of them; sinusoidal positions (f32, cast,
    then added) when the model has no rope."""
    x = L.embed_tokens(params["embed"], tokens)
    if cfg.frontend == "vision" and patch_embeds is not None:
        n = patch_embeds.shape[1]
        if n > tokens.shape[1]:
            raise ValueError(f"{n} patch embeddings for a {tokens.shape[1]}"
                             "-token prompt: the prompt must hold the "
                             "prefix")
        x = torch.cat([patch_embeds.to(x.dtype), x[:, n:]], dim=1)
    if not cfg.rope:
        pe = L.sinusoidal_positions(x.shape[1], cfg.d_model, device=x.device)
        x = x + pe.to(x.dtype)
    return x


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing: keep 2-D matmul outputs, recompute the
    rest (batched products too)."""
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


REMAT = ("none", "full", "dots")


def _remat_layer(fn, remat: str):
    """``fn`` (one layer) under the ``remat`` policy."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_policy)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    raise ValueError(f"remat {remat!r}: one of {REMAT}")


def _run_blocks(cfg, params, tokens, cache, patch_embeds=None,
                frame_embeds=None, remat: str = "none"):
    """(final hidden, summed MoE aux loss in f32) of a prefill pass; with
    an encoder and frames, the encoder first and cross-attention in every
    decoder block; each layer under ``remat`` (``forward`` only)."""
    layer = _remat_layer(_prefill_block, remat)
    x = _embed_inputs(cfg, params, tokens, patch_embeds)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    enc_out = None
    if cfg.encoder is not None and frame_embeds is not None:
        if cache is not None and frame_embeds.shape[1] != cfg.encoder.n_frames:
            raise ValueError(f"{frame_embeds.shape[1]} frames for a cache "
                             f"of {cfg.encoder.n_frames}")
        enc_out = encode(cfg, params, frame_embeds)
    caches = cache["blocks"] if cache is not None else [None] * cfg.n_layers
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p, c in zip(layer_kinds(cfg), params["blocks"], caches):
        x, a = layer(cfg, kind, p, x, c, positions, enc_out)
        if a is not None:
            aux = aux + a
    return L.apply_norm(cfg, params["final_norm"], x), aux


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, *,
            patch_embeds: torch.Tensor | None = None,
            frame_embeds: torch.Tensor | None = None,
            remat: str = "none",
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Train / prefill forward over (B, S) tokens (pixtral's
    ``patch_embeds`` (B, n, d) as the prefix, whisper's ``frame_embeds``
    (B, F, d) through the encoder): (final hidden (B, S, d), the MoE
    load-balance loss summed over the MoE layers, f32; zero without
    them).  ``remat`` (none | full | dots) checkpoints each layer."""
    check_supported(cfg)
    return _run_blocks(cfg, params, tokens, None, patch_embeds, frame_embeds,
                       remat)


def loss_fn(cfg: ArchConfig, params: Params, batch: dict, *,
            aux_coef: float = 0.01, remat: str = "none",
            loss_chunk: int = 512) -> tuple[torch.Tensor, dict]:
    """Causal-LM loss: the chunked cross-entropy of ``batch["targets"]``
    (``loss_chunk`` positions a chunk) plus ``aux_coef`` times the MoE
    load-balance loss.  Returns (loss, {"ce", "moe_aux"})."""
    x, aux = forward(cfg, params, batch["tokens"],
                     patch_embeds=batch.get("patch_embeds"),
                     frame_embeds=batch.get("frame_embeds"), remat=remat)
    ce = L.chunked_cross_entropy(cfg, params["embed"], x, batch["targets"],
                                 chunk=loss_chunk)
    return ce + aux_coef * aux, {"ce": ce, "moe_aux": aux}


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            cache: Params, *, patch_embeds: torch.Tensor | None = None,
            frame_embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, Params]:
    """Run the prompt, write its K/V into the cache at [0, S) (with frames
    also the encoder's cross K/V) and advance the recurrent states through
    it (from the cache's, zero in a fresh cache), return the last
    position's logits (B, 1, V) and the (updated) cache.  ``patch_embeds``
    and ``frame_embeds`` as in ``forward``."""
    with span("repro.model.prefill"):
        x, _ = _run_blocks(cfg, params, tokens, cache, patch_embeds,
                           frame_embeds)
        logits = L.logits_matmul(cfg, params["embed"], x[:, -1:])
    return logits, cache


def _embed_step(cfg, params, tokens, pv):
    """A decode step's embeddings (B, 1, d); with no rope plus the
    sinusoidal embeddings at the slots' positions (``pv`` 0-d or (B,);
    f32, cast, then added, as in ``_embed_inputs``)."""
    x = L.embed_tokens(params["embed"], tokens)
    if not cfg.rope:
        pe = L.sinusoidal_at(pv.reshape(-1), cfg.d_model)  # (1 or B, d)
        x = x + pe.to(x.dtype)[:, None, :]
    return x


def decode_step(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                cache: Params, position) -> tuple[torch.Tensor, Params]:
    """One serving step: (logits (B, 1, V), the cache updated in place).

    ``tokens`` is (B, 1).  ``position`` is the write offset (the fill
    level): an int / 0-d tensor for all slots, or a (B,) tensor of
    per-slot levels (continuous batching refills slots mid-stream).
    """
    with span("repro.model.decode_step"):
        pv = torch.as_tensor(position, device=tokens.device)
        x = _embed_step(cfg, params, tokens, pv)
        rope_pos = pv[:, None] if pv.dim() else pv.reshape(1)
        for kind, p, c in zip(layer_kinds(cfg), params["blocks"],
                              cache["blocks"]):
            x = _apply_block_decode(cfg, kind, p, x, c, position, rope_pos,
                                    pv + 1)
        x = L.apply_norm(cfg, params["final_norm"], x)
        logits = L.logits_matmul(cfg, params["embed"], x)
    return logits, cache
