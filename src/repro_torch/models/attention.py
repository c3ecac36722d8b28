"""Attention: GQA projections, chunked (flash) attention, decode attention.

The torch twin of ``repro/models/attention.py``.  Paths:
  * prefill — ``chunked_attention``: on CUDA tensors the hand-written flash
    kernel (``kernels/csrc/flash_attention.cu``), the Pallas kernel's port,
    which is what the reference's docstring has replace the jnp loop on
    hardware; on CPU tensors the same online-softmax loop in plain PyTorch
    (``kernels/flash_attention.py::flash_attention_plain``).  In training
    (grad enabled, an input that requires it) it goes through
    ``FlashAttention``, whose backward is the hand-written backward
    kernel on CUDA (``csrc/flash_attention_bwd.cu``) and its plain twin on
    the CPU; the reference differentiates its jnp loop;
  * decode — ``decode_attention``: one query row per slot against the KV
    cache, plain matmuls as in the reference (no kernel there either).

Features: GQA (kv groups), qkv bias (qwen), sliding window + logit softcap
(gemma2), rope on/off, and whisper's cross-attention (``cross_q`` from
the decoder stream, ``cross_kv`` from the encoder output; the blocks'
``init_attention(cross=True)`` carries no qkv bias).
"""
from __future__ import annotations

import torch

from repro_torch.config import ArchConfig
from repro_torch.kernels import flash_attention as FA
from repro_torch.models.layers import _normal, apply_rope
from repro_torch.obs import span
from repro_torch.parallel.ctx import tp_matmul

NEG_INF = FA.NEG_INF


def init_attention(cfg: ArchConfig, gen: torch.Generator, dtype,
                   cross: bool = False) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": _normal(gen, (d, h * hd), d**-0.5, dtype),
        "wk": _normal(gen, (d, hkv * hd), d**-0.5, dtype),
        "wv": _normal(gen, (d, hkv * hd), d**-0.5, dtype),
        "wo": _normal(gen, (h * hd, d), (h * hd) ** -0.5, dtype),
    }
    if cfg.qkv_bias and not cross:
        dev = gen.device
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dtype, device=dev)
    return p


def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> the head-transposed view (B, n, S, hd)."""
    b, s, _ = x.shape
    return x.view(b, s, n, hd).transpose(1, 2)


def qkv_proj(cfg: ArchConfig, p: dict, x: torch.Tensor, positions=None):
    """x (B, S, d) -> q (B, h, S, hd), k/v (B, hkv, S, hd) (head-transposed
    views; rope makes them contiguous)."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = _heads(q, h, hd), _heads(k, hkv, hd), _heads(v, hkv, hd)
    if cfg.rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def cross_q(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """A cross-attention block's queries from the decoder stream x (B, S,
    d): (B, h, S, hd), no rope and no bias (cross blocks have none).  The
    reference takes q of ``qkv_proj(x)`` and drops its k and v; the same
    product, without them."""
    return _heads(x @ p["wq"], cfg.n_heads, cfg.hd)


def cross_kv(cfg: ArchConfig, p: dict, enc: torch.Tensor):
    """A cross-attention block's keys and values from the encoder output
    (B, F, d): head-transposed (B, hkv, F, hd) views (the reference takes
    them from ``qkv_proj(enc)`` and drops its q)."""
    hkv, hd = cfg.n_kv_heads, cfg.hd
    return _heads(enc @ p["wk"], hkv, hd), _heads(enc @ p["wv"], hkv, hd)


def out_proj(cfg: ArchConfig, p: dict, attn: torch.Tensor) -> torch.Tensor:
    """(B, h, S, hd) -> (B, S, d); under ``bf16_reduce`` rules the product
    comes out in the rules' reduce dtype (the partials a tensor-parallel
    psum then sums), as the reference's ``preferred_element_type``."""
    b, h, s, hd = attn.shape
    return tp_matmul(attn.transpose(1, 2).reshape(b, s, h * hd), p["wo"])


def chunked_attention(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax attention with f32 state, any sequence lengths.

    CUDA tensors launch the flash kernel (its own tiles; ``q_chunk`` and
    ``kv_chunk`` shape only the plain loop); CPU tensors run the plain
    loop.  Never the plain loop on a CUDA tensor.  Differentiable: with
    grad enabled the backward runs the flash backward kernels (CUDA) or
    the plain backward (CPU).
    """
    with span("repro.attention"):
        return FA.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk,
                                  q_offset=q_offset)


def decode_scores(
    q: torch.Tensor,  # (B, H, 1, D)
    k: torch.Tensor,  # (B, Hkv, N, D): the cache's keys from key_offset
    length,  # int, 0-d or (B,) tensor: number of valid cache positions
    *,
    key_offset: int = 0,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step's scores against keys at positions ``key_offset +
    j``: f32 (B, Hkv, H / Hkv, N), as the reference's f32-accumulated
    einsum (q and K are cast up, exact for bf16), capped, and ``NEG_INF``
    outside the valid ``length`` and the window; with the mask that keeps
    (broadcastable to the scores)."""
    b, h, _, d = q.shape
    hkv, n = k.shape[1], k.shape[2]
    if scale is None:
        scale = d**-0.5
    qg = q.reshape(b, hkv, h // hkv, d).float()
    s = torch.matmul(qg, k.float().transpose(-1, -2)) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(key_offset, key_offset + n, device=q.device)
    length = torch.as_tensor(length, device=q.device)
    if length.dim() == 0:
        msk = kpos < length
        if window is not None:
            msk &= kpos > length - 1 - window
    else:
        # per-slot cache fill levels (continuous-batching refill)
        msk = kpos[None, :] < length[:, None]  # (B, N)
        if window is not None:
            msk &= kpos[None, :] > length[:, None] - 1 - window
        msk = msk[:, None, None, :]
    return s.masked_fill(~msk, NEG_INF), msk


def decode_attention(
    q: torch.Tensor,  # (B, H, 1, D)
    k_cache: torch.Tensor,  # (B, Hkv, Smax, D)
    v_cache: torch.Tensor,
    length,  # int, 0-d or (B,) tensor: number of valid cache positions
    *,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-step decode attention over a (masked) KV cache.

    Scores by ``decode_scores``; p is rounded to the cache dtype for P.V
    and the result cast to q's dtype, as the reference's.
    """
    b, h, _, d = q.shape
    with span("repro.attention"):
        s, _ = decode_scores(q, k_cache, length, window=window,
                             softcap=softcap, scale=scale)
        p = torch.softmax(s, dim=-1)
        out = torch.matmul(p.to(v_cache.dtype), v_cache)
        return out.reshape(b, h, 1, d).to(q.dtype)


def decode_partial(
    q: torch.Tensor,  # (B, H, 1, D)
    k: torch.Tensor,  # (B, Hkv, N, D): a chunk of the cache from key_offset
    v: torch.Tensor,
    length,
    *,
    key_offset: int,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode attention over one chunk of the cache (keys at positions
    ``key_offset + j``), unnormalised: the scores' max, the sum of their
    exponentials and P.V (P in the cache's dtype), f32 (B, H, 1, 1), (B,
    H, 1, 1), (B, H, 1, D).  Chunks combined by the max
    (``parallel/runtime.py``, the cache's sequence split over ranks) give
    ``decode_attention`` over the whole cache, up to where the rounding to
    the cache's dtype falls."""
    b, h, _, d = q.shape
    s, keep = decode_scores(q, k, length, key_offset=key_offset,
                            window=window, softcap=softcap, scale=scale)
    m = s.amax(-1, keepdim=True)
    e = torch.where(keep, torch.exp(s - m), 0.0)
    acc = torch.matmul(e.to(v.dtype), v).float()
    return (m.reshape(b, h, 1, 1), e.sum(-1).reshape(b, h, 1, 1),
            acc.reshape(b, h, 1, d))
