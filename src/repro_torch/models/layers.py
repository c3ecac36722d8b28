"""Shared model primitives: norms, rope, MLPs, embeddings, the chunked
cross-entropy.

The torch twin of ``repro/models/layers.py``.  Parameters are plain dicts
of tensors with the reference's names and layouts; ``init_*`` draw on the
generator's device.  The reference's ``shard_act("ce_in")`` cut in the
cross-entropy (``head_2p5d``: d over the pod axis) is the sharded
runtime's (``parallel/runtime.py``), which runs the vocab-parallel and 2.5D
forms of ``chunked_cross_entropy`` over per-rank lists.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig
from repro_torch.parallel.ctx import tp_matmul


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32 on the generator's device, then cast."""
    x = torch.randn(shape, generator=gen, device=gen.device)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ArchConfig, d: int, *, device) -> dict:
    if cfg.norm == "rmsnorm":  # gemma-style (1 + w)
        return {"w": torch.zeros((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        return {"w": torch.ones((d,), dtype=torch.float32, device=device),
                "b": torch.zeros((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "nonparametric_ln":
        return {}
    raise ValueError(cfg.norm)


def apply_norm(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """In f32, cast back: rmsnorm eps 1e-6 times (1 + w); layer norms eps
    1e-5 with the population variance."""
    x32 = x.float()
    if cfg.norm == "rmsnorm":
        var = (x32 * x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + 1e-6) * (1.0 + p["w"])
    else:
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        y = (x32 - mu) * torch.rsqrt(var + 1e-5)
        if cfg.norm == "layernorm":
            y = y * p["w"] + p["b"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, *, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, hd), positions (S,) or (B, S); rotates split halves.

    Batched positions (B, S) keep their batch dim aligned with x's leading
    axis and broadcast over the head axes in between (per-slot decode
    positions).
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    ang = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    if positions.dim() == 1:
        while ang.dim() < x.dim():
            ang = ang[None]
    else:
        while ang.dim() < x.dim():
            ang = ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Absolute sinusoidal embeddings (n, d) in f32 at the positions (n,)
    (any integer or float dtype): sin on the even channels, cos on the
    odd ones."""
    dev = positions.device
    pos = positions.to(torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=dev)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((pos.shape[0], d), dtype=torch.float32, device=dev)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def sinusoidal_positions(n: int, d: int, *, device=None) -> torch.Tensor:
    """``sinusoidal_at`` positions 0 .. n - 1."""
    return sinusoidal_at(torch.arange(n, device=device), d)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(cfg: ArchConfig, gen: torch.Generator, d: int, ff: int,
             dtype) -> dict:
    p = {
        "w_in": _normal(gen, (d, ff), d**-0.5, dtype),
        "w_out": _normal(gen, (ff, d), ff**-0.5, dtype),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = _normal(gen, (d, ff), d**-0.5, dtype)
    return p


def apply_mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """swiglu / geglu / gelu; gelu is the tanh form (``jax.nn.gelu``'s
    default).  Under ``bf16_reduce`` rules the down-projection comes out in
    the rules' reduce dtype (``parallel.ctx.tp_reduce_dtype``)."""
    h = x @ p["w_in"]
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    elif cfg.mlp == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return tp_matmul(h, p["w_out"])


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------


def init_embed(cfg: ArchConfig, gen: torch.Generator, dtype) -> dict:
    p = {"tok": _normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype)}
    if not cfg.tie_embeddings:
        p["out"] = _normal(gen, (cfg.vocab, cfg.d_model), cfg.d_model**-0.5,
                           dtype)
    return p


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of the token table (the reference's ``p["tok"][tokens]``).

    ``F.embedding`` rather than indexing for its backward: on CUDA its
    dense backward sums the repeated rows' gradients in f32 before one
    cast to the table's dtype, where bf16 index accumulation would round
    at every repeat (a Zipf batch's top token fills about a tenth of
    it)."""
    return F.embedding(tokens, p["tok"])


def logits_matmul(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T with W the output table (the token table when tied), then
    the optional tanh cap."""
    w = p.get("out", p["tok"])
    logits = x @ w.T
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _ce_chunk(cfg: ArchConfig, p_embed: dict, x: torch.Tensor,
              targets: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one sequence chunk, logits in f32."""
    logits = logits_matmul(cfg, p_embed, x).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.sum(lse - gold)


def chunked_cross_entropy(
    cfg: ArchConfig,
    p_embed: dict,
    x: torch.Tensor,  # (B, S, d) final hidden states
    targets: torch.Tensor,  # (B, S)
    *,
    chunk: int = 512,
) -> torch.Tensor:
    """Mean cross-entropy over B * S without keeping (B, S, V) f32 logits.

    One sequence chunk at a time, each under ``torch.utils.checkpoint``
    (the reference's ``jax.checkpoint`` scan body): a chunk's (B, chunk,
    V) logits are freed after its forward and recomputed in the backward.
    """
    b, s, _ = x.shape
    chunk = min(chunk, s)
    assert s % chunk == 0
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        total = total + checkpoint(_ce_chunk, cfg, p_embed,
                                   x[:, c0:c0 + chunk],
                                   targets[:, c0:c0 + chunk],
                                   use_reentrant=False)
    return total / (b * s)
