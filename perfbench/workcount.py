"""The work the inputs need, and the roofs it is held against.

Every count here is a function of the inputs alone (block masks and norms,
the router's choices, the attention shapes, the published widths), never
of how the program lays the work out: token blocks, list capacities,
padding and group layouts do not enter.  A roofline share is the least
time the chip could take for that work, the larger of operations over the
compute roof and bytes over the memory roof, divided by the measured
kernel time.

Roofs: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W.

* f32 block products: 495 TFLOP/s, the TF32 tensor-core peak.  A
  product accurate to f32 can be split onto the tensor cores (three TF32
  products of hi and lo parts), so a correct kernel may pass the 67
  TFLOP/s of the f32 FMA units; no f32-accurate method passes 495.
* bf16 products (the expert banks, attention, the model): 989 TFLOP/s.
* HBM: 3.35 TB/s.
"""
from __future__ import annotations

import torch

TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# the compute roof of a product by the dtype its operands are stored in
ROOF_BY_DTYPE = {"float32": TF32_FLOPS, "bfloat16": BF16_FLOPS}
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def least_seconds(flops: float, nbytes: float, compute_roof: float) -> float:
    """The least time the chip could take: compute or memory bound."""
    return max(flops / compute_roof, nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# filtered block-sparse products (DBCSR's on-the-fly filter)
# ---------------------------------------------------------------------------


def _kept_cube(a_mask, a_norms, b_mask, b_norms, threshold: float, i0, i1):
    """(i1 - i0, nk, nj) bool: product A_ik B_kj is kept, i.e. both blocks
    are present and |A_ik| |B_kj| > threshold."""
    na = torch.where(a_mask[i0:i1], a_norms[i0:i1].float(), 0.0)
    nb = torch.where(b_mask, b_norms.float(), 0.0)
    return (na[:, :, None] * nb[None, :, :]) > threshold


def kept_products(a_mask, a_norms, b_mask, b_norms, threshold: float,
                  rows: int = 32) -> tuple[int, int]:
    """(kept products A_ik B_kj, present blocks of C): DBCSR's rule, a
    product is kept when both blocks are present and the product of their
    norms exceeds ``threshold``; C_ij is present when any product into it
    is kept.  Counted over row chunks of ``rows`` so the cube never sits
    whole in memory."""
    kept = 0
    c_blocks = 0
    for i0 in range(0, a_mask.shape[0], rows):
        cube = _kept_cube(a_mask, a_norms, b_mask, b_norms, threshold, i0,
                          min(i0 + rows, a_mask.shape[0]))
        kept += int(cube.sum())
        c_blocks += int(cube.any(dim=1).sum())
    return kept, c_blocks


def spgemm_work(a_mask, a_norms, b_mask, b_norms, *, threshold: float,
                bs: int, dtype: str, same_operand: bool) -> dict:
    """FLOPs and bytes one filtered multiply C = A B of bs x bs blocks
    needs: 2 bs^3 per kept product; the present blocks of A and B read
    once (once in all when A is B, as in X X) and C's written once."""
    kept, c_blocks = kept_products(a_mask, a_norms, b_mask, b_norms,
                                   threshold)
    na = int(a_mask.sum())
    nb = 0 if same_operand else int(b_mask.sum())
    return {"flops": 2.0 * bs ** 3 * kept,
            "bytes": float((na + nb + c_blocks) * bs * bs * ITEMSIZE[dtype]),
            "products": kept}


# ---------------------------------------------------------------------------
# routed experts
# ---------------------------------------------------------------------------


def moe_work(top_e: torch.Tensor, *, d_model: int, d_expert: int,
             dtype: str, n_matrices: int = 3) -> dict:
    """FLOPs and bytes one expert layer's routed products need, from the
    router's choices ``top_e`` (..., K): every routed (token, expert) pair
    takes ``n_matrices`` products of 2 d d_e; every distinct expert hit
    has its ``n_matrices`` matrices read once, and each token's
    activations come in once and go out once."""
    choices = top_e.reshape(-1, top_e.shape[-1])
    pairs = choices.numel()
    tokens = choices.shape[0]
    hit = int(torch.unique(choices).numel())
    item = ITEMSIZE[dtype]
    return {
        "flops": 2.0 * n_matrices * d_model * d_expert * pairs,
        "bytes": float(hit * n_matrices * d_model * d_expert * item
                       + 2 * tokens * d_model * item),
        "pairs": pairs,
        "experts_hit": hit,
    }


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def kept_pairs(sq: int, skv: int, *, causal: bool, window: int | None = None,
               q_offset: int = 0) -> int:
    """(query, key) pairs one head of one sequence keeps: key j for query
    i (at position ``q_offset + i``) when j <= that position under
    ``causal``, and within ``window`` of it where one is set."""
    pos = torch.arange(sq, dtype=torch.int64) + q_offset
    hi = torch.clamp(pos + 1, max=skv) if causal else torch.full_like(pos, skv)
    lo = torch.zeros_like(pos)
    if window is not None:
        lo = torch.clamp(pos - window + 1, min=0)
    return int(torch.clamp(hi - lo, min=0).sum())


def flash_work(*, batch: int, heads: int, kv_heads: int, sq: int, skv: int,
               hd: int, causal: bool, dtype: str, window: int | None = None,
               q_offset: int = 0) -> dict:
    """FLOPs and bytes of one attention call: 4 hd per kept pair (Q K^T and
    P V), Q, K, V read once and O written once."""
    pairs = batch * heads * kept_pairs(sq, skv, causal=causal, window=window,
                                       q_offset=q_offset)
    item = ITEMSIZE[dtype]
    nbytes = item * hd * batch * (2 * heads * sq + 2 * kv_heads * skv)
    return {"flops": 4.0 * hd * pairs, "bytes": float(nbytes),
            "pairs": pairs}


# ---------------------------------------------------------------------------
# the whole model, from the published widths
# ---------------------------------------------------------------------------


def lm_token_flops(cfg: dict, keys: int) -> float:
    """Model FLOPs of one token through every layer of a MoE decoder (the
    configuration's published widths, HF key names) that attends to
    ``keys`` positions: the q, k, v, o projections, the router, the routed
    and shared experts (3 products each) and 4 d per attended key."""
    d = cfg["hidden_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    de = cfg["moe_intermediate_size"]
    experts = cfg["num_experts_per_tok"] + cfg["n_shared_experts"]
    per_layer = (2 * d * (2 * h * hd + 2 * hkv * hd)
                 + 2 * d * cfg["n_routed_experts"]
                 + 2 * 3 * d * de * experts
                 + 4 * h * hd * keys)
    return float(cfg["num_hidden_layers"] * per_layer)


def lm_head_flops(cfg: dict) -> float:
    """The output head's FLOPs for one position's logits."""
    return 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def lm_prefill_flops(cfg: dict, prompt_len: int) -> float:
    """One prompt's prefill: every position attends causally, logits at
    the last position only."""
    total = sum(lm_token_flops(cfg, p + 1) for p in range(prompt_len))
    return total + lm_head_flops(cfg)


def lm_decode_flops(cfg: dict, position: int) -> float:
    """One decoded token written at ``position`` (it attends to position +
    1 keys), with its logits."""
    return lm_token_flops(cfg, position + 1) + lm_head_flops(cfg)
