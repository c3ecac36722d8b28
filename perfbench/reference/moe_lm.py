"""Plain reference of the MoE decoder (deepseek-moe style): the full
forward pass in float32 over whole sequences, one layer at a time, with
no kernels, cache or batching tricks.  Imports nothing of the program.

It follows the published description (arXiv:2401.06066) with the
configuration's departures, which the program also makes:

* every layer is an expert layer (``first_k_dense_replace`` 0; the
  published model's first layer is dense);
* the top-k router weights are renormalised to sum to one
  (``norm_topk_prob`` true); ties in the router go to the lower expert;
* RMSNorm (eps ``rms_norm_eps``) scales by (1 + w), w stored from zero:
  the published weight is 1 + w;
* the shared experts are one SwiGLU of width n_shared * d_expert.

Attention is multi-head, causal, rotary on split halves (theta
``rope_theta``), softmax in float32 at scale hd^-1/2.

``quant="fp8"`` computes every matrix product on operands rounded to
float8 e4m3 (per-tensor scale): the control, a step below bfloat16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _q(t: torch.Tensor, quant: str | None) -> torch.Tensor:
    """``t`` in float32, rounded through float8 e4m3 under ``quant``."""
    t = t.float()
    if quant is None:
        return t
    if quant != "fp8":
        raise ValueError(f"quant {quant!r}")
    s = torch.clamp(t.abs().amax() / FP8_MAX, min=1e-30)
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _mm(x: torch.Tensor, w: torch.Tensor, quant) -> torch.Tensor:
    return _q(x, quant) @ _q(w, quant)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, h, S, hd) at positions 0 .. S - 1."""
    hd, s = x.shape[-1], x.shape[-2]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(cfg: dict, p: dict, x: torch.Tensor, quant) -> torch.Tensor:
    b, s, d = x.shape
    h = cfg["num_attention_heads"]
    hkv = cfg["num_key_value_heads"]
    hd = d // h

    def heads(t, n):
        return t.view(b, s, n, hd).transpose(1, 2)

    q = _rope(heads(_mm(x, p["wq"], quant), h), cfg["rope_theta"])
    k = _rope(heads(_mm(x, p["wk"], quant), hkv), cfg["rope_theta"])
    v = heads(_mm(x, p["wv"], quant), hkv)
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scores = (q @ k.transpose(-1, -2)) * hd ** -0.5
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    o = (probs @ v).transpose(1, 2).reshape(b, s, h * hd)
    return _mm(o, p["wo"], quant)


def _swiglu(x, w_in, w_gate, w_out, quant):
    return _mm(F.silu(_mm(x, w_gate, quant)) * _mm(x, w_in, quant), w_out,
               quant)


def route(cfg: dict, router: torch.Tensor,
          x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights, expert ids), each (T, K): softmax over the experts in
    float32, the top K by a stable descending sort, the weights
    renormalised."""
    probs = torch.softmax(x @ router.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg["num_experts_per_tok"]
    w = vals[:, :k]
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), idx[:, :k]


def _moe(cfg: dict, p: dict, x: torch.Tensor, quant) -> torch.Tensor:
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    w, idx = route(cfg, p["router"], xt)
    y = torch.zeros_like(xt)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = _swiglu(xt[tok], p["w_in"][e], p["w_gate"][e], p["w_out"][e],
                      quant)
        y.index_add_(0, tok, out * w[tok, slot][:, None])
    y = y + _swiglu(xt, p["shared_in"], p["shared_gate"], p["shared_out"],
                    quant)
    return y.reshape(b, s, d)


def final_hidden(cfg: dict, params: dict, tokens: torch.Tensor,
                 quant: str | None = None) -> torch.Tensor:
    """(B, S, d) float32: the final norm's output over ``tokens`` (B, S),
    the layers run one at a time, each layer's weights in float32 only
    while it runs."""
    eps = cfg["rms_norm_eps"]
    x = params["embed"]["tok"][tokens].float()
    for blk in params["blocks"]:
        attn = {k: v.float() for k, v in blk["attn"].items()}
        x = x + _attention(cfg, attn, _rms(x, blk["ln1"]["w"], eps), quant)
        del attn
        moe = {k: v.float() for k, v in blk["moe"].items()}
        x = x + _moe(cfg, moe, _rms(x, blk["ln2"]["w"], eps), quant)
        del moe
    return _rms(x, params["final_norm"]["w"], eps)


def logits(params: dict, hidden: torch.Tensor,
           quant: str | None = None) -> torch.Tensor:
    """(N, V) float32 logits of hidden rows (N, d)."""
    return _mm(hidden, params["embed"]["out"].T, quant)
