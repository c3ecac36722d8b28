"""RWKV-6 "Finch" mixer (arXiv:2404.05892) — attention-free, data-dependent
per-channel decay.

The torch twin of ``repro/models/rwkv6.py``.  Time-mix, per head of size
hd:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (state S (hd, hd), f32)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

where r, k, v, g are projections of token-shift-interpolated inputs (r
and k scaled by hd^-0.5 before the recurrence), the decay
w_t = exp(-exp(wd_t)) is data dependent (a LoRA on the shifted input),
and u is the per-channel bonus of the current token.  The output goes
through a per-head group norm (population variance, eps 1e-5) gated by
silu(g).  Channel-mix is the squared-relu token-shift MLP.

The state update is a rank-1, non-diagonal recurrence, so the reference
runs a step scan token by token (inside chunks that only bound its
memory); the port runs the same loop over the tokens in the same order,
with the state in f32 — not a chunked "linear attention" form, which sums
in another order.  There is no Pallas kernel here in the reference and
none in the port (a wkv kernel is ROADMAP follow-up work).  Decode carries
(last token, state): O(1) per token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig, RWKVConfig
from repro_torch.models.layers import _normal


def rwkv_dims(cfg: ArchConfig) -> tuple[int, int, int]:
    """(heads, head_dim, decay LoRA rank)."""
    r = cfg.rwkv or RWKVConfig()
    assert cfg.d_model % r.head_dim == 0
    return cfg.d_model // r.head_dim, r.head_dim, r.decay_lora


def init_rwkv(cfg: ArchConfig, gen: torch.Generator, dtype) -> dict:
    """The reference's parameters and layouts, drawn on the generator's
    device; the interpolation factors, decay base, bonus and group-norm
    gain are f32."""
    d = cfg.d_model
    h, hd, lora = rwkv_dims(cfg)
    dev = gen.device
    f32 = torch.float32
    s = d**-0.5

    def full(shape, value):
        return torch.full(shape, value, dtype=f32, device=dev)

    return {
        # token-shift interpolation factors (static part)
        "mu_rkvg": full((4, d), 0.5),
        "mu_w": full((d,), 0.5),
        "wr": _normal(gen, (d, d), s, dtype),
        "wk": _normal(gen, (d, d), s, dtype),
        "wv": _normal(gen, (d, d), s, dtype),
        "wg": _normal(gen, (d, d), s, dtype),
        "wo": _normal(gen, (d, d), s, dtype),
        # data-dependent decay LoRA: wd_t = base + tanh(x W1) W2
        "decay_base": full((d,), -2.0),
        "decay_w1": _normal(gen, (d, lora), s, dtype),
        "decay_w2": _normal(gen, (lora, d), lora**-0.5, dtype),
        "bonus_u": full((h, hd), 0.0),
        "ln_x_w": full((d,), 1.0),  # per-head group norm gain
        # channel mix
        "mu_c": full((2, d), 0.5),
        "ck": _normal(gen, (d, cfg.d_ff), s, dtype),
        "cv": _normal(gen, (cfg.d_ff, d), cfg.d_ff**-0.5, dtype),
        "cr": _normal(gen, (d, d), s, dtype),
    }


def init_rwkv_state(cfg: ArchConfig, batch: int, dtype, *, device) -> dict:
    """Token-shift tails (B, d) of both mixes in the model dtype and the
    wkv state (B, h, hd, hd) in f32, all zero."""
    h, hd, _ = rwkv_dims(cfg)
    return {
        "shift_t": torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
        "shift_c": torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
        "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                           device=device),
    }


def _group_norm(x: torch.Tensor, h: int, hd: int, gain) -> torch.Tensor:
    """Per-head LayerNorm of the time-mix output (RWKV's ln_x), in f32
    with the population variance, cast back."""
    xs = x.reshape(x.shape[:-1] + (h, hd)).float()
    mu = xs.mean(-1, keepdim=True)
    var = xs.var(-1, keepdim=True, correction=0)
    y = (xs - mu) * torch.rsqrt(var + 1e-5)
    return (y.reshape(x.shape) * gain).to(x.dtype)


def _shift_mix(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def _time_mix_projections(cfg: ArchConfig, p, x: torch.Tensor,
                          x_prev: torch.Tensor):
    """Shifted interpolation + r/k/v/g/decay projections.

    x, x_prev: (..., d) current tokens and previous-token values.  Returns
    r, k, v (..., h, hd) in the model dtype, g (..., d), and the decay w
    (..., h, hd) in f32.
    """
    h, hd, _ = rwkv_dims(cfg)
    mu = p["mu_rkvg"]
    xr, xk, xv, xg = (_shift_mix(x, x_prev, mu[i]) for i in range(4))
    xw = _shift_mix(x, x_prev, p["mu_w"])

    shp = x.shape[:-1] + (h, hd)
    r = (xr @ p["wr"]).reshape(shp)
    k = (xk @ p["wk"]).reshape(shp)
    v = (xv @ p["wv"]).reshape(shp)
    g = F.silu(xg @ p["wg"])
    wd = p["decay_base"] + (
        torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]).float()
    w = torch.exp(-torch.exp(wd.reshape(shp)))  # decay in (0, 1)
    return r, k, v, g, w


def _wkv_step(s, r_row, k_col, v_row, w_col, u_col):
    """One-token state update, on operands shaped for broadcasting:
    s (B, h, hd, hd); r_row, v_row (B, h, 1, hd); k_col, w_col
    (B, h, hd, 1); u_col (1, h, hd, 1).  Returns (new state, output
    (B, h, 1, hd)): o = r (S + diag(u) k^T v), S' = diag(w) S + k^T v."""
    kv = k_col * v_row  # (B, h, hd, hd) outer product
    out = torch.matmul(r_row, torch.addcmul(s, u_col, kv))
    return torch.addcmul(kv, w_col, s), out


def _scaled(r, k, v, hd: int):
    """r and k in f32 scaled by hd^-0.5, v in f32."""
    return (r.float() * hd**-0.5, k.float() * hd**-0.5, v.float())


def apply_rwkv_time_mix(cfg: ArchConfig, p, x: torch.Tensor, state):
    """Time mix over a sequence. x (B, S, d) -> (y, new state); ``state``
    is not modified."""
    r_cfg = cfg.rwkv or RWKVConfig()
    h, hd, _ = rwkv_dims(cfg)
    b, s, d = x.shape
    chunk = min(r_cfg.chunk, s)
    if s % chunk:
        raise ValueError(f"rwkv6 prefill: sequence length {s} is longer "
                         f"than the chunk {r_cfg.chunk} and not a multiple "
                         "of it")

    x_prev = torch.cat([state["shift_t"][:, None].to(x.dtype), x[:, :-1]], 1)
    r, k, v, g, w = _time_mix_projections(cfg, p, x, x_prev)
    del x_prev
    rf, kf, vf = _scaled(r, k, v, hd)
    # token-major and shaped for broadcasting once, then one view per
    # token: the loop below launches four kernels a token and little else
    rows = (rf.transpose(0, 1).unsqueeze(-2).contiguous().unbind(0),
            kf.transpose(0, 1).unsqueeze(-1).contiguous().unbind(0),
            vf.transpose(0, 1).unsqueeze(-2).contiguous().unbind(0),
            w.transpose(0, 1).unsqueeze(-1).contiguous().unbind(0))
    del r, k, v, w, rf, kf, vf
    u_col = p["bonus_u"][None, :, :, None]
    st = state["wkv"]
    outs = []
    for r_t, k_t, v_t, w_t in zip(*rows):
        st, o = _wkv_step(st, r_t, k_t, v_t, w_t, u_col)
        outs.append(o)
    y = torch.stack(outs, 1).reshape(b, s, d)
    y = _group_norm(y.to(x.dtype), h, hd, p["ln_x_w"]) * g
    return y @ p["wo"], dict(state, shift_t=x[:, -1], wkv=st)


def _channel_mix(p, x, x_prev):
    mu = p["mu_c"]
    xk = _shift_mix(x, x_prev, mu[0])
    xr = _shift_mix(x, x_prev, mu[1])
    kk = torch.square(F.relu(xk @ p["ck"]))
    return torch.sigmoid(xr @ p["cr"]) * (kk @ p["cv"])


def apply_rwkv_channel_mix(cfg: ArchConfig, p, x: torch.Tensor, state):
    """Squared-relu channel mix with token shift. x (B, S, d) -> (y, new
    state); ``state`` is not modified."""
    x_prev = torch.cat([state["shift_c"][:, None].to(x.dtype), x[:, :-1]], 1)
    return _channel_mix(p, x, x_prev), dict(state, shift_c=x[:, -1])


def decode_rwkv_time_mix(cfg: ArchConfig, p, x: torch.Tensor, state):
    """Single-token time mix: x (B, 1, d) -> (y (B, 1, d), new state)."""
    h, hd, _ = rwkv_dims(cfg)
    xt = x[:, 0]
    r, k, v, g, w = _time_mix_projections(cfg, p, xt,
                                          state["shift_t"].to(x.dtype))
    rf, kf, vf = _scaled(r, k, v, hd)
    s_new, out = _wkv_step(state["wkv"], rf[..., None, :], kf[..., :, None],
                           vf[..., None, :], w[..., :, None],
                           p["bonus_u"][None, :, :, None])
    y = out.reshape(xt.shape[0], -1)
    y = _group_norm(y.to(x.dtype), h, hd, p["ln_x_w"]) * g
    return (y @ p["wo"])[:, None], dict(state, shift_t=xt, wkv=s_new)


def decode_rwkv_channel_mix(cfg: ArchConfig, p, x: torch.Tensor, state):
    """Single-token channel mix: x (B, 1, d) -> (y (B, 1, d), new state)."""
    xt = x[:, 0]
    y = _channel_mix(p, xt, state["shift_c"].to(x.dtype))
    return y[:, None], dict(state, shift_c=xt)
