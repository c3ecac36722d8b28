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
in another order.  Each chunk of ``rwkv.chunk`` tokens is one op,
``repro_torch::rwkv_wkv_chunk`` (an autograd Function, as mamba's chunk
is): its forward saves only the chunk's inputs and its entry state, and
its backward (``repro_torch::rwkv_wkv_chunk_bwd``) recomputes the chunk's
states and runs the recurrence in reverse, so a training step holds no
per-token (B, h, hd, hd) state.  Autograd through the token loop keeps
two such tensors a token (8.6 GB a layer for 4 x 2,048 tokens at 32
heads).  There is no Pallas kernel here in the reference and none in the
port (a wkv kernel is ROADMAP follow-up work).  Decode carries (last
token, state): O(1) per token.

The head count is read from the weights' widths, so the sharded runtime
(``parallel/runtime.py``) runs these functions on a rank's heads: its
column shards of ``wr`` / ``wk`` / ``wv`` / ``wg`` / ``decay_w2``, its
slices of ``decay_base`` / ``bonus_u`` / ``ln_x_w`` and its row shard of
``wo``; the row-parallel products (``wo``, ``cv``) go through
``ctx.tp_matmul``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.config import ArchConfig, RWKVConfig
from repro_torch.models.layers import _normal
from repro_torch.models.mamba import _body_flops, _through_op
from repro_torch.parallel.ctx import tp_matmul


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
    """Per-head LayerNorm of the time-mix output (RWKV's ln_x; ``h``
    heads of ``hd``, -1: as many as x's width holds), in f32 with the
    population variance, cast back."""
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
    _, hd, _ = rwkv_dims(cfg)
    mu = p["mu_rkvg"]
    xr, xk, xv, xg = (_shift_mix(x, x_prev, mu[i]) for i in range(4))
    xw = _shift_mix(x, x_prev, p["mu_w"])

    shp = x.shape[:-1] + (-1, hd)
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


def _wkv_chunk_body(r, k, v, w, u, s0):
    """One chunk of the recurrence, token by token in order: r, k, v, w
    (T, B, h, hd) f32 token-major, the bonus u (h, hd) and the entry state
    s0 (B, h, hd, hd).  Returns (the outputs (T, B, h, hd), the last
    state).  ``_wkv_step``'s arithmetic, its outer products k^T v made for
    the whole chunk at once (the same products), so a token launches
    three kernels, not four."""
    u_col = u[None, :, :, None]
    kv = k[..., :, None] * v[..., None, :]  # (T, B, h, hd, hd)
    st, outs = s0, []
    for r_t, kv_t, w_t in zip(r.unsqueeze(-2).unbind(0), kv.unbind(0),
                              w.unsqueeze(-1).unbind(0)):
        outs.append(torch.matmul(r_t, torch.addcmul(st, u_col, kv_t)))
        st = torch.addcmul(kv_t, w_t, st)
    return torch.stack(outs, 0).squeeze(-2), st


def _wkv_chunk_back_body(r, k, v, w, u, s0, gy, gs):
    """The chunk's gradients from gy (T, B, h, hd) and gs (the last
    state's): the states S_0 .. S_{T-1} recomputed, then H_t = dL/dS_t in
    reverse token order, H_{t-1} = r_t^T gy_t + diag(w_t) H_t from H_T =
    gs.  Returns (dr, dk, dv, dw, du, ds0)."""
    kv = k[..., :, None] * v[..., None, :]  # (T, B, h, hd, hd)
    prev = torch.empty_like(kv)  # S_{t-1}, the state each token reads
    st = s0
    for t in range(kv.shape[0]):
        prev[t] = st
        st = torch.addcmul(kv[t], w[t][..., None], st)
    dm = r[..., :, None] * gy[..., None, :]  # dL/dM_t, M_t = S + diag(u) kv
    big = torch.empty_like(kv)  # H_t, the gradient of the state after t
    acc = gs
    for t in range(kv.shape[0] - 1, -1, -1):
        big[t] = acc
        acc = torch.addcmul(dm[t], w[t][..., None], acc)
    u_col = u[:, :, None]
    dr = torch.einsum("tbhij,tbhj->tbhi", torch.addcmul(prev, u_col, kv), gy)
    dw = (big * prev).sum(-1)
    del prev
    du = (kv * dm).sum((0, 1, 4))
    del kv
    dkv = torch.addcmul(big, u_col, dm)
    del big, dm
    dk = torch.einsum("tbhij,tbhj->tbhi", dkv, v)
    dv = torch.einsum("tbhij,tbhi->tbhj", dkv, k)
    return dr, dk, dv, dw, du, acc


@torch.library.custom_op("repro_torch::rwkv_wkv_chunk", mutates_args=())
def _wkv_chunk_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_wkv_chunk_body`` as one op."""
    return _wkv_chunk_body(r, k, v, w, u, s0)


@_wkv_chunk_op.register_fake
def _(r, k, v, w, u, s0):
    return torch.empty_like(r), torch.empty_like(s0)


@torch.library.custom_op("repro_torch::rwkv_wkv_chunk_bwd", mutates_args=())
def _wkv_chunk_back_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                       gy: torch.Tensor, gs: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_wkv_chunk_back_body`` as one op."""
    return _wkv_chunk_back_body(r, k, v, w, u, s0, gy, gs)


@_wkv_chunk_back_op.register_fake
def _(r, k, v, w, u, s0, gy, gs):
    return tuple(torch.empty_like(t) for t in (r, k, v, w, u, s0))


@register_flop_formula(torch.ops.repro_torch.rwkv_wkv_chunk)
def _(*shapes, out_shape=None, **kw):
    return _body_flops(_wkv_chunk_body, tuple(map(tuple, shapes)))


@register_flop_formula(torch.ops.repro_torch.rwkv_wkv_chunk_bwd)
def _(*shapes, out_shape=None, **kw):
    return _body_flops(_wkv_chunk_back_body, tuple(map(tuple, shapes)))


class _WkvChunk(torch.autograd.Function):
    """A chunk of the recurrence with a gradient: it saves its inputs and
    entry state only, and its backward recomputes the chunk's states."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        run = _wkv_chunk_op if _through_op(r) else _wkv_chunk_body
        return run(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, gy, gs):
        saved = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(saved[0])
        if gs is None:
            gs = torch.zeros_like(saved[5])
        run = _wkv_chunk_back_op if _through_op(gy) else _wkv_chunk_back_body
        return run(*saved, gy.contiguous(), gs.contiguous())


def rwkv_wkv_chunk(r, k, v, w, u, s0):
    """``_wkv_chunk_body`` through ``_WkvChunk`` when a gradient is to be
    taken, else through its op or straight to it (``mamba._through_op``).
    """
    ins = (r, k, v, w, u, s0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return _WkvChunk.apply(*ins)
    return (_wkv_chunk_op if _through_op(r) else _wkv_chunk_body)(*ins)


def apply_rwkv_time_mix(cfg: ArchConfig, p, x: torch.Tensor, state):
    """Time mix over a sequence. x (B, S, d) -> (y, new state); ``state``
    is not modified.  The recurrence runs one ``rwkv_wkv_chunk`` a chunk
    on token-major (S, B, h, hd) f32 operands."""
    r_cfg = cfg.rwkv or RWKVConfig()
    _, hd, _ = rwkv_dims(cfg)
    b, s, _ = x.shape
    chunk = min(r_cfg.chunk, s)
    if s % chunk:
        raise ValueError(f"rwkv6 prefill: sequence length {s} is longer "
                         f"than the chunk {r_cfg.chunk} and not a multiple "
                         "of it")

    x_prev = torch.cat([state["shift_t"][:, None].to(x.dtype), x[:, :-1]], 1)
    r, k, v, g, w = _time_mix_projections(cfg, p, x, x_prev)
    del x_prev
    rf, kf, vf = _scaled(r, k, v, hd)
    tm = [t.transpose(0, 1).contiguous() for t in (rf, kf, vf, w)]
    del r, k, v, w, rf, kf, vf
    st = state["wkv"]
    outs = []
    for c0 in range(0, s, chunk):
        o, st = rwkv_wkv_chunk(*(t[c0:c0 + chunk] for t in tm),
                               p["bonus_u"], st)
        outs.append(o)
    y = torch.cat(outs, 0).transpose(0, 1).reshape(b, s, -1)
    y = _group_norm(y.to(x.dtype), -1, hd, p["ln_x_w"]) * g
    return tp_matmul(y, p["wo"]), dict(state, shift_t=x[:, -1], wkv=st)


def channel_parts(p, x, x_prev):
    """The channel mix's gate sigmoid(xr cr) and value relu(xk ck)^2 cv
    (a partial sum over ``model`` on a rank: ``cv`` is row-parallel), whose
    product is the output."""
    mu = p["mu_c"]
    xk = _shift_mix(x, x_prev, mu[0])
    xr = _shift_mix(x, x_prev, mu[1])
    kk = torch.square(F.relu(xk @ p["ck"]))
    return torch.sigmoid(xr @ p["cr"]), tp_matmul(kk, p["cv"])


def _channel_mix(p, x, x_prev):
    gate, value = channel_parts(p, x, x_prev)
    return gate * value


def apply_rwkv_channel_mix(cfg: ArchConfig, p, x: torch.Tensor, state):
    """Squared-relu channel mix with token shift. x (B, S, d) -> (y, new
    state); ``state`` is not modified."""
    x_prev = torch.cat([state["shift_c"][:, None].to(x.dtype), x[:, :-1]], 1)
    return _channel_mix(p, x, x_prev), dict(state, shift_c=x[:, -1])


def decode_rwkv_time_mix(cfg: ArchConfig, p, x: torch.Tensor, state):
    """Single-token time mix: x (B, 1, d) -> (y (B, 1, d), new state)."""
    _, hd, _ = rwkv_dims(cfg)
    xt = x[:, 0]
    r, k, v, g, w = _time_mix_projections(cfg, p, xt,
                                          state["shift_t"].to(x.dtype))
    rf, kf, vf = _scaled(r, k, v, hd)
    s_new, out = _wkv_step(state["wkv"], rf[..., None, :], kf[..., :, None],
                           vf[..., None, :], w[..., :, None],
                           p["bonus_u"][None, :, :, None])
    y = out.reshape(xt.shape[0], -1)
    y = _group_norm(y.to(x.dtype), -1, hd, p["ln_x_w"]) * g
    return tp_matmul(y, p["wo"])[:, None], dict(state, shift_t=xt,
                                                 wkv=s_new)


def decode_rwkv_channel_mix(cfg: ArchConfig, p, x: torch.Tensor, state):
    """Single-token channel mix: x (B, 1, d) -> (y (B, 1, d), new state)."""
    xt = x[:, 0]
    y = _channel_mix(p, xt, state["shift_c"].to(x.dtype))
    return y[:, None], dict(state, shift_c=xt)
