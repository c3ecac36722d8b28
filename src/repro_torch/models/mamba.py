"""Mamba (S6 selective state space) mixer — the jamba hybrid's workhorse.

The torch twin of ``repro/models/mamba.py`` (Gu & Dao 2023, as configured
by jamba-v0.1): in_proj (d -> 2*di), depthwise causal conv (d_conv),
x_proj (di -> dt_rank + 2*d_state), dt_proj (dt_rank -> di), the diagonal
selective recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,
y_t = C_t h_t + D x_t, gated by silu(z), out_proj (di -> d).

Casts are the reference's: the conv is the f32 sum
``conv_b + sum_i xpad[i:i+S] * w[i]`` in the order i = 0 .. d_conv-1
(not ``F.conv1d``, which adds in another order), ``xc`` is cast to the
model dtype before ``x_proj``, the projection goes to f32 before the
split, ``dt`` is softplus'd in f32, ``A = -exp(a_log)``, and the SSM state
is f32.

Prefill runs the recurrence one chunk of ``mamba.chunk`` tokens at a
time, carrying h across chunks, and builds the per-token coefficients
(decay ``da``, input ``db * x``; (T, B, di, d_state) f32 each) inside the
chunk loop: the reference builds them for the whole sequence before it
chunks them, which at jamba's width (di 8,192) and 8 x 2,048 tokens is
8 GiB per tensor.  Within a chunk the scan is a step loop in token order
(one fused multiply-add per token); the reference's
``lax.associative_scan`` computes the same recurrence in another
association order, so the two agree to f32 rounding.  No
cumulative-product "divide by the running decay" form: ``da`` underflows
to 0 within a chunk for |A| up to d_state.  There is no Pallas kernel in
the reference here and none in the port (a fused selective-scan kernel is
ROADMAP follow-up work).  Decode is the O(1) single-token recurrence on
the carried state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig, MambaConfig
from repro_torch.models.layers import _normal


def mamba_dims(cfg: ArchConfig) -> tuple[int, int, int, int]:
    """(d_inner, d_state, d_conv, dt_rank)."""
    m = cfg.mamba or MambaConfig()
    di = m.expand * cfg.d_model
    dt_rank = max(cfg.d_model // 16, 1)
    return di, m.d_state, m.d_conv, dt_rank


def init_mamba(cfg: ArchConfig, gen: torch.Generator, dtype) -> dict:
    """The reference's parameters and layouts, drawn on the generator's
    device: S4D-real A (``a_log``, f32), dt bias the inverse softplus of
    a log-uniform dt in [1e-3, 1e-1] (f32), ``d_skip`` ones (f32)."""
    d = cfg.d_model
    di, n, dc, dtr = mamba_dims(cfg)
    dev = gen.device
    f32 = torch.float32
    a_init = torch.arange(1, n + 1, dtype=f32, device=dev)[None].repeat(di, 1)
    u = torch.rand((di,), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "in_proj": _normal(gen, (d, 2 * di), d**-0.5, dtype),
        "conv_w": _normal(gen, (dc, di), dc**-0.5, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": _normal(gen, (di, dtr + 2 * n), di**-0.5, dtype),
        "dt_proj": _normal(gen, (dtr, di), dtr**-0.5, dtype),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),  # inverse softplus
        "a_log": torch.log(a_init),  # (di, n); A = -exp(a_log)
        "d_skip": torch.ones((di,), dtype=f32, device=dev),
        "out_proj": _normal(gen, (di, d), di**-0.5, dtype),
    }


def init_mamba_state(cfg: ArchConfig, batch: int, dtype, *, device) -> dict:
    """Conv tail (B, d_conv-1, di) in the model dtype and SSM state
    (B, di, d_state) in f32, both zero."""
    di, n, dc, _ = mamba_dims(cfg)
    return {
        "conv": torch.zeros((batch, dc - 1, di), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, di, n), dtype=torch.float32,
                           device=device),
    }


def _ssm_coeffs(cfg: ArchConfig, p, xc: torch.Tensor):
    """Per-token SSM coefficients from the conv output xc (..., di).

    Returns (da (..., di, n) decay, db (..., di, n) input matrix,
    c (..., n)), all f32.
    """
    _, n, _, dtr = mamba_dims(cfg)
    proj = xc @ p["x_proj"]  # (..., dtr + 2n) in the model dtype
    dt_r, b, c = torch.split(proj.float(), [dtr, n, n], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"].float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])  # (di, n)
    da = torch.exp(dt[..., None] * a)
    db = dt[..., None] * b[..., None, :]
    return da, db, c


def _chunk_scan(da: torch.Tensor, dbx: torch.Tensor, h0: torch.Tensor):
    """h_t = da_t h_{t-1} + dbx_t over the chunk, in token order.

    da / dbx: (T, B, di, n); h0: (B, di, n).  Returns (h (T, B, di, n),
    h_T)."""
    h_all = torch.empty_like(dbx)
    h = h0
    for da_t, dbx_t, out_t in zip(da.unbind(0), dbx.unbind(0),
                                  h_all.unbind(0)):
        h = torch.addcmul(dbx_t, da_t, h, out=out_t)
    return h_all, h


def _causal_conv(p, xpad: torch.Tensor, s: int, dc: int) -> torch.Tensor:
    """f32 ``conv_b + sum_i xpad[:, i:i+s] * w[i]``, i = 0 .. dc-1 in
    order (the reference's sum)."""
    w = p["conv_w"].float()
    acc = xpad[:, 0:s].float() * w[0]
    for i in range(1, dc):
        acc = acc + xpad[:, i:i + s].float() * w[i]
    return p["conv_b"].float() + acc


def apply_mamba(cfg: ArchConfig, p, x: torch.Tensor, state=None):
    """x (B, S, d) -> (y (B, S, d), final state).  Chunked selective scan
    from ``state`` (zero when None); ``state`` is not modified."""
    m = cfg.mamba or MambaConfig()
    _, _, dc, _ = mamba_dims(cfg)
    b, s, _ = x.shape
    chunk = min(m.chunk, s)
    if s % chunk:
        raise ValueError(f"mamba prefill: sequence length {s} is longer "
                         f"than the chunk {m.chunk} and not a multiple of "
                         "it")

    xz = x @ p["in_proj"]
    xi, z = xz.chunk(2, dim=-1)  # (B, S, di) each
    if state is None:
        state = init_mamba_state(cfg, b, x.dtype, device=x.device)

    # depthwise causal conv over the sequence, seeded by the carried tail
    xpad = torch.cat([state["conv"].to(xi.dtype), xi], dim=1)
    xc = F.silu(_causal_conv(p, xpad, s, dc)).to(x.dtype)  # (B, S, di)
    new_conv = xpad[:, s:].clone() if dc > 1 else state["conv"]
    del xz, xi, xpad

    # chunk by chunk, token-major: coefficients for T tokens at a time
    h = state["ssm"]
    ys = []
    for c0 in range(0, s, chunk):
        xt = xc[:, c0:c0 + chunk].transpose(0, 1).contiguous()  # (T, B, di)
        xf = xt.float()
        da, db, c = _ssm_coeffs(cfg, p, xt)
        dbx = db * xf[..., None]
        del db
        h_all, h = _chunk_scan(da, dbx, h)
        del da, dbx
        y = torch.einsum("tbdn,tbn->tbd", h_all, c)  # (T, B, di)
        ys.append(y + p["d_skip"] * xf)
        h = h.clone()  # the last row, without keeping h_all alive
        del h_all
    y = torch.cat(ys, 0).transpose(0, 1).to(x.dtype)  # (B, S, di)
    y = y * F.silu(z)
    return y @ p["out_proj"], {"conv": new_conv, "ssm": h}


def decode_mamba(cfg: ArchConfig, p, x: torch.Tensor, state):
    """Single-token decode: x (B, 1, d) with the carried state; O(1) per
    token.  Returns (y (B, 1, d), new state); ``state`` is not modified."""
    _, _, dc, _ = mamba_dims(cfg)
    xz = x[:, 0] @ p["in_proj"]
    xi, z = xz.chunk(2, dim=-1)  # (B, di)

    window = torch.cat([state["conv"].to(xi.dtype), xi[:, None]], dim=1)
    xc = F.silu(_causal_conv(p, window, 1, dc)[:, 0]).to(x.dtype)  # (B, di)

    da, db, c = _ssm_coeffs(cfg, p, xc)
    xf = xc.float()
    h = state["ssm"] * da + db * xf[..., None]
    y = torch.einsum("bdn,bn->bd", h, c) + p["d_skip"] * xf
    y = y.to(x.dtype) * F.silu(z)
    return (y @ p["out_proj"])[:, None], {"conv": window[:, 1:], "ssm": h}
