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

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

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


def _coeffs(cfg: ArchConfig, p, proj: torch.Tensor):
    """Per-token SSM coefficients from the f32 projection of the conv
    output, proj (..., dt_rank + 2n): (da (..., di, n) decay, db (..., di,
    n) input matrix, c (..., n)), all f32."""
    dt, b, c = _dt_b_c(cfg, p, proj)
    a = -torch.exp(p["a_log"])  # (di, n)
    da = torch.exp(dt[..., None] * a)
    db = dt[..., None] * b[..., None, :]
    return da, db, c


def _ssm_coeffs(cfg: ArchConfig, p, xc: torch.Tensor):
    """``_coeffs`` of the conv output xc (..., di): its ``x_proj`` product
    in the model dtype, then f32."""
    return _coeffs(cfg, p, (xc @ p["x_proj"]).float())


def _scan_loop(da: torch.Tensor, dbx: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """h_t = da_t h_{t-1} + dbx_t over the chunk, in token order, into a
    new (T, B, di, n) tensor (one fused multiply-add per token)."""
    h_all = torch.empty_like(dbx)
    h = h0
    for da_t, dbx_t, out_t in zip(da.unbind(0), dbx.unbind(0),
                                  h_all.unbind(0)):
        h = torch.addcmul(dbx_t, da_t, h, out=out_t)
    return h_all


def _chunk_parts(dt, bm, xf, a, h0):
    """(da, h_all) of one chunk: the decay exp(dt A) and every token's
    state (the reference's casts and order: da, then db = dt B, then
    db x)."""
    da = torch.exp(dt[..., None] * a)
    db = dt[..., None] * bm[..., None, :]
    dbx = db * xf[..., None]
    del db
    return da, _scan_loop(da, dbx, h0)


def _chunk_body(dt, bm, cm, xf, a, d_skip, h0):
    """One chunk of the selective scan from its per-token coefficients, dt
    (T, B, di), B and C (T, B, n), x (T, B, di), all f32, with A (di, n),
    D (di) and the state h0 (B, di, n): (y (T, B, di) = C h + D x, the
    last state)."""
    _, h_all = _chunk_parts(dt, bm, xf, a, h0)
    y = torch.einsum("tbdn,tbn->tbd", h_all, cm)
    return y + d_skip * xf, h_all[-1].clone()


def _chunk_back_body(dt, bm, cm, xf, a, d_skip, h0, gy, gh):
    """The chunk's gradients from gy (T, B, di) and gh (B, di, n): the
    forward recomputed, then the reverse recurrence G_t = dL/dh_t (gy_t
    C_t + da_{t+1} G_{t+1}, gh added to the last) in reverse token
    order."""
    da, h_all = _chunk_parts(dt, bm, xf, a, h0)
    direct = gy[..., None] * cm[:, :, None, :]
    direct[-1] += gh
    big = torch.empty_like(direct)
    acc = big[-1].copy_(direct[-1])
    for t in range(direct.shape[0] - 2, -1, -1):
        acc = torch.addcmul(direct[t], da[t + 1], acc, out=big[t])
    del direct
    g_cm = torch.einsum("tbdn,tbd->tbn", h_all, gy)
    prev = torch.cat([h0[None], h_all[:-1]], dim=0)
    del h_all
    g_da = big * prev * da  # dL/d(dt A): the decay's exponent
    del prev
    g_a = torch.einsum("tbdn,tbd->dn", g_da, dt)
    g_dt = torch.einsum("tbdn,dn->tbd", g_da, a)
    del g_da
    g_dbx_b = torch.einsum("tbdn,tbn->tbd", big, bm)  # dL/d(dt x)
    g_dt = g_dt + g_dbx_b * xf
    g_bm = torch.einsum("tbdn,tbd->tbn", big, dt * xf)
    g_x = g_dbx_b * dt + gy * d_skip
    g_dskip = torch.einsum("tbd,tbd->d", gy, xf)
    g_h0 = da[0] * big[0]
    return g_dt, g_bm, g_cm, g_x, g_a, g_dskip, g_h0


@torch.library.custom_op("repro_torch::mamba_chunk", mutates_args=())
def _chunk_op(dt: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
              xf: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
              h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``_chunk_body`` as one op."""
    return _chunk_body(dt, bm, cm, xf, a, d_skip, h0)


@_chunk_op.register_fake
def _(dt, bm, cm, xf, a, d_skip, h0):
    return torch.empty_like(xf), torch.empty_like(h0)


@torch.library.custom_op("repro_torch::mamba_chunk_bwd", mutates_args=())
def _chunk_back_op(dt: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                   xf: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                   h0: torch.Tensor, gy: torch.Tensor, gh: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """``_chunk_back_body`` as one op."""
    return _chunk_back_body(dt, bm, cm, xf, a, d_skip, h0, gy, gh)


@_chunk_back_op.register_fake
def _(dt, bm, cm, xf, a, d_skip, h0, gy, gh):
    return tuple(torch.empty_like(t) for t in (dt, bm, cm, xf, a, d_skip,
                                               h0))


@functools.lru_cache(maxsize=None)
def _body_flops(fn, shapes: tuple) -> int:
    """``FlopCounterMode``'s count of an eager body on meta inputs of
    ``shapes`` (its einsums)."""
    from torch.utils.flop_counter import FlopCounterMode

    args = [torch.empty(s, dtype=torch.float32, device="meta")
            for s in shapes]
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


@register_flop_formula(torch.ops.repro_torch.mamba_chunk)
def _(*shapes, out_shape=None, **kw):
    return _body_flops(_chunk_body, tuple(map(tuple, shapes)))


@register_flop_formula(torch.ops.repro_torch.mamba_chunk_bwd)
def _(*shapes, out_shape=None, **kw):
    return _body_flops(_chunk_back_body, tuple(map(tuple, shapes)))


def _through_op(t: torch.Tensor) -> bool:
    """Whether a chunk goes through its op (a ``meta`` or fake tensor: the
    dry run's tracer counts the op's body once per shape,
    ``roofline.hlo_cost.BODIES``) rather than straight to its body (which
    a dispatch mode then sees op by op)."""
    return t.device.type not in ("cpu", "cuda") or type(t) is not torch.Tensor


class _Chunk(torch.autograd.Function):
    """A chunk of the scan with a gradient: it saves its small inputs
    only (no (T, B, di, n) coefficient or state), and its backward
    recomputes the chunk and runs the reverse recurrence."""

    @staticmethod
    def forward(ctx, dt, bm, cm, xf, a, d_skip, h0):
        ctx.save_for_backward(dt, bm, cm, xf, a, d_skip, h0)
        run = _chunk_op if _through_op(dt) else _chunk_body
        return run(dt, bm, cm, xf, a, d_skip, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(saved[3])
        if gh is None:
            gh = torch.zeros_like(saved[6])
        run = _chunk_back_op if _through_op(gy) else _chunk_back_body
        return run(*saved, gy.contiguous(), gh.contiguous())


def _chunk(dt, bm, cm, xf, a, d_skip, h0):
    """``_chunk_body`` through ``_Chunk`` when a gradient is to be taken,
    else through its op or straight to it (``_through_op``)."""
    ins = (dt, bm, cm, xf, a, d_skip, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return _Chunk.apply(*ins)
    return (_chunk_op if _through_op(dt) else _chunk_body)(*ins)


def _causal_conv(p, xpad: torch.Tensor, s: int, dc: int) -> torch.Tensor:
    """f32 ``conv_b + sum_i xpad[:, i:i+s] * w[i]``, i = 0 .. dc-1 in
    order (the reference's sum)."""
    w = p["conv_w"].float()
    acc = xpad[:, 0:s].float() * w[0]
    for i in range(1, dc):
        acc = acc + xpad[:, i:i + s].float() * w[i]
    return p["conv_b"].float() + acc


def conv_in(cfg: ArchConfig, p, xi: torch.Tensor, conv: torch.Tensor):
    """The depthwise causal conv of xi (B, S, di) seeded by the carried
    tail ``conv`` (B, d_conv-1, di), then silu, in the model dtype:
    (xc (B, S, di), the new tail)."""
    _, _, dc, _ = mamba_dims(cfg)
    s = xi.shape[1]
    xpad = torch.cat([conv.to(xi.dtype), xi], dim=1)
    xc = F.silu(_causal_conv(p, xpad, s, dc)).to(xi.dtype)
    return xc, (xpad[:, s:].clone() if dc > 1 else conv)


def _dt_b_c(cfg: ArchConfig, p, proj: torch.Tensor):
    """dt (softplus'd, f32), B and C of the f32 projection (..., dt_rank
    + 2n)."""
    _, n, _, dtr = mamba_dims(cfg)
    dt_r, b, c = torch.split(proj, [dtr, n, n], dim=-1)
    return F.softplus(dt_r @ p["dt_proj"].float() + p["dt_bias"]), b, c


def scan(cfg: ArchConfig, p, xc: torch.Tensor, h: torch.Tensor,
         proj: torch.Tensor | None = None):
    """The selective scan of the conv output xc (B, S, di) from the f32
    state h (B, di, n): the coefficients' inputs (dt, B, C) for the whole
    sequence, as the reference makes them, then chunk by chunk,
    token-major (``_chunk``): (y (B, S, di) f32 before the gate, the final
    state).  ``proj`` (B, S, dt_rank + 2n) f32: the ``x_proj`` projection
    made beforehand (the sharded runtime sums its ranks' parts), else
    xc's."""
    m = cfg.mamba or MambaConfig()
    s = xc.shape[1]
    chunk = min(m.chunk, s)
    if s % chunk:
        raise ValueError(f"mamba prefill: sequence length {s} is longer "
                         f"than the chunk {m.chunk} and not a multiple of "
                         "it")
    if proj is None:
        proj = (xc @ p["x_proj"]).float()
    a = -torch.exp(p["a_log"])  # (di, n)
    dt, b, c = _dt_b_c(cfg, p, proj)
    # (T, B, ...) views of every chunk (a split's backward is one cat,
    # into a contiguous (B, S, ...) gradient)
    parts = [[u.transpose(0, 1) for u in t.split(chunk, dim=1)]
             for t in (dt, b, c, xc.float())]
    ys = []
    for dt_i, b_i, c_i, x_i in zip(*parts):
        y, h = _chunk(dt_i, b_i, c_i, x_i, a, p["d_skip"], h)
        ys.append(y)
    return torch.cat([y.transpose(0, 1) for y in ys], dim=1), h


def apply_mamba(cfg: ArchConfig, p, x: torch.Tensor, state=None):
    """x (B, S, d) -> (y (B, S, d), final state).  Chunked selective scan
    from ``state`` (zero when None); ``state`` is not modified."""
    b = x.shape[0]
    xz = x @ p["in_proj"]
    xi, z = xz.chunk(2, dim=-1)  # (B, S, di) each
    if state is None:
        state = init_mamba_state(cfg, b, x.dtype, device=x.device)
    xc, new_conv = conv_in(cfg, p, xi, state["conv"])
    del xz, xi
    y, h = scan(cfg, p, xc, state["ssm"])
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], {"conv": new_conv, "ssm": h}


def decode_conv(cfg: ArchConfig, p, xi: torch.Tensor, conv: torch.Tensor):
    """One token's conv: xi (B, di) against the tail (B, d_conv-1, di):
    (xc (B, di) in the model dtype, the new tail)."""
    _, _, dc, _ = mamba_dims(cfg)
    window = torch.cat([conv.to(xi.dtype), xi[:, None]], dim=1)
    xc = F.silu(_causal_conv(p, window, 1, dc)[:, 0]).to(xi.dtype)
    return xc, window[:, 1:]


def decode_scan(cfg: ArchConfig, p, xc: torch.Tensor, h: torch.Tensor,
                proj: torch.Tensor | None = None):
    """One token's recurrence from h (B, di, n): (y (B, di) f32 before the
    gate, the new state); ``proj`` as in ``scan``."""
    if proj is None:
        da, db, c = _ssm_coeffs(cfg, p, xc)
    else:
        da, db, c = _coeffs(cfg, p, proj)
    xf = xc.float()
    h = h * da + db * xf[..., None]
    return torch.einsum("bdn,bn->bd", h, c) + p["d_skip"] * xf, h


def decode_mamba(cfg: ArchConfig, p, x: torch.Tensor, state):
    """Single-token decode: x (B, 1, d) with the carried state; O(1) per
    token.  Returns (y (B, 1, d), new state); ``state`` is not modified."""
    xz = x[:, 0] @ p["in_proj"]
    xi, z = xz.chunk(2, dim=-1)  # (B, di)
    xc, conv = decode_conv(cfg, p, xi, state["conv"])
    y, h = decode_scan(cfg, p, xc, state["ssm"])
    y = y.to(x.dtype) * F.silu(z)
    return (y @ p["out_proj"])[:, None], {"conv": conv, "ssm": h}
