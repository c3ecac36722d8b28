"""Mixture-of-Experts layer (llama4 / deepseek-moe / jamba) — the torch twin
of ``repro/models/moe.py``.

Four dispatch implementations, selectable via ``MoEConfig.impl``:

* ``dense``  — every expert processes every token, gated combine: exact
  (no capacity drops), the oracle, looped over experts to bound memory.
* ``tp``     — capacity-based scatter dispatch per batch row into an
  (experts, capacity, d_model) buffer, batched expert matmuls, gather
  back with the router weights.  Choices over capacity are dropped and
  counted.
* ``ep``     — ``tp``'s dispatch with the buffer resharded so experts live
  on model shards; on one device (no sharding rules) it is ``tp``.
* ``spgemm`` — the serving path (DESIGN.md §11): the routing decision
  becomes a (token-block x expert) dispatch BSM A, and the three expert
  matmuls run A against block-diagonal expert banks through
  ``core.engine.multiply`` — on CUDA the hand-written block-SpGEMM kernel.

``dense``, ``tp`` and ``ep`` are plain PyTorch, as the reference's are
jnp outside any Pallas kernel.

The expert bank.  The reference builds each bank as a zeroed
(E, E, d_in, d_out) grid with W_e on the diagonal: at deepseek-moe-16b's
width 23.6 GB per bank, three per layer.  Here the bank's blocks are a
stride-0 view, ``w.unsqueeze(0).expand(E, E, d_in, d_out)`` (block (k, j)
aliases W_j), with mask ``eye(E)`` and the norms ``make_bsm`` would give;
only (j, j) is in the mask, so a reader that touches listed products only
(the ``cuda`` kernel, which takes the grid's strides, and ``stacks``, which
gathers the listed blocks) computes the same C without the allocation.
Any other backend gets the reference's zeroed bank.

Routing parity: ``lax.top_k`` returns tied values lowest index first, and
``torch.topk`` promises no order among ties, so the top-k is a stable
descending sort.  The router runs in f32 on both sides.

Under a :class:`DispatchSpec` (installed by the serving engine with
:func:`dispatch_scope`) the spgemm multiplies reuse a warmed pattern
envelope: one product-list capacity across a drifting request stream.
The envelope applies only when its ``mask_a`` shape is the call's
(nb_tok, E) grid (the decode grid); other calls (prefill) take the
structural capacity ``bucket_capacity(nb * min(tb * K, E))``, the spec's
capacity included: it is the envelope's.  (The reference keeps the spec's
capacity there, and its compaction then drops the products past it.)
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig, MoEConfig
from repro_torch.obs import span


def moe_dims(cfg: ArchConfig) -> tuple[int, int]:
    """(n_experts, d_expert) resolved against the arch."""
    moe = cfg.moe
    assert moe is not None
    return moe.n_experts, moe.d_expert or cfg.d_ff


def init_moe(cfg: ArchConfig, gen: torch.Generator, dtype) -> dict:
    """Router (f32) + routed expert bank + optional fused shared experts,
    drawn on the generator's device (the reference's names and layouts)."""
    from repro_torch.models.layers import _normal

    moe = cfg.moe
    d = cfg.d_model
    e, de = moe_dims(cfg)
    s_in, s_out = d**-0.5, de**-0.5
    glu = cfg.mlp in ("swiglu", "geglu")
    p = {
        "router": _normal(gen, (d, e), s_in, torch.float32),
        "w_in": _normal(gen, (e, d, de), s_in, dtype),
        "w_out": _normal(gen, (e, de, d), s_out, dtype),
    }
    if glu:
        p["w_gate"] = _normal(gen, (e, d, de), s_in, dtype)
    if moe.n_shared:
        ds = de * moe.n_shared  # fused shared experts (deepseek: 2 shared)
        p["shared_in"] = _normal(gen, (d, ds), s_in, dtype)
        p["shared_out"] = _normal(gen, (ds, d), de**-0.5, dtype)
        if glu:
            p["shared_gate"] = _normal(gen, (d, ds), s_in, dtype)
    return p


def _gate(cfg: ArchConfig, x_gate: torch.Tensor | None,
          h: torch.Tensor) -> torch.Tensor:
    """The MLP's nonlinearity: silu / gelu(tanh) gate times ``h`` for the
    GLU forms, gelu(h) otherwise (``jax.nn.gelu``'s tanh default)."""
    if cfg.mlp == "swiglu":
        return F.silu(x_gate) * h
    if cfg.mlp == "geglu":
        return F.gelu(x_gate, approximate="tanh") * h
    return F.gelu(h, approximate="tanh")


def _expert_ffn(cfg: ArchConfig, p, xb: torch.Tensor) -> torch.Tensor:
    """Batched per-expert FFN: xb (..., E, C, d) -> (..., E, C, d)."""
    from repro_torch.parallel.ctx import tp_bmm

    h = torch.einsum("...ecd,edf->...ecf", xb, p["w_in"])
    g = (torch.einsum("...ecd,edf->...ecf", xb, p["w_gate"])
         if cfg.mlp in ("swiglu", "geglu") else None)
    return tp_bmm(_gate(cfg, g, h), p["w_out"])


def _one_expert_ffn(cfg: ArchConfig, p_e, x: torch.Tensor) -> torch.Tensor:
    """Single expert on all tokens: x (..., d), p_e un-stacked weights."""
    from repro_torch.parallel.ctx import tp_matmul

    h = x @ p_e["w_in"]
    g = x @ p_e["w_gate"] if cfg.mlp in ("swiglu", "geglu") else None
    return tp_matmul(_gate(cfg, g, h), p_e["w_out"])


def _shared_ffn(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    from repro_torch.parallel.ctx import tp_matmul

    h = x @ p["shared_in"]
    g = x @ p["shared_gate"] if cfg.mlp in ("swiglu", "geglu") else None
    return tp_matmul(_gate(cfg, g, h), p["shared_out"])


def router_probs(moe: MoEConfig, logits32: torch.Tensor):
    """Top-k routing: (weights (..., k), expert ids (..., k), probs).
    Ties go to the lowest expert index, as ``lax.top_k`` orders them."""
    probs = torch.softmax(logits32, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = vals[..., : moe.top_k], idx[..., : moe.top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_e, probs


def load_balance_loss(probs: torch.Tensor, top_e: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * P_e (1.0 == balanced)."""
    return balance_loss(balance_stats(probs, top_e, n_experts),
                        probs.numel() // n_experts)


def balance_stats(probs: torch.Tensor, top_e: torch.Tensor,
                  n_experts: int) -> torch.Tensor:
    """(2, E) f32: the router probabilities summed over the tokens and the
    choices of each expert counted — the two sums ``load_balance_loss``
    takes over its batch, here summable over ranks (the sharded runtime
    adds every rank's before it forms the loss: the loss is not linear in
    them)."""
    pe = probs.reshape(-1, n_experts).sum(0)
    flat = top_e.reshape(-1)
    counts = torch.zeros(n_experts, dtype=torch.float32,
                         device=probs.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=probs.device))
    return torch.stack([pe, counts])


def balance_loss(stats: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """``load_balance_loss`` from a batch's ``balance_stats`` (..., 2, E)
    over ``n_tokens`` tokens, summed over the leading dims (layers)."""
    n_experts = stats.shape[-1]
    counts = stats[..., 1, :]
    fe = counts / torch.clamp(counts.sum(-1, keepdim=True), min=1.0)
    return n_experts * torch.sum(fe * (stats[..., 0, :] / n_tokens))


# ---------------------------------------------------------------------------
# serving dispatch scope (models <-> serving glue, DESIGN.md §11)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DispatchSpec:
    """A serving-resolved dispatch decision for the ``spgemm`` impl.

    Installed around prefill and decode with :func:`dispatch_scope`.
    ``envelope`` only applies when its ``mask_a`` shape is the call's
    (nb_tok, E) dispatch grid; other calls take the structural-bound cold
    path.  A covering envelope clips nothing, so spgemm stays equal to the
    dense oracle up to summation order; routed choices outside the
    envelope are dropped and counted.  ``backend`` None is the compacted
    flavour of the operands' device (``cuda`` on a card, ``stacks`` on the
    CPU).
    """

    envelope: object | None = None  # core.envelope.Envelope
    backend: str | None = None
    stack_capacity: int | None = None  # None -> envelope/structural bound


_DISPATCH_SPEC: DispatchSpec | None = None

# routed (token, choice) pairs and the dropped ones, over every apply_moe
# call since the last reset_drop_counts(): the dropped counts stay device
# tensors, kept until asked for (no host sync, no op per call), summed
# now and then into one
_routed = 0
_dropped: list = []
_FOLD = 4096


def reset_drop_counts() -> None:
    global _routed, _dropped
    _routed, _dropped = 0, []


def count_drops(routed: int, dropped) -> None:
    """Add one call's routed choices and dropped ones (a device tensor) to
    the running totals (``apply_moe`` and the sharded runtime); a trace's
    stand-in (a ``meta`` or fake tensor) counts nothing."""
    global _routed, _dropped
    if isinstance(dropped, torch.Tensor) and (
            type(dropped) is not torch.Tensor
            or dropped.device.type == "meta"):
        return
    _routed += routed
    _dropped.append(dropped)
    if len(_dropped) >= _FOLD:
        _dropped = [sum(_dropped)]


def drop_counts() -> dict:
    """{"dropped", "routed"} summed since the last ``reset_drop_counts``
    (one host sync)."""
    return {"dropped": int(sum(_dropped, 0)), "routed": _routed}


@contextlib.contextmanager
def dispatch_scope(spec: DispatchSpec | None):
    """Install ``spec`` as the ambient dispatch decision."""
    global _DISPATCH_SPEC
    prev = _DISPATCH_SPEC
    _DISPATCH_SPEC = spec
    try:
        yield spec
    finally:
        _DISPATCH_SPEC = prev


def current_dispatch_spec() -> DispatchSpec | None:
    return _DISPATCH_SPEC


def dispatch_block_mask(top_e: torch.Tensor, n_experts: int,
                        token_block: int,
                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """(T, K) routed expert ids -> (T // token_block, E) bool dispatch mask.

    Block (i, e) is occupied iff any (valid) token in block i routed one of
    its K choices to expert e: the block-sparse operand structure of the
    SpGEMM view of MoE.
    """
    t, k = top_e.shape
    if t % token_block:
        raise ValueError(
            f"token count {t} not divisible by token_block {token_block}"
        )
    nb = t // token_block
    rows = (torch.arange(t, device=top_e.device) // token_block)[:, None]
    rows = rows.expand(t, k)
    hit = torch.ones((t, k), dtype=torch.bool, device=top_e.device)
    if valid is not None:
        hit = hit & valid.to(torch.bool)[:, None]
    count = torch.zeros((nb, n_experts), dtype=torch.int32,
                        device=top_e.device)
    count.index_put_((rows.reshape(-1), top_e.reshape(-1)),
                     hit.reshape(-1).to(torch.int32), accumulate=True)
    return count > 0


# ---------------------------------------------------------------------------
# dispatch paths
# ---------------------------------------------------------------------------


def _apply_dense(cfg: ArchConfig, p, x: torch.Tensor, top_w, top_e):
    """Loop over experts; every expert sees every token (exact, no drops)."""
    e, _ = moe_dims(cfg)
    acc = torch.zeros_like(x)
    for eid in range(e):
        pe = {k_: v[eid] for k_, v in p.items() if k_.startswith("w_")}
        y = _one_expert_ffn(cfg, pe, x)  # (..., d)
        w = torch.where(top_e == eid, top_w, 0.0).sum(-1)  # (...,)
        acc = acc + y * w[..., None].to(y.dtype)
    return acc


def _dispatch_indices(top_e: torch.Tensor, n_experts: int, capacity: int):
    """(..., T, K) expert ids -> (slot positions, keep mask), both
    (..., T, K): slot p of a choice of expert e is the number of earlier
    choices of e in (t-major, k-minor) order, kept below ``capacity``
    (Switch dispatch without the (T, E, C) one-hot)."""
    lead, (t, k) = top_e.shape[:-2], top_e.shape[-2:]
    flat = top_e.reshape(lead + (t * k,))
    # one_hot by a scatter: ``F.one_hot`` checks the ids' range on the
    # host (a device sync per call on a card)
    onehot = torch.zeros(lead + (t * k, n_experts), dtype=torch.int32,
                         device=top_e.device).scatter_(-1, flat[..., None], 1)
    pos = torch.cumsum(onehot, dim=-2) - 1
    slot = torch.gather(pos, -1, flat[..., None])[..., 0]
    keep = slot < capacity
    return slot.reshape(top_e.shape), keep.reshape(top_e.shape)


def moe_capacity(cfg: ArchConfig, seq: int) -> int:
    """Expert slots per batch row for ``seq`` tokens: S K f / E, at least
    one (the reference's ``_apply_capacity``)."""
    moe = cfg.moe
    e, _ = moe_dims(cfg)
    return max(int(seq * moe.top_k * moe.capacity_factor / e), 1)


def capacity_dispatch(cfg: ArchConfig, x: torch.Tensor, top_e):
    """The capacity dispatch of x (B, S, d): (the (B, E, C, d) buffer,
    slots (B, S, K), keep mask (B, S, K)).  Every choice is scattered at
    its clipped slot; a dropped one adds zeros there (``keep`` masks it
    out of the combine), a kept one lands alone in its slot."""
    e, _ = moe_dims(cfg)
    b, s, d = x.shape
    k = cfg.moe.top_k
    capacity = moe_capacity(cfg, s)
    slot, keep = _dispatch_indices(top_e, e, capacity)  # (B, S, K)
    bi = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    es = top_e.reshape(b, s * k)
    ss = torch.clamp(slot, max=capacity - 1).reshape(b, s * k)
    xe = x.repeat_interleave(k, dim=1)  # (B, S*K, d) token copy per choice
    xe = xe * keep.reshape(b, s * k, 1).to(x.dtype)
    buf = torch.zeros((b, e, capacity, d), dtype=x.dtype, device=x.device)
    buf.index_put_((bi, es, ss), xe, accumulate=True)
    return buf, slot, keep


def capacity_combine(yb: torch.Tensor, top_w, top_e, slot, keep):
    """Each token's K expert outputs gathered from yb (B, E, C, d) and
    summed with its kept router weights: (y (B, S, d), dropped)."""
    b = yb.shape[0]
    sr = torch.clamp(slot, max=yb.shape[2] - 1)
    bidx = torch.arange(b, device=yb.device)[:, None, None]
    y = yb[bidx, top_e, sr]  # (B, S, K, d)
    w = (top_w * keep.to(top_w.dtype)).to(y.dtype)
    dropped = (~keep).sum().to(torch.int32)
    return (y * w[..., None]).sum(-2), dropped


def _apply_capacity(cfg: ArchConfig, p, x: torch.Tensor, top_w, top_e, *,
                    ep: bool):
    """Capacity scatter dispatch. x (B, S, d); B is the data-sharded dim."""
    buf, slot, keep = capacity_dispatch(cfg, x, top_e)
    if ep:
        from repro_torch.parallel.ctx import shard_act

        buf = shard_act(buf, "moe_dispatch")
    yb = _expert_ffn(cfg, p, buf)  # (B, E, C, d)
    if ep:
        from repro_torch.parallel.ctx import shard_act

        yb = shard_act(yb, "moe_combine")
    return capacity_combine(yb, top_w, top_e, slot, keep)


# bank norms per weight tensor: id -> (weak ref, version, norms).  Only the
# norms are kept (E floats), never a reference to the weights.
_BANK_NORMS: dict[int, tuple] = {}


def _expert_norms(w: torch.Tensor) -> torch.Tensor:
    """The f32 Frobenius norm of every expert of a (E, d_in, d_out) bank,
    computed once per weight tensor (and again after an in-place
    change)."""
    from repro_torch.core.bsm import block_norms

    hit = _BANK_NORMS.get(id(w))
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    for key in [k for k, v in _BANK_NORMS.items() if v[0]() is None]:
        del _BANK_NORMS[key]
    norms = torch.cat([block_norms(w[i:i + 1]) for i in range(w.shape[0])])
    _BANK_NORMS[id(w)] = (weakref.ref(w), w._version, norms)
    return norms


def diag_expert_bsm(w: torch.Tensor, *, aliased: bool = True):
    """(E, d_in, d_out) expert bank -> (E, E) block-diagonal BSM.

    ``aliased`` (the default): blocks ``w.unsqueeze(0).expand(E, E, d_in,
    d_out)``, every column j aliasing W_j with no copy, mask ``eye(E)``,
    norms W_j's on the diagonal and 0 elsewhere — what ``make_bsm`` of the
    zeroed bank gives.  For readers of listed products only (``cuda``,
    ``stacks``).  ``aliased=False``: the reference's zeroed bank,
    materialised (any backend).  Diagonal B gives one product per occupied
    dispatch block.
    """
    from repro_torch.core import bsm as B

    e = w.shape[0]
    eye = torch.eye(e, dtype=torch.bool, device=w.device)
    if not aliased:
        blocks = torch.zeros((e, e) + tuple(w.shape[1:]), dtype=w.dtype,
                             device=w.device)
        idx = torch.arange(e, device=w.device)
        blocks[idx, idx] = w
        return B.make_bsm(blocks, eye)
    norms = torch.diag_embed(_expert_norms(w))
    return B.BlockSparseMatrix(blocks=w.unsqueeze(0).expand((e,) + w.shape),
                               mask=eye, norms=norms)


def _dispatch_bsm(xt: torch.Tensor, mask: torch.Tensor, tpb: int):
    """The (nb, E) dispatch BSM: token block i replicated across its routed
    expert columns, zero elsewhere; norms from the token blocks (the
    replicas share them), as ``make_bsm`` of the broadcast blocks gives."""
    from repro_torch.core import bsm as B

    tt, d = xt.shape
    nb, e = mask.shape
    tok = xt.reshape(nb, 1, tpb, d)
    blocks = tok.expand(nb, e, tpb, d) * mask[:, :, None, None].to(xt.dtype)
    norms = torch.where(mask, B.block_norms(tok), 0.0)
    return B.BlockSparseMatrix(blocks=blocks, mask=mask, norms=norms)


_CLIPS: dict = {}  # (envelope signature, device) -> its mask_a there


def _envelope_clip(env, dev: torch.device) -> torch.Tensor:
    """``env.mask_a`` on ``dev``, copied there once per envelope (a serving
    stream reuses one envelope for every decode step)."""
    key = (env.signature, str(dev))
    clip = _CLIPS.get(key)
    if clip is None:
        if len(_CLIPS) >= 64:
            _CLIPS.clear()
        clip = _CLIPS[key] = torch.from_numpy(
            np.array(env.mask_a, bool)).to(dev)
    return clip


def _expert_products(mask: torch.Tensor, cap: int, backend: str):
    """``mult(a_blocks, w)``: A's (nb, E, tb, d_in) blocks times the
    block-diagonal bank of ``w`` (E, d_in, d_out), block (i, e) by W_e
    where ``mask`` is set — ``engine.multiply(A, diag_expert_bsm(w),
    backend=backend, stack_capacity=cap).blocks`` bit for bit.  A layer's
    three expert products share A's pattern, so the pair cube, the
    product list and the kernel's group list (about 50 launches a
    multiply) are made once for all three, with no host sync."""
    from repro_torch.kernels import block_spgemm as K
    from repro_torch.kernels.stacks import compact_pair_mask, resolve_capacity

    nb, e = mask.shape
    eye = torch.eye(e, dtype=torch.bool, device=mask.device)
    ok = mask[:, :, None] & eye[None]
    stacks = compact_pair_mask(ok, capacity=resolve_capacity(cap, ok.numel()))
    kernel = backend == "cuda" and mask.device.type == "cuda"
    groups: dict = {}  # one group list per kernel layout

    def mult(a_blocks: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        b_blocks = w.unsqueeze(0).expand((e,) + tuple(w.shape))
        if not kernel or stacks.capacity == 0:
            return K.block_spgemm_stacks_plain(a_blocks, b_blocks, stacks,
                                               ni=nb, nj=e)
        tile = K.kernel_tile(a_blocks.shape[2], w.shape[2])
        gm = groups.get(tile)
        if gm is None:
            with span("repro.moe.dispatch"):
                gm = groups[tile] = K.group_masks(
                    stacks, ni=nb, nk=e, nj=e, g_r=tile.g_r, g_c=tile.g_c)
        return K.block_spgemm_groups(a_blocks, b_blocks, gm, ni=nb, nj=e)

    return mult


def _apply_spgemm(cfg: ArchConfig, p, x: torch.Tensor, top_w, top_e):
    """Expert dispatch as block-sparse SpGEMM.

    Tokens are grouped into blocks of ``moe.token_block``; the routing
    decision becomes an (nb_tok, E) dispatch BSM A whose occupied blocks
    replicate the token block across its routed expert columns, and the
    three expert matmuls (in / gate / out) run A against block-diagonal
    weight banks: ``engine.multiply``'s products, through it for the
    ``dense`` backend and on one shared product list for the compacted
    ones (``_expert_products``).  The combine gathers each token's K
    expert outputs back with the router weights, so the result equals the
    dense oracle up to summation order (no drops) whenever the ambient
    envelope covers the pattern.
    """
    from repro_torch.core import bsm as B
    from repro_torch.core import engine as core_engine
    from repro_torch.kernels.stacks import bucket_capacity

    moe = cfg.moe
    e, _ = moe_dims(cfg)
    b, s, d = x.shape
    k = moe.top_k
    tpb = moe.token_block
    t = b * s
    dev = x.device
    with span("repro.moe.dispatch"):
        xt = x.reshape(t, d)
        te = top_e.reshape(t, k)
        tw = top_w.reshape(t, k)
        pad = (-t) % tpb
        if pad:
            xt = F.pad(xt, (0, 0, 0, pad))
            te = F.pad(te, (0, 0, 0, pad))
            tw = F.pad(tw, (0, 0, 0, pad))
        tt = t + pad
        nb = tt // tpb
        valid = torch.arange(tt, device=dev) < t
        mask = dispatch_block_mask(te, e, tpb, valid=valid)  # (nb, E)

        spec = current_dispatch_spec()
        env = spec.envelope if spec is not None else None
        cap = spec.stack_capacity if spec is not None else None
        if env is not None and tuple(np.asarray(env.mask_a).shape) != (nb, e):
            # prefill vs decode grid mismatch: the structural bound, since
            # the spec's capacity is its envelope's and would drop products
            # here
            env, cap = None, None
        blk = torch.arange(tt, device=dev) // tpb
        keep = torch.ones((tt, k), dtype=torch.bool, device=dev)
        if env is not None:
            # clip the dispatch to the envelope so its capacity is sound;
            # clipped routed choices are the serving drop stat
            clip = _envelope_clip(env, dev)
            mask = mask & clip
            keep = clip[blk[:, None], te]
            if cap is None:
                cap = env.local_capacity()
        dropped = (valid[:, None] & ~keep).sum().to(torch.int32)

        backend = spec.backend if spec is not None and spec.backend else (
            "cuda" if dev.type == "cuda" else "stacks")
        if cap is None:
            # structural bound: every block row occupies at most
            # min(tb*K, E) expert columns, and diagonal B gives one product
            # per block
            cap = bucket_capacity(nb * min(tpb * k, e))
        gated = cfg.mlp in ("swiglu", "geglu")
        compacted = backend in ("cuda", "stacks")
        if compacted:
            # the compacted backends read the listed blocks only: A as the
            # token blocks broadcast over the expert columns (a stride-0
            # view)
            mult = _expert_products(mask, cap, backend)
            a = xt.reshape(nb, 1, tpb, d).expand(nb, e, tpb, d)
        else:
            # The envelope covers both operands by construction (A is
            # clipped to it above, and the bank's mask is its eye), so its
            # capacity goes in directly: ``multiply(envelope=env)`` would
            # check that cover on the host, two device-to-host copies a
            # multiply.
            def mult(a_bsm, w_bank):
                return core_engine.multiply(
                    a_bsm, diag_expert_bsm(w_bank, aliased=False),
                    backend=backend, stack_capacity=cap).blocks

            a = _dispatch_bsm(xt, mask, tpb)

    with span("repro.moe.experts"):
        h = mult(a, p["w_in"])  # (nb, E) blocks of (tb, de)
        hb = _gate(cfg, mult(a, p["w_gate"]) if gated else None, h)
        del a, h
        if compacted:
            # act(0) = 0 for gelu / silu, so unlisted blocks stay zero
            out = mult(hb, p["w_out"])  # (nb, E) x (tb, d)
        else:
            # make_bsm re-zeroes and refreshes the norms, as the reference
            # does
            out = mult(B.make_bsm(hb, mask), p["w_out"])
        del hb
    with span("repro.moe.combine"):
        y = out[blk[:, None], te, (torch.arange(tt, device=dev)
                                   % tpb)[:, None]]  # (tt, K, d)
        w = (tw * keep.to(tw.dtype)).to(y.dtype)
        y = (y * w[..., None]).sum(1)[:t]
    return y.reshape(b, s, d), dropped


def apply_moe(cfg: ArchConfig, p, x: torch.Tensor, *,
              collect_stats: bool = False):
    """x (B, S, d) -> (y (B, S, d), aux load-balance loss).

    With ``collect_stats=True`` returns ``(y, aux, stats)`` where stats
    carries ``dropped`` (routed (token, choice) pairs lost to capacity /
    envelope clipping; always 0 for the dense oracle) and ``routed`` (all
    routed pairs), both int32 tensors on x's device.
    """
    moe = cfg.moe
    e, _ = moe_dims(cfg)
    with span("repro.moe.route"):
        logits = x.float() @ p["router"]
        top_w, top_e, probs = router_probs(moe, logits)
        aux = load_balance_loss(probs, top_e, e)
        top_w = top_w.to(x.dtype)

    dropped = torch.zeros((), dtype=torch.int32, device=x.device)
    if moe.impl == "dense":
        y = _apply_dense(cfg, p, x, top_w, top_e)
    elif moe.impl in ("tp", "ep"):
        y, dropped = _apply_capacity(cfg, p, x, top_w, top_e,
                                     ep=(moe.impl == "ep"))
    elif moe.impl == "spgemm":
        y, dropped = _apply_spgemm(cfg, p, x, top_w, top_e)
    else:
        raise ValueError(f"unknown moe impl {moe.impl!r}")

    if moe.n_shared:
        with span("repro.moe.shared"):
            y = y + _shared_ffn(cfg, p, x)
    count_drops(top_e.numel(), dropped)
    if collect_stats:
        stats = {"dropped": dropped,
                 "routed": torch.tensor(top_e.numel(), dtype=torch.int32,
                                        device=x.device)}
        return y, aux, stats
    return y, aux
