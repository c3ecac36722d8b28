"""The sharded decoder runtime: the training loss, prefill and decode of
every family (dense, MoE, hybrid, ssm, audio, vlm) on a mesh of ranks (a
port-only module: the reference writes its model once and lets GSPMD
partition it from ``param_specs``, ``activation_rules`` and
``cache_specs``).

One process holds every rank (``launch/mesh.py``).  A parameter is a list
of per-rank shards placed by ``parallel/sharding.param_specs``; an
activation is a list of per-rank tensors.  Each rank's part of a layer is
the ported layer run on its shards with a local configuration
(``n_heads / m``, ``n_kv_heads / m`` heads on its column shards of ``wq``
/ ``wk`` / ``wv`` and row shard of ``wo``, its column shards of ``w_in``
/ ``w_gate`` and row shard of ``w_out``), so ``attention.qkv_proj``,
``chunked_attention`` (the flash kernels on the card), ``out_proj`` and
``layers.apply_mlp`` serve both paths.  The collectives are explicit
(``parallel/collectives.py``) and follow the activation table the rules
name at the reference's cut points:

* ``btd`` after a row-parallel product: a psum over ``model`` (Megatron),
  or under ``seq_parallel`` (``btd`` split over ``model`` on the
  sequence) a psum-scatter, the residual stream and its norms then
  running on S / m positions;
* ``btd_full`` before a column-parallel product: the identity with a psum
  backward, or under ``seq_parallel`` an all-gather of the sequence;
* ``bhsd`` / ``bksd``: heads over ``model`` when both head counts divide
  it; otherwise attention runs whole on every model rank, its weights
  gathered over ``model`` first (qwen1.5-4b's 20 heads on 16);
* ``logits``: vocab over ``model`` — a vocab-parallel embedding (local
  rows, others masked, then the ``btd`` reduction) and a vocab-parallel
  chunked cross-entropy (local logits; the max, the sum of exponentials
  and the target's logit combined over ``model``);
* ``ce_in`` (``head_2p5d`` on a ``pod`` axis): each CE chunk's rows are
  gathered over ``pod`` and its d split over ``pod`` (an all-to-all), and
  the LM-head contraction is ``matmul_2p5d``'s partial products reduced
  by one psum-scatter over ``pod`` back to each rank's own rows.

MoE layers (``models/moe.py``): the router is replicated over ``model``
and runs on every model rank's rows (under ``seq_parallel`` on its own
positions, its weight's gradient then summed over ``model`` like a norm's,
and the choices all-gathered over the sequence).  ``tp`` / ``dense``:
the expert banks gathered over their FSDP axis, each rank keeps its
``model`` chunk of ``d_expert`` (``w_in`` / ``w_gate`` column-, ``w_out``
row-parallel), so the expert outputs and the combine are partial and take
the ``btd`` reduction; the tokens and the combine weights enter through
``btd_full``'s copy (their gradients, partial, summed over ``model``
once), the router's input does not (its gradient is whole on every
rank).  Capacity is per batch row, so sharding the batch drops what one
device drops.  ``ep``: the dispatch buffer, replicated over ``model``, is
split over its experts (``moe_dispatch``), each rank runs its experts
whole, and the outputs are all-gathered back (``moe_combine``), so the
routed part is whole on every rank.  The shared experts are a dense MLP
under the same rules.  The load-balance loss is not linear in its
sums, so every layer's router-probability and expert-count sums
(``moe.balance_stats``) are psummed over the batch axes (and ``model``
under ``seq_parallel``) and the loss is formed from the global sums.
``spgemm`` stays on one device (ROADMAP.md item 15c.2).

Mamba layers (``models/mamba.py``): ``in_proj`` column-parallel, the
per-channel weights (``conv_*``, ``dt_*``, ``a_log``, ``d_skip``) and the
scan on each rank's channels, ``x_proj`` row-parallel (its dt / B / C
projection psummed over ``model`` before the split, and its gradient
summed back: each rank consumes it for its own channels), ``out_proj``
row-parallel with the ``btd`` reduction.  ``in_proj``'s column shard is
not the rank's slices of x and z: its (d, 2 d_inner) columns split
contiguously, so on ``model`` 2 rank 0 holds all of x and rank 1 all of
z; a deal over ``model`` (``collectives.deal``, an all-to-all at ``model``
2) brings each rank its x chunk and the matching z chunk.  The serving
states (the ssm state and the conv tail) split their channels over
``model``.

rwkv6 layers (``models/rwkv6.py``, the ssm family): the time mix's
``wr`` / ``wk`` / ``wv`` / ``wg`` and ``decay_w2`` column-parallel, so a
rank holds d / m channels, whole heads (4 of 64 at ``model`` 16), and runs
the recurrence and the per-head group norm on them; ``wo`` row-parallel
with the ``btd`` reduction.  ``decay_w1`` is whole on every model rank
and each uses it for its own columns of ``decay_w2``, so its gradient is
summed over ``model`` (a copy); so are the interpolation factors'
(``mu_*``, which act on the whole input).  ``decay_base``, ``bonus_u``
and ``ln_x_w`` match no rule: replicated, each rank takes its channels'
slice (a split, whose backward all-gathers the slices' gradients).  The
channel mix's ``ck`` is column- and ``cv`` row-parallel, so ``kk @ cv``
is a partial sum of full width, while ``cr`` is column-parallel, so the
gate ``sigmoid(xr @ cr)`` is split on d: the gate is all-gathered over
``model`` (its gradient psum-scattered back: each rank's is partial) and
multiplies each rank's partial value, and the product takes the ``btd``
reduction (under ``seq_parallel`` a psum-scatter, as every row-parallel
output).  The token shift reads the previous position of the
full-sequence ``btd_full`` input.  The serving state: ``wkv`` splits its
heads over ``model``, the shift tails stay whole on every model rank.
Where the heads do not divide ``model`` the layer runs whole on every
model rank, its weights gathered.

whisper (audio): the encoder's blocks run under the dense rules,
non-causal, on the frames (sharded with the batch; the sinusoidal
positions added to whole rows); its output, whole on every model rank,
enters through ``btd_full``'s cut once (a copy, or under ``seq_parallel``
an all-gather), so its gradient, partial per model rank where the heads
split, is summed over ``model`` once for every layer's cross K/V
projections.  Under ``seq_parallel`` the frame count must divide
``model`` (1,500 on 16 does not: ``ValueError``).  Each decoder layer's
cross-attention (``xattn``) runs as self-attention does, non-causal
against the encoder output.  The decoder's sinusoidal positions, and
pixtral's (vlm) patch embeddings in place of the prefix rows, are added
after the vocab-parallel embedding's ``btd`` reduction, each rank's rows
at their own positions under ``seq_parallel``.  Serving keeps two cache
layouts in one whisper model: the self K/V by ``kv_layout(max_len)``, the
cross K/V (written once at prefill from the encoder output) by
``kv_layout(n_frames)``.

FSDP: each layer's weight shards are all-gathered over their FSDP axes
inside the (remat'd) layer function, so no gathered weight outlives its
layer under ``remat`` full / dots; the gathers' backward psum-scatters
the gradients back to the shards.  The token table is gathered once per
step and serves the embedding and, tied, the head.

Every rank's loss is its rows' cross-entropy sum over the global token
count; under Megatron's convention each is seeded with one, and the sum
over the batch axes is the loss; the MoE load-balance term, formed from
global sums, is whole on every rank and counted once.

Serving (``prefill`` / ``decode``, no gradient) runs the same layers,
gathers and TP collectives on a cache laid out by
``sharding.cache_specs`` (``kv_layout``): with heads over ``model`` each
rank writes and reads its local heads' K/V; where the heads do not divide
``model`` attention runs whole on every model rank and the cache splits
its sequence over ``model`` (the reference's flash-decoding layout): a
prefill rank writes its chunk of the positions, and a decode step's
attention is each rank's partial over its chunk (max, sum of exponentials,
P.V), combined by a pmax and a psum over ``model``; where the sequence
does not divide either, each model rank keeps the whole cache.  The last
position's logits are vocab-parallel and all-gathered over ``model``, so
each rank ends with its rows' logits over the whole vocabulary (the
reference's output, rows over the batch axes).  A decode step takes one
position for every row (an int).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.core.transport import deal_foreign
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MoE
from repro_torch.models import rwkv6 as R
from repro_torch.models import transformer as T
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ctx import sharding_rules, tp_matmul, wider
from repro_torch.parallel.matmul_2p5d import matmul_2p5d
from repro_torch.parallel.sharding import batch_axes, entry_axes

MESH_AXES = (("data", "model"), ("pod", "data", "model"))
# whisper's encoder blocks: attention without a mask, then a dense MLP
ENCODER_KIND = dict(T.ENCODER_KIND, causal=False)
# rwkv6's leaves that act whole on every model rank (their gradients
# summed over ``model``) and those each rank takes its channels' slice of
RWKV_SUMMED = ("mu_rkvg", "mu_w", "decay_w1", "mu_c")
RWKV_SLICED = ("decay_base", "bonus_u", "ln_x_w")


def check_supported(cfg, mesh) -> None:
    """Raise for MoE's spgemm impl or a mesh the sharded runtime does not
    run."""
    if cfg.moe is not None and cfg.moe.impl == "spgemm":
        raise NotImplementedError(
            f"{cfg.name}: MoE impl 'spgemm' on a mesh is ROADMAP.md Queue A "
            f"item 15c.2 (it runs on one device); the sharded runtime runs "
            f"tp, ep and dense")
    if tuple(mesh.axis_names) not in MESH_AXES:
        raise ValueError(f"mesh axes {mesh.axis_names}: one of {MESH_AXES}")


class DecoderRuntime:
    """The loss of one batch on a mesh of ranks, under the table of
    ``rules`` (``sharding.activation_rules``) and the spec tree
    ``p_spec`` (``sharding.param_specs``)."""

    def __init__(self, cfg, mesh, p_spec, rules, *, remat: str = "none",
                 loss_chunk: int = 512, max_len: int | None = None):
        """``max_len``: the serving cache's length (``prefill`` /
        ``decode`` need it; the loss does not)."""
        check_supported(cfg, mesh)
        self.cfg, self.mesh, self.p_spec, self.rules = cfg, mesh, p_spec, rules
        self.remat, self.loss_chunk = remat, loss_chunk
        t = rules.table
        self.m = mesh.shape["model"]
        names = mesh.axis_names
        self.mi = [mesh.coords(r)[names.index("model")]
                   for r in range(mesh.size)]
        self.pi = ([mesh.coords(r)[names.index("pod")]
                    for r in range(mesh.size)] if "pod" in names else None)
        self.attn_tp = t["bhsd"][1] == "model" and t["bksd"][1] == "model"
        self.seq_split = t["btd"][1] == "model"
        self.ce_2p5d = "ce_in" in t
        emb = p_spec["embed"]
        self.head_spec = emb.get("out", emb["tok"])
        self.embed_tp = emb["tok"][0] == "model"
        self.head_tp = self.head_spec[0] == "model"
        # the spec entries a weight keeps when gathered to its compute
        # layout: heads that do not divide ``model`` gather it too
        self.attn_keep = ("model",) if self.attn_tp else ()
        self.mlp_keep = self.tok_keep = ("model",)
        self.head_keep = ("model", "pod")
        self.cfg_attn = dataclasses.replace(
            cfg, head_dim=cfg.hd,
            n_heads=cfg.n_heads // (self.m if self.attn_tp else 1),
            n_kv_heads=cfg.n_kv_heads // (self.m if self.attn_tp else 1))
        self.kinds = T.layer_kinds(cfg)
        self.dtype = T.model_dtype(cfg)
        self.n_moe = sum(bool(k["moe"]) for k in self.kinds)
        # the MoE load-balance sums run over the rows and, under
        # seq_parallel, the positions
        ba = batch_axes(mesh)
        self.aux_axes = ((ba if isinstance(ba, tuple) else (ba,))
                         + (("model",) if self.seq_split else ()))
        self._layer_fn = T._remat_layer(self._layer, remat)
        self.layout = None if max_len is None else self.kv_layout(max_len)
        enc = cfg.encoder
        # the cross K/V cache's layout (whisper: the frames')
        self.x_layout = (None if enc is None or max_len is None
                         else self.kv_layout(enc.n_frames))
        if enc is not None and self.seq_split and enc.n_frames % self.m:
            raise ValueError(f"seq_parallel: {enc.n_frames} frames over "
                             f"model {self.m}")

    # ---- layout transitions (the activation table's cut points) --------
    # Each method below names the collective of one cut point; the forward
    # runs it (``_run``) and ``loss_bytes`` counts it (``ACT_BYTES``).

    def btd_op(self, tp: bool) -> str | None:
        """``btd`` after a product: where its parts sum over ``model``
        (``tp``) a psum (Megatron), or under ``seq_parallel`` a
        psum-scatter of the sequence; where every model rank computed it
        whole, nothing, or under ``seq_parallel`` each rank's chunk."""
        if tp:
            return "psum_scatter" if self.seq_split else "psum"
        return "split" if self.seq_split else None

    def full_op(self, tp: bool) -> str | None:
        """``btd_full`` before a product: the identity with a psum
        backward where the ranks consume parts (``tp``), or under
        ``seq_parallel`` an all-gather of the sequence whose gradient is
        summed (``tp``) or sliced."""
        if self.seq_split:
            return "gather_sum" if tp else "gather_slice"
        return "copy" if tp else None

    def norm_op(self) -> str | None:
        """A norm's weights: under ``seq_parallel`` each rank sees S / m
        positions, so their gradients sum over ``model``."""
        return "copy" if self.seq_split else None

    @staticmethod
    def gather_plan(spec, keep) -> list:
        """(dim, entry, grad) of each all-gather that brings a weight's
        shards to the compute layout: every spec entry not in ``keep``
        (FSDP axes: the gradient psum-scattered back; ``model``:
        replicated consumers, each rank's own chunk)."""
        return [(dim, entry, "slice" if "model" in entry_axes(entry)
                 else "sum") for dim, entry in enumerate(spec)
                if entry is not None and entry not in keep]

    @staticmethod
    def moe_plan(spec) -> dict:
        """How an MoE layer with weight specs ``spec`` runs: ``routed``
        (the routed experts' output is partial over ``model``: tp / dense
        with d_expert split), ``split`` (ep with the experts split over
        ``model``), ``shared`` (the shared experts' output is partial)."""
        w_in = spec["w_in"]
        split = w_in[0] == "model"
        return {"routed": not split and w_in[-1] == "model", "split": split,
                "shared": "shared_in" in spec
                and spec["shared_in"][-1] == "model"}

    def rwkv_tp(self, spec) -> bool:
        """Whether an rwkv6 layer runs on its channels over ``model`` (the
        column- and row-parallel weights split there and the heads divide
        it); otherwise whole on every model rank."""
        cols = [spec[k][-1] for k in ("wr", "wk", "wv", "wg", "decay_w2",
                                      "ck", "cr")]
        rows = [spec[k][0] for k in ("wo", "cv")]
        h = R.rwkv_dims(self.cfg)[0]
        return all(e == "model" for e in cols + rows) and h % self.m == 0

    @staticmethod
    def mamba_tp(spec) -> bool:
        """Whether a mamba layer runs on its channels over ``model`` (its
        weights then stay as the specs split them); otherwise whole on
        every model rank."""
        tp = spec["in_proj"][1] == "model"
        if tp != (spec["conv_b"][0] == "model"):
            raise ValueError("mamba: in_proj and the per-channel weights "
                             "must split over model alike")
        return tp

    def _run(self, op, xs, axes="model", dim=1) -> list:
        if op is None:
            return list(xs)
        if op == "psum":
            return C.psum(self.mesh, xs, axes)
        if op == "copy":
            return C.copy(self.mesh, xs, axes)
        if op == "psum_scatter":
            return C.psum_scatter(self.mesh, xs, axes, dim=dim)
        if op == "split":
            return C.split(self.mesh, xs, axes, dim=dim)
        return C.all_gather(self.mesh, xs, axes, dim=dim,
                            grad=op.removeprefix("gather_"))

    def _gather(self, xs, spec, keep) -> list:
        for dim, entry, grad in self.gather_plan(spec, keep):
            xs = C.all_gather(self.mesh, xs, entry, dim=dim, grad=grad)
        return list(xs)

    def _norm(self, p: dict, xs) -> list:
        p = {k: self._run(self.norm_op(), v) for k, v in p.items()}
        return [L.apply_norm(self.cfg, {k: v[r] for k, v in p.items()}, x)
                for r, x in enumerate(xs)]

    # ---- the model ------------------------------------------------------

    def _embed(self, tok, tokens) -> list:
        out = []
        for r, (w, t) in enumerate(zip(tok, tokens)):
            if self.embed_tp:  # local vocab rows; the others give zeros
                loc = t - self.mi[r] * w.shape[0]
                inside = (loc >= 0) & (loc < w.shape[0])
                e = F.embedding(torch.where(inside, loc, 0), w)
                out.append(e * inside[..., None].to(w.dtype))
            else:
                out.append(F.embedding(t, w))
        return self._run(self.btd_op(self.embed_tp), out)

    def _inputs(self, tok, tokens, patches=None) -> list:
        """The decoder's input rows: the embedding (``_embed``), then
        pixtral's patch embeddings in place of the prefix rows and the
        sinusoidal positions where the model has no rope, each rank's rows
        at their own positions (its chunk of the sequence under
        ``seq_parallel``)."""
        cfg = self.cfg
        x = self._embed(tok, tokens)
        s = tokens[0].shape[1]
        if cfg.frontend == "vision" and patches is not None:
            if patches[0].shape[1] > s:
                raise ValueError(f"{patches[0].shape[1]} patch embeddings "
                                 f"for a {s}-token prompt: the prompt must "
                                 "hold the prefix")
        else:
            patches = None
        out = []
        for r, xr in enumerate(x):
            lo = self.mi[r] * xr.shape[1] if self.seq_split else 0
            if patches is not None:
                hi = min(patches[r].shape[1], lo + xr.shape[1])
                if hi > lo:
                    xr = torch.cat([patches[r][:, lo:hi].to(xr.dtype),
                                    xr[:, hi - lo:]], dim=1)
            if not cfg.rope:
                pe = L.sinusoidal_positions(s, cfg.d_model, device=xr.device)
                xr = xr + pe[lo:lo + xr.shape[1]].to(xr.dtype)
            out.append(xr)
        return out

    def _encode(self, params, frames, layer) -> list:
        """whisper's encoder on every rank's rows of frames (B, F, d):
        sinusoidal positions, the blocks (``layer``: ``_layer``, or under
        training its remat'd form), the final norm; its output whole on
        every model rank through ``btd_full``'s cut, once for every
        decoder layer's cross K/V."""
        cfg, enc, spec = self.cfg, params["encoder"], self.p_spec["encoder"]
        f = frames[0].shape[1]
        x = []
        for fr in frames:
            pe = L.sinusoidal_positions(f, cfg.d_model, device=fr.device)
            x.append(fr + pe.to(fr.dtype))
        x = self._run(self.btd_op(False), x)
        none = [None] * len(x)
        for p, sp in zip(enc["blocks"], spec["blocks"]):
            x, _ = layer(cfg, ENCODER_KIND, p, x, sp, none)
        x = self._norm(enc["final_norm"], x)
        return self._run(self.full_op(self.attn_tp), x)

    def _layer(self, cfg, kind, p, x, spec, positions, enc=None):
        """One layer over every rank (``cfg`` is unused: the signature is
        ``transformer._remat_layer``'s): (x, the MoE layer's per-rank
        ``balance_stats`` or None)."""
        with sharding_rules(self.rules):  # the recompute runs outside
            return self._layer_body(kind, p, x, spec, positions, enc=enc)

    def _layer_body(self, kind, p, x, spec, positions, cache=None,
                    enc=None):
        """One layer: its mixer's residual (rwkv6: both of its residuals),
        with the encoder output ``enc`` whisper's cross-attention, then
        its MLP's or MoE's; with ``cache`` (serving) each rank writes the
        prompt's K/V (and the cross K/V) or its channels' recurrent states
        into its part of it."""
        if kind["mixer"] == "rwkv6":
            return self._rwkv_res(p, spec, x, cache), None
        if kind["mixer"] == "mamba":
            x = self._mamba_res(p, spec, x, cache)
        else:
            x = self._attn_layer(kind, p, spec, x, positions, cache)
            if enc is not None:
                x = self._cross_res(p, spec, x, enc, cache)
        return self._ffn_res(kind, p, spec, x)

    def _attn_layer(self, kind, p, spec, x, positions, cache=None):
        cfg = self.cfg
        pa = {k: self._gather(v, spec["attn"][k], self.attn_keep)
              for k, v in p["attn"].items()}
        xa = self._run(self.full_op(self.attn_tp), self._norm(p["ln1"], x))
        ys = []
        for r, xr in enumerate(xa):
            w = {k: v[r] for k, v in pa.items()}
            q, k, v = A.qkv_proj(self.cfg_attn, w, xr, positions[r])
            if cache is not None:
                self._write_prompt(cache, r, k, v)
            o = A.chunked_attention(q, k, v, causal=kind.get("causal", True),
                                    window=kind.get("window"),
                                    softcap=cfg.attn_softcap)
            ys.append(A.out_proj(self.cfg_attn, w, o))
        return self._attn_res(p, x, ys)

    def _cross_res(self, p, spec, x, enc, cache=None) -> list:
        """whisper's cross-attention residual (the ``xattn/*`` rules, as
        self-attention's; no post-norm): non-causal against the encoder
        output ``enc``; with ``cache`` each rank writes its part of the
        cross K/V."""
        pa = {k: self._gather(v, spec["xattn"][k], self.attn_keep)
              for k, v in p["xattn"].items()}
        xq = self._run(self.full_op(self.attn_tp), self._norm(p["ln_x"], x))
        ys = []
        for r, xr in enumerate(xq):
            w = {k: v[r] for k, v in pa.items()}
            q = A.cross_q(self.cfg_attn, w, xr)
            k, v = A.cross_kv(self.cfg_attn, w, enc[r])
            if cache is not None:
                self._write_prompt(cache, r, k, v, ("xk", "xv"),
                                   self.x_layout)
            o = A.chunked_attention(q, k, v, causal=False)
            ys.append(A.out_proj(self.cfg_attn, w, o))
        y = self._reduced(self.btd_op(self.attn_tp), ys)
        return [a + b for a, b in zip(x, y)]

    def _attn_res(self, p, x, ys) -> list:
        """The attention residual from the ranks' out-projections."""
        y = self._reduced(self.btd_op(self.attn_tp), ys)
        if self.cfg.post_norm:
            y = self._norm(p["post_ln1"], y)
        return [a + b for a, b in zip(x, y)]

    def _ffn_res(self, kind, p, spec, x):
        """The second residual: (x, the MoE layer's stats or None)."""
        if kind["moe"]:
            return self._moe_res(p, spec, x)
        return self._mlp_res(p, spec, x), None

    def _out(self, ys) -> list:
        """Outputs that take a ``btd`` reduction, in the rules' reduce
        dtype when they set one (``ctx.tp_matmul``'s)."""
        dt = self.rules.reduce_dtype
        return list(ys) if dt is None else [y.to(dt) for y in ys]

    def _reduced(self, op, ys) -> list:
        """The ``btd`` reduction ``op`` of the ranks' outputs, back in the
        model dtype where the rules sum wider partials (serving's f32)."""
        y = self._run(op, self._out(ys))
        dt = self.rules.reduce_dtype
        if dt is not None and wider(dt, self.dtype):
            y = [t.to(self.dtype) for t in y]
        return y

    def _mlp_res(self, p, spec, x) -> list:
        """The MLP residual (column- then row-parallel)."""
        cfg = self.cfg
        tp = "model" in spec["mlp"]["w_in"]
        pm = {k: self._gather(v, spec["mlp"][k], self.mlp_keep)
              for k, v in p["mlp"].items()}
        xm = self._run(self.full_op(tp), self._norm(p["ln2"], x))
        ys = [L.apply_mlp(cfg, {k: v[r] for k, v in pm.items()}, xr)
              for r, xr in enumerate(xm)]
        y = self._reduced(self.btd_op(tp), ys)
        if cfg.post_norm:
            y = self._norm(p["post_ln2"], y)
        return [a + b for a, b in zip(x, y)]

    def _moe_res(self, p, spec, x):
        """The MoE residual (``moe_plan``): (x, every rank's
        ``balance_stats`` of its rows (and positions))."""
        cfg, mesh, moe = self.cfg, self.mesh, self.cfg.moe
        sp = spec["moe"]
        plan = self.moe_plan(sp)
        e, _ = MoE.moe_dims(cfg)
        pm = {k: self._gather(v, sp[k], self.mlp_keep)
              for k, v in p["moe"].items()}
        router = self._run(self.norm_op(), pm.pop("router"))
        ws = [{k: v[r] for k, v in pm.items()} for r in range(mesh.size)]
        xn = self._norm(p["ln2"], x)
        top_w, top_e, stats = [], [], []
        for xr, wr in zip(xn, router):
            tw, te, probs = MoE.router_probs(moe, xr.float() @ wr)
            stats.append(MoE.balance_stats(probs, te, e))
            top_w.append(tw.to(xr.dtype))
            top_e.append(te)
        xs = self._run(self.full_op(plan["routed"]), xn)
        top_w = self._run(self.full_op(plan["routed"]), top_w)
        if self.seq_split:  # every position's choices, for the dispatch
            top_e = C.all_gather(mesh, top_e, "model", dim=1, grad="slice")
        # with wider partial sums (serving) the experts' outputs are summed
        # before the combine, which then rounds as one device's does
        first = (plan["routed"] and moe.impl != "dense"
                 and self.rules.reduce_dtype is not None
                 and wider(self.rules.reduce_dtype, self.dtype))
        if moe.impl == "dense":  # every choice kept
            routed = [MoE._apply_dense(cfg, w, xr, tw, te) for w, xr, tw, te
                      in zip(ws, xs, top_w, top_e)]
            for r, te in enumerate(top_e):
                if self.mi[r] == 0:
                    MoE.count_drops(te.numel(), 0)
        else:
            routed = self._capacity(plan, ws, xs, top_w, top_e, first)
        parts = {plan["routed"] and not first: routed}
        if moe.n_shared:
            xsh = (xs if plan["shared"] == plan["routed"] else
                   self._run(self.full_op(plan["shared"]), xn))
            shared = [MoE._shared_ffn(cfg, w, xr) for w, xr in zip(ws, xsh)]
            tp = plan["shared"]
            parts[tp] = ([a + b for a, b in zip(parts[tp], shared)]
                         if tp in parts else shared)
        y = None
        for tp, ys in parts.items():
            ys = self._reduced(self.btd_op(tp), ys)
            y = ys if y is None else [a + b for a, b in zip(y, ys)]
        if cfg.post_norm:
            y = self._norm(p["post_ln2"], y)
        return [a + b for a, b in zip(x, y)], stats

    def _capacity(self, plan, ws, xs, top_w, top_e, first=False) -> list:
        """The tp / ep capacity dispatch on every rank's rows: under ep
        the buffer's experts split over ``model`` (``moe_dispatch``) and
        their outputs gathered back (``moe_combine``); with ``first`` the
        experts' partial outputs summed over ``model`` before the
        combine."""
        cfg, mesh = self.cfg, self.mesh
        disp = [MoE.capacity_dispatch(cfg, xr, te)
                for xr, te in zip(xs, top_e)]
        bufs = [b for b, _, _ in disp]
        if plan["split"]:
            bufs = C.split(mesh, bufs, "model", dim=1)
        ybs = [MoE._expert_ffn(cfg, w, b) for w, b in zip(ws, bufs)]
        if first:
            ybs = self._reduced("psum", ybs)
        if plan["split"]:
            ybs = C.all_gather(mesh, ybs, "model", dim=1, grad="slice")
        out = []
        for r, (yb, tw, te, (_, slot, keep)) in enumerate(zip(
                ybs, top_w, top_e, disp)):
            y, dropped = MoE.capacity_combine(yb, tw, te, slot, keep)
            if self.mi[r] == 0:  # each row's choices counted once
                MoE.count_drops(te.numel(), dropped)
            out.append(y)
        return out

    def _mamba_res(self, p, spec, x, cache=None, decode: bool = False):
        """The mamba residual (``mamba_tp``); with ``cache`` each rank
        starts from and writes back its channels' conv tail and ssm
        state, else they start at zero (training)."""
        cfg, mesh = self.cfg, self.mesh
        sp = spec["mamba"]
        tp = self.mamba_tp(sp)
        keep = ("model",) if tp else ()
        pm = {k: self._gather(v, sp[k], keep) for k, v in p["mamba"].items()}
        ws = [{k: v[r] for k, v in pm.items()} for r in range(mesh.size)]
        xm = self._run(self.full_op(tp), self._norm(p["ln1"], x))
        xz = [(xr[:, 0] if decode else xr) @ w["in_proj"]
              for xr, w in zip(xm, ws)]
        if tp:  # each rank's x chunk and the matching z chunk
            xz = C.deal(mesh, xz, "model", dim=-1, parts=2)
        _, n, dc, _ = MB.mamba_dims(cfg)
        xcs, zs, convs = [], [], []
        for r, (t, w) in enumerate(zip(xz, ws)):
            xi, z = t.chunk(2, dim=-1)
            conv = (cache["conv"][r] if cache is not None else torch.zeros(
                (xi.shape[0], dc - 1, xi.shape[-1]), dtype=xi.dtype,
                device=xi.device))
            xc, conv = (MB.decode_conv if decode else MB.conv_in)(
                cfg, w, xi, conv)
            xcs.append(xc)
            zs.append(z)
            convs.append(conv)
        proj = [(tp_matmul if tp else torch.matmul)(xc, w["x_proj"])
                for xc, w in zip(xcs, ws)]
        if tp:  # the dt / B / C projection whole, its gradient summed
            proj = C.copy(mesh, C.psum(mesh, self._out(proj), "model"),
                          "model")
        ys = []
        for r, (xc, z, w, pr) in enumerate(zip(xcs, zs, ws, proj)):
            h = (cache["ssm"][r] if cache is not None else torch.zeros(
                (xc.shape[0], xc.shape[-1], n), dtype=torch.float32,
                device=xc.device))
            y, h = (MB.decode_scan if decode else MB.scan)(
                cfg, w, xc, h, proj=pr.float())
            if cache is not None:
                cache["conv"][r].copy_(convs[r])
                cache["ssm"][r].copy_(h)
            y = tp_matmul(y.to(z.dtype) * F.silu(z), w["out_proj"])
            ys.append(y[:, None] if decode else y)
        y = self._reduced(self.btd_op(tp), ys)
        if cfg.post_norm:
            y = self._norm(p["post_ln1"], y)
        return [a + b for a, b in zip(x, y)]

    def _rwkv_res(self, p, spec, x, cache=None, decode: bool = False):
        """rwkv6's two residuals (``rwkv_tp``), time mix then channel mix;
        with ``cache`` each rank starts from and writes back its shift
        tails and its heads' wkv state (all read before any is written:
        ranks of one device share the whole tails), else from zero
        (training)."""
        cfg, mesh = self.cfg, self.mesh
        sp = spec["rwkv"]
        tp = self.rwkv_tp(sp)
        pw = {k: self._gather(v, sp[k], ("model",) if tp else ())
              for k, v in p["rwkv"].items()}
        if tp:
            for k in RWKV_SUMMED:
                pw[k] = C.copy(mesh, pw[k], "model")
            for k in RWKV_SLICED:
                pw[k] = C.split(mesh, pw[k], "model", dim=0)
        ws = [{k: v[r] for k, v in pw.items()} for r in range(mesh.size)]
        xa = self._run(self.full_op(tp), self._norm(p["ln1"], x))
        if cache is not None:
            states = [{k: cache[k][r] for k in cache}
                      for r in range(mesh.size)]
        else:  # zero, the wkv state on the rank's heads
            states = [R.init_rwkv_state(cfg, xr.shape[0], xr.dtype,
                                        device=xr.device) for xr in xa]
            for st, w in zip(states, ws):
                st["wkv"] = st["wkv"][:, :w["bonus_u"].shape[0]]
        time_mix, channel_mix = ((R.decode_rwkv_time_mix,
                                  R.decode_rwkv_channel_mix) if decode else
                                 (R.apply_rwkv_time_mix,
                                  R.apply_rwkv_channel_mix))
        ys = []
        for r, xr in enumerate(xa):
            y, states[r] = time_mix(cfg, ws[r], xr, states[r])
            ys.append(y)
        y = self._reduced(self.btd_op(tp), ys)
        x = [a + b for a, b in zip(x, y)]
        xc = self._run(self.full_op(tp), self._norm(p["rwkv_ln2"], x))
        gates, values = [], []
        for r, xr in enumerate(xc):
            prev = states[r]["shift_c"].to(xr.dtype)
            if decode:
                g, v = R.channel_parts(ws[r], xr[:, 0], prev)
                g, v = g[:, None], v[:, None]
            else:
                g, v = R.channel_parts(ws[r], xr, torch.cat(
                    [prev[:, None], xr[:, :-1]], 1))
            states[r]["shift_c"] = xr[:, -1]
            gates.append(g)
            values.append(v)
        if tp:  # the gate whole on every rank, its gradient partial
            gates = C.all_gather(mesh, gates, "model", dim=-1, grad="sum")
        y = self._reduced(self.btd_op(tp), [g * v for g, v in
                                            zip(gates, values)])
        if cache is not None:
            for r, st in enumerate(states):
                for k, t in st.items():
                    cache[k][r].copy_(t)
        return [a + b for a, b in zip(x, y)]

    def _ce_chunk(self, xs, ws, ts) -> list:
        """Summed cross-entropy of one chunk of positions on every rank."""
        cfg, mesh = self.cfg, self.mesh
        if self.ce_2p5d:
            xl = C.all_to_all(mesh, xs, "pod", split_dim=2, concat_dim=0)
            d_l = xl[0].shape[2]
            outs = matmul_2p5d(mesh, [x.reshape(-1, d_l) for x in xl],
                               [w.T for w in ws], depth_axis="pod",
                               reduce="scatter")
            logits = [o.reshape(x.shape[0], x.shape[1], -1)
                      for o, x in zip(outs, xs)]
        else:
            logits = [x @ w.T for x, w in zip(xs, ws)]
        if cfg.final_softcap is not None:
            cap = cfg.final_softcap
            logits = [torch.tanh(z / cap) * cap for z in logits]
        logits = [z.float() for z in logits]
        if not self.head_tp:
            return [torch.sum(torch.logsumexp(z, dim=-1)
                              - torch.gather(z, -1, t[..., None])[..., 0])
                    for z, t in zip(logits, ts)]
        top = C.pmax(mesh, [z.detach().amax(-1) for z in logits], "model")
        parts = []
        for r, (z, t) in enumerate(zip(logits, ts)):
            loc = t - self.mi[r] * z.shape[-1]
            inside = (loc >= 0) & (loc < z.shape[-1])
            gold = torch.gather(z, -1, torch.where(inside, loc, 0)[..., None])
            gold = torch.where(inside, gold[..., 0], 0.0)
            sumexp = torch.exp(z - top[r][..., None]).sum(-1)
            parts.append(torch.stack([sumexp, gold]))
        tot = C.psum(mesh, parts, "model")
        return [torch.sum(m + torch.log(s[0]) - s[1])
                for m, s in zip(top, tot)]

    def local_losses(self, params, tokens, targets, n_tokens: int, *,
                     aux_coef: float = 0.01, frame_embeds=None,
                     patch_embeds=None) -> tuple[list, list, list]:
        """(losses, ce, aux), one per rank: ``ce`` the rank's share of the
        mean cross-entropy (its rows' sum over ``n_tokens``, the global
        batch's), ``aux`` the MoE load-balance loss of the global batch
        (whole on every rank), and the loss to seed, ``ce + aux_coef *
        aux`` (the sum of ``ce`` over the batch axes plus ``aux_coef *
        aux`` once is the loss).  ``params``: the port's tree with a list
        of per-rank tensors at every leaf; ``tokens`` / ``targets``:
        per-rank (rows, S) lists; ``frame_embeds`` (whisper) / ``patch_embeds``
        (pixtral): per-rank (rows, F or n, d) lists.  Runs under the rules
        (and each layer installs them again for its recompute)."""
        with sharding_rules(self.rules):
            ce, aux = self._local_losses(params, tokens, targets, n_tokens,
                                         frame_embeds, patch_embeds)
        return [c + aux_coef * a for c, a in zip(ce, aux)], ce, aux

    def _local_losses(self, params, tokens, targets, n_tokens, frames,
                      patches):
        cfg, mesh, spec = self.cfg, self.mesh, self.p_spec
        emb = params["embed"]
        tok = self._gather(emb["tok"], spec["embed"]["tok"], self.tok_keep)
        x = self._inputs(tok, tokens, patches)
        s = tokens[0].shape[1]
        positions = [torch.arange(s, device=t.device) for t in tokens]
        # a recompute reruns the whole layer, its last reduction too, so
        # the collectives a step runs do not hang on what autograd saves
        stats = []
        with set_checkpoint_early_stop(False):
            enc = (self._encode(params, frames, self._layer_fn)
                   if cfg.encoder is not None and frames is not None
                   else None)
            for kind, p, sp in zip(self.kinds, params["blocks"],
                                   spec["blocks"]):
                x, st = self._layer_fn(cfg, kind, p, x, sp, positions, enc)
                if st is not None:
                    stats.append(st)
        x = self._run(self.full_op(self.head_tp),
                      self._norm(params["final_norm"], x))
        head = tok if "out" not in emb else self._gather(
            emb["out"], self.head_spec, self.head_keep)
        if self.ce_2p5d and self.head_spec[1] != "pod":
            d_l = cfg.d_model // mesh.shape["pod"]
            head = [w.narrow(1, self.pi[r] * d_l, d_l)
                    for r, w in enumerate(head)]
        chunk = min(self.loss_chunk, s)
        if s % chunk:
            raise ValueError(f"loss chunk {chunk} must divide {s}")
        total = None
        for c0 in range(0, s, chunk):
            sums = checkpoint(self._ce_chunk,
                              [xi[:, c0:c0 + chunk] for xi in x], head,
                              [t[:, c0:c0 + chunk] for t in targets],
                              use_reentrant=False)
            total = sums if total is None else [a + b for a, b in
                                                zip(total, sums)]
        return [t / n_tokens for t in total], self._aux(stats, n_tokens)

    def _aux(self, stats, n_tokens: int) -> list:
        """Every rank's MoE load-balance loss summed over the layers, from
        the layers' stats summed over ``aux_axes`` (whole on every rank;
        zero without MoE layers)."""
        if not stats:
            return [torch.zeros((), dtype=torch.float32, device=d)
                    for d in self.mesh.devices]
        tot = C.psum(self.mesh, [torch.stack(s) for s in zip(*stats)],
                     self.aux_axes)
        return [MoE.balance_loss(t, n_tokens) for t in tot]



    # ---- serving ----------------------------------------------------------

    def kv_layout(self, max_len: int) -> str:
        """Where a rank's K/V cache lives (``sharding.cache_specs``'
        rule): "heads" over ``model`` when the kv heads divide it (then
        the attention heads do too), else the "seq"uence over ``model``
        when it divides, else "whole" on every model rank."""
        if self.attn_tp:
            return "heads"
        return "seq" if max_len % self.m == 0 else "whole"

    def _check_serving(self) -> None:
        if self.layout is None:
            raise ValueError("serving needs the runtime's max_len (the "
                             "cache's length)")
        if self.seq_split or self.ce_2p5d:
            raise ValueError("serving runs the reference's serving rules: "
                             "no sequence parallelism, no 2.5D head")

    def _write_prompt(self, cache, r, k, v, names=("k", "v"),
                      layout=None) -> None:
        """Rank ``r``'s part of a prompt's K/V (positions [0, S)) into its
        cache (``names``: the self K/V, or whisper's cross K/V under their
        own layout): its heads, or its chunk of the positions."""
        ck, cv = cache[names[0]][r], cache[names[1]][r]
        if (layout or self.layout) != "seq":
            T._update_kv(ck, cv, k, v, 0)
            return
        chunk = ck.shape[2]
        lo = min(self.mi[r] * chunk, k.shape[2])
        hi = min(lo + chunk, k.shape[2])
        ck[:, :, :hi - lo] = k[:, :, lo:hi]
        cv[:, :, :hi - lo] = v[:, :, lo:hi]

    def _logits(self, params, x) -> list:
        """Each rank's logits (rows, s, V) of the hidden rows ``x``: the
        final norm, the vocab-parallel head, the cap, then an all-gather
        of the vocabulary over ``model``."""
        cfg = self.cfg
        emb = params["embed"]
        head = self._gather(emb.get("out", emb["tok"]), self.head_spec,
                            self.head_keep)
        x = self._run(self.full_op(self.head_tp),
                      self._norm(params["final_norm"], x))
        logits = [xi @ w.T for xi, w in zip(x, head)]
        if cfg.final_softcap is not None:
            cap = cfg.final_softcap
            logits = [torch.tanh(z / cap) * cap for z in logits]
        if self.head_tp:
            logits = C.all_gather(self.mesh, logits, "model", dim=2)
        return logits

    def _token_table(self, params) -> list:
        emb = params["embed"]
        return self._gather(emb["tok"], self.p_spec["embed"]["tok"],
                            self.tok_keep)

    @torch.no_grad()
    def prefill(self, params, tokens, cache, *, frame_embeds=None,
                patch_embeds=None) -> list:
        """Run the prompt (per-rank (rows, S) ``tokens``; whisper's frames
        and pixtral's patches per-rank lists as in ``local_losses``), write
        its K/V (and with frames the cross K/V) into ``cache`` (the port's
        cache tree with per-rank tensors at its leaves, laid out by
        ``cache_specs``) in place, and return every rank's logits of the
        last position (rows, 1, V)."""
        self._check_serving()
        cfg = self.cfg
        with sharding_rules(self.rules):
            x = self._inputs(self._token_table(params), tokens, patch_embeds)
            s = tokens[0].shape[1]
            positions = [torch.arange(s, device=t.device) for t in tokens]
            enc = None
            if cfg.encoder is not None and frame_embeds is not None:
                if frame_embeds[0].shape[1] != cfg.encoder.n_frames:
                    raise ValueError(f"{frame_embeds[0].shape[1]} frames for "
                                     f"a cache of {cfg.encoder.n_frames}")
                enc = self._encode(params, frame_embeds, self._layer)
            for kind, p, sp, c in zip(self.kinds, params["blocks"],
                                      self.p_spec["blocks"],
                                      cache["blocks"]):
                x, _ = self._layer_body(kind, p, x, sp, positions,
                                        cache=c, enc=enc)
            return self._logits(params, [xi[:, -1:] for xi in x])

    @torch.no_grad()
    def decode(self, params, tokens, cache, position: int) -> list:
        """One token per row (per-rank (rows, 1) ``tokens``) at
        ``position`` (the fill level, one for every row): writes its K/V
        into ``cache`` in place and returns every rank's logits (rows, 1,
        V)."""
        self._check_serving()
        position = int(position)
        cfg = self.cfg
        with sharding_rules(self.rules):
            x = self._embed(self._token_table(params), tokens)
            if not cfg.rope:  # the sinusoidal embedding at the position
                x = [xr + L.sinusoidal_at(torch.tensor(
                    [position], device=xr.device), cfg.d_model).to(
                        xr.dtype)[:, None, :] for xr in x]
            rope = [torch.tensor([position], device=t.device)
                    for t in tokens]
            for kind, p, sp, c in zip(self.kinds, params["blocks"],
                                      self.p_spec["blocks"],
                                      cache["blocks"]):
                x = self._decode_layer(kind, p, x, sp, c, rope, position)
            return self._logits(params, x)

    def _decode_layer(self, kind, p, x, spec, cache, rope, position):
        if kind["mixer"] == "rwkv6":
            return self._rwkv_res(p, spec, x, cache, decode=True)
        if kind["mixer"] == "mamba":
            x = self._mamba_res(p, spec, x, cache, decode=True)
        else:
            x = self._attn_decode(kind, p, spec, x, cache, rope, position)
            if "xk" in cache:  # zeros unless a prefill with frames filled it
                x = self._cross_decode(p, spec, x, cache)
        return self._ffn_res(kind, p, spec, x)[0]

    def _cross_decode(self, p, spec, x, cache) -> list:
        """whisper's cross-attention residual for one token against the
        cross K/V in its layout (every frame valid)."""
        pa = {k: self._gather(v, spec["xattn"][k], self.attn_keep)
              for k, v in p["xattn"].items()}
        xq = self._run(self.full_op(self.attn_tp), self._norm(p["ln_x"], x))
        ws = [{k: v[r] for k, v in pa.items()} for r in range(len(xq))]
        n = self.cfg.encoder.n_frames
        seq = self.x_layout == "seq"
        qs, parts = [], []
        for r, xr in enumerate(xq):
            q = A.cross_q(self.cfg_attn, ws[r], xr)
            ck, cv = cache["xk"][r], cache["xv"][r]
            if seq:
                qs.append(q)
                parts.append(A.decode_partial(
                    q, ck, cv, n, key_offset=self.mi[r] * ck.shape[2]))
            else:
                qs.append(A.decode_attention(q, ck, cv, n))
        if seq:
            qs = self._combine(qs, parts)
        ys = [A.out_proj(self.cfg_attn, w, o) for w, o in zip(ws, qs)]
        y = self._reduced(self.btd_op(self.attn_tp), ys)
        return [a + b for a, b in zip(x, y)]

    def _attn_decode(self, kind, p, spec, x, cache, rope, position):
        cfg = self.cfg
        window = kind.get("window")
        pa = {k: self._gather(v, spec["attn"][k], self.attn_keep)
              for k, v in p["attn"].items()}
        xa = self._run(self.full_op(self.attn_tp), self._norm(p["ln1"], x))
        ws = [{k: v[r] for k, v in pa.items()} for r in range(len(xa))]
        seq = self.layout == "seq"
        qs, parts = [], []
        for r, xr in enumerate(xa):
            q, k, v = A.qkv_proj(self.cfg_attn, ws[r], xr, rope[r])
            ck, cv = cache["k"][r], cache["v"][r]
            if not seq:
                T._update_kv(ck, cv, k, v, position)
                qs.append(A.decode_attention(q, ck, cv, position + 1,
                                             window=window,
                                             softcap=cfg.attn_softcap))
                continue
            chunk = ck.shape[2]
            c0 = self.mi[r] * chunk
            if c0 <= position < c0 + chunk:
                T._update_kv(ck, cv, k, v, position - c0)
            qs.append(q)
            parts.append(A.decode_partial(q, ck, cv, position + 1,
                                          key_offset=c0, window=window,
                                          softcap=cfg.attn_softcap))
        if seq:
            qs = self._combine(qs, parts)
        ys = [A.out_proj(self.cfg_attn, w, o) for w, o in zip(ws, qs)]
        return self._attn_res(p, x, ys)

    def _combine(self, qs, parts) -> list:
        """The ranks' partial attentions over their chunks of the sequence
        combined over ``model``: (b, h, 1, d) in q's dtype on every
        rank."""
        top = C.pmax(self.mesh, [m for m, _, _ in parts], "model")
        scaled = [torch.cat([l * torch.exp(m - t), acc * torch.exp(m - t)],
                            dim=-1)
                  for (m, l, acc), t in zip(parts, top)]
        tot = C.psum(self.mesh, scaled, "model")
        out = []
        for q, t in zip(qs, tot):
            b, h, _, d = q.shape
            o = t[..., 1:] / t[..., :1]
            out.append(o.reshape(b, h, 1, d).to(q.dtype))
        return out

    # ---- bytes per rank ---------------------------------------------------

    def loss_bytes(self, shapes, *, rows: int, seq: int,
                   frames: bool = True) -> float:
        """Bytes per rank that one forward and backward of
        ``local_losses`` moves on ``rows`` per rank of ``seq`` tokens
        (whisper's with its frames through the encoder when ``frames``):
        the collectives the cut-point methods above name, priced by
        ``ACT_BYTES`` on ``shapes`` (``sharding.param_shapes``).  The
        layers' forward collectives run twice under remat full / dots (the
        recompute reruns the whole layer), the CE chunks' always (each
        chunk is checkpointed)."""
        cfg, spec = self.cfg, self.p_spec
        axes = dict(self.mesh.shape)
        rep = (self.m - 1) / self.m
        e = _itemsize(T.model_dtype(cfg))
        er = e if self.rules.reduce_dtype is None else _itemsize(
            self.rules.reduce_dtype)
        act = rows * seq * cfg.d_model  # elements of one (rows, S, d)

        def op(name, nbytes):
            f, b = ACT_BYTES[name]
            return f * rep * nbytes, b * rep * nbytes

        def gathers(leaf, sp, keep):
            size = _nbytes(leaf) / math.prod(_entry_size(axes, x) for x in sp)
            fwd = bwd = 0.0
            for _, entry, grad in self.gather_plan(sp, keep):
                n = _entry_size(axes, entry)
                size *= n
                fwd += (n - 1) / n * size
                bwd += (n - 1) / n * size if grad == "sum" else 0.0
            return fwd, bwd

        def norms(p, names):
            return [op(self.norm_op(), _nbytes(leaf)) for n in names
                    if n in p for leaf in p[n].values()]

        def total(parts):
            return sum(f for f, _ in parts), sum(b for _, b in parts)

        fwd, bwd = total([
            gathers(shapes["embed"]["tok"], spec["embed"]["tok"],
                    self.tok_keep),
            op(self.btd_op(self.embed_tp), act * e)])

        def residual(tp, keep, p, sp, n=act):
            """A sub-layer's weight gathers, input and output (``n``
            elements of a (rows, S, d) activation)."""
            return [gathers(leaf, sp[k], keep) for k, leaf in p.items()] + [
                op(self.full_op(tp), n * e), op(self.btd_op(tp), n * er)]

        def block(kind, p, sp, n=act):
            """One block's (forward, backward) parts."""
            if kind["mixer"] == "rwkv6":
                return self._rwkv_bytes(p, sp, residual, op, norms, n, e)
            if kind["mixer"] == "mamba":
                parts = self._mamba_bytes(p["mamba"], sp["mamba"],
                                          residual, rows * seq, er)
            else:
                parts = residual(self.attn_tp, self.attn_keep, p["attn"],
                                 sp["attn"], n)
            if enc and "xattn" in p:
                parts += residual(self.attn_tp, self.attn_keep, p["xattn"],
                                  sp["xattn"]) + norms(p, ("ln_x",))
            if kind["moe"]:
                parts += self._moe_bytes(p["moe"], sp["moe"], gathers, op,
                                         rows, seq, e, er)
            else:
                parts += residual("model" in sp["mlp"]["w_in"],
                                  self.mlp_keep, p["mlp"], sp["mlp"], n)
            return parts + norms(p, ("ln1", "ln2", "post_ln1", "post_ln2"))

        enc = frames and cfg.encoder is not None
        layers = []
        if enc:  # the encoder's blocks, its final norm and its output
            n_enc = rows * cfg.encoder.n_frames * cfg.d_model
            for p, sp in zip(shapes["encoder"]["blocks"],
                             spec["encoder"]["blocks"]):
                layers += block(ENCODER_KIND, p, sp, n_enc)
            f, b = total(norms(shapes["encoder"], ("final_norm",))
                         + [op(self.full_op(self.attn_tp), n_enc * e)])
            fwd, bwd = fwd + f, bwd + b
        for kind, p, sp in zip(self.kinds, shapes["blocks"], spec["blocks"]):
            layers += block(kind, p, sp)
        f, b = total(layers)
        fwd += f * (2 if self.remat in ("full", "dots") else 1)
        bwd += b
        if self.n_moe:  # the load-balance sums, outside the layers
            n = math.prod(axes[a] for a in self.aux_axes)
            fwd += 2 * (n - 1) / n * self.n_moe * 2 * cfg.moe.n_experts * 4
        head = norms(shapes, ("final_norm",))
        head.append(op(self.full_op(self.head_tp), act * e))
        if "out" in shapes["embed"]:
            head.append(gathers(shapes["embed"]["out"], self.head_spec,
                                self.head_keep))
        f, b = total(head)
        fwd, bwd = fwd + f, bwd + b
        chunk = min(self.loss_chunk, seq)
        ce_f = ce_b = 0.0
        if self.ce_2p5d:
            pod = axes["pod"]
            x_chunk = rows * chunk * cfg.d_model * e
            ce_f += (pod - 1) / pod * x_chunk  # the all-to-all
            ce_b += (pod - 1) / pod * x_chunk
            out = rows * chunk * cfg.vocab // (self.m if self.head_tp
                                               else 1) * e
            ce_f += (pod - 1) * out  # matmul_2p5d's psum-scatter
            ce_b += (pod - 1) * out
        if self.head_tp:
            ce_f += 2 * rep * rows * chunk * 4 * 3  # the max, sumexp, gold
        return fwd + bwd + seq // chunk * (2 * ce_f + ce_b)

    def _rwkv_bytes(self, p, sp, residual, op, norms, n: int, e: int) -> list:
        """An rwkv6 block's (forward, backward) bytes (``_rwkv_res``): the
        weight gathers, both residuals' input and output, the norms, and
        on its channels the summed leaves' copies, the sliced leaves'
        splits and the channel mix's gate all-gather."""
        tp = self.rwkv_tp(sp["rwkv"])
        keep = ("model",) if tp else ()
        parts = residual(tp, keep, p["rwkv"], sp["rwkv"], n)
        parts += residual(tp, keep, {}, {}, n)  # the channel mix
        if tp:
            parts += [op("copy", _nbytes(p["rwkv"][k])) for k in RWKV_SUMMED]
            parts += [op("split", _nbytes(p["rwkv"][k]))
                      for k in RWKV_SLICED]
            parts.append(op("gather_sum", n * e))
        return parts + norms(p, ("ln1", "rwkv_ln2"))

    def _mamba_bytes(self, p, sp, residual, tokens: int, er: int) -> list:
        """A mamba layer's (forward, backward) bytes: ``residual``'s, and
        on its channels the deal of in_proj's product and the x_proj
        projection's psum (whose gradient is psummed back)."""
        tp = self.mamba_tp(sp)
        parts = residual(tp, ("model",) if tp else (), p, sp)
        if tp:
            m = self.m
            di, n, _, dtr = MB.mamba_dims(self.cfg)
            chunk = tokens * di // m * _itemsize(T.model_dtype(self.cfg))
            proj = 2 * (m - 1) / m * tokens * (dtr + 2 * n) * er
            parts += [(deal_foreign(m, 2) * chunk,
                       deal_foreign(m, 2, inverse=True) * chunk),
                      (proj, proj)]
        return parts

    def _moe_bytes(self, p, sp, gathers, op, rows: int, seq: int, e: int,
                   er: int) -> list:
        """An MoE layer's (forward, backward) bytes (``_moe_res``)."""
        cfg, moe = self.cfg, self.cfg.moe
        plan = self.moe_plan(sp)
        act = rows * seq * cfg.d_model
        choices = rows * seq * moe.top_k
        parts = [gathers(leaf, sp[k], self.mlp_keep) for k, leaf in p.items()]
        parts += [op(self.norm_op(), _nbytes(p["router"])),
                  op(self.full_op(plan["routed"]), act * e),
                  op(self.full_op(plan["routed"]), choices * e)]
        if self.seq_split:  # the choices' expert ids (int64)
            parts.append(op("gather_slice", choices * 8))
        if moe.impl != "dense" and plan["split"]:
            buf = (rows * moe.n_experts * MoE.moe_capacity(cfg, seq)
                   * cfg.d_model)
            parts += [op("split", buf * e), op("gather_slice", buf * er)]
        outs = {plan["routed"]}
        if moe.n_shared:
            if plan["shared"] != plan["routed"]:
                parts.append(op(self.full_op(plan["shared"]), act * e))
            outs.add(plan["shared"])
        return parts + [op(self.btd_op(tp), act * er) for tp in outs]


# (forward, backward) bytes per rank of each cut point's collective over
# ``model``, in units of (m - 1) / m of the whole tensor it reduces or
# gathers (the transport's conventions: a psum 2 (n - 1) / n of its input,
# an all-gather (n - 1) / n of its output, a psum-scatter (n - 1) times
# its output)
ACT_BYTES = {None: (0, 0), "psum": (2, 0), "copy": (0, 2),
             "psum_scatter": (1, 1), "split": (0, 1), "gather_sum": (1, 1),
             "gather_slice": (1, 0)}


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _nbytes(leaf) -> float:
    return math.prod(leaf.shape) * _itemsize(leaf.dtype)


def _entry_size(axes, entry) -> int:
    return math.prod(axes[a] for a in entry_axes(entry))

