"""The steps — the twin of ``repro/launch/steps.py``: the training
step (``build_train_step``, ``abstract_state``), the serving steps of the
dry run (``build_prefill_step``, ``build_serve_step``) and the model
inputs' stand-ins (``batch_sds``), on one device or on a mesh of ranks.

``StepOptions`` holds the reference's options with its defaults:
``remat``, ``fsdp_axis``, ``seq_parallel``, ``loss_chunk``,
``head_2p5d``, ``compress_grads``, ``bf16_reduce``, ``microbatch``,
``zero1`` and ``aux_coef``; the sharding options act only on a mesh.
Every ``build_*_step`` takes ``(cfg, shape, *, options, device, mesh)``
(the reference's take ``(cfg, mesh, shape, *, options)``).  The
reference's return a jitted function and its inputs as
``jax.ShapeDtypeStruct``s with shardings; the port's serving ones
return the step and its inputs as trees of ``SDS`` (shape, dtype, spec;
spec None on one device), which the dry run places as ``meta`` tensors
(``sds_zeros``).  The port serves requests through ``serving/engine.py``;
these steps are the reference's single prefill and decode calls.

The serving steps: ``prefill_step(params, cache, batch) -> (logits,
cache)`` runs ``transformer.prefill`` (the last position's logits (B, 1,
V), the cache filled in place) and ``serve_step(params, cache, tokens,
position) -> (logits, cache)`` one ``transformer.decode_step``.  On a mesh
they run ``parallel/runtime.py``'s
``prefill`` / ``decode`` with parameters laid out as ``abstract_state``'s
(no optimizer) and the cache as ``sharding.cache_specs``'
(``init_sharded_cache``), whisper's frames and pixtral's patches rows
over the batch axes as ``input_specs_sharded`` places them; the logits
come back as ``Shards``, each
rank's rows over the whole vocabulary (``sharding.unshard`` with
``batch_spec`` assembles them).  A bf16 model's tensor-parallel partials
are summed in f32 and rounded once (the serving rules' ``reduce_dtype``).

The one-device step: gradients of ``transformer.loss_fn`` by autograd (in
the parameters' dtype), or with ``microbatch = k`` the mean over k row
slices of the batch in f32 accumulators (g / k added per slice, loss, ce
and aux averaged the same way); with ``compress_grads`` the bf16 payload
and its f32 residual (``opt_state["efb"]``), cast back to f32; then one
AdamW update.  Metrics: ``loss``, ``ce``, ``moe_aux``, ``grad_norm``.

The sharded step (``mesh=``, every family): parameters, moments and
residuals are trees of ``sharding.Shards`` laid out by
``abstract_state``'s specs — TP over ``model``, FSDP over ``fsdp_axis``,
the batch (tokens, targets, whisper's frames, pixtral's patches) over
``(pod, data)`` — and the loss is ``parallel/runtime.py``'s.  After each
microbatch's backward every gradient is reduced into the moment layout:
psum-scattered over the axes the moments shard and the parameters do not
(ZeRO-1), psummed over the batch axes its FSDP gather did not already sum;
with k microbatches the f32 accumulators live in that layout.  The step
donates its parameters and optimizer state (the reference's jit donates
them): the updates are written into the shards it was given.  Under
``compress_grads`` the accumulated gradient is compressed per rank with
its own residual (parameter layout) and that reduction runs on the bf16
payload (``optim.compressed_allreduce``).  The clipping norm counts each
distinct shard once (``optim.sharded_global_norm``); AdamW updates each
distinct moment shard once, and ZeRO-1's updated shards are all-gathered
back to the parameters' layout.  Each rank splits its own rows into the
k microbatches (the reference slices the global batch first; the sum is
the same for the cross-entropy; the MoE load-balance loss is a statistic
of each microbatch's rows, so under ``microbatch`` > 1 with MoE layers the
two steps average it over other row sets).  Metrics as the one-device
step's: ``ce`` summed over the batch axes, ``moe_aux`` whole on every
rank, ``loss = ce + aux_coef * moe_aux``.  ``step_bytes`` counts the bytes
per rank a step moves from the specs alone.
"""
from __future__ import annotations

import math
from collections import namedtuple
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.config import (
    ArchConfig,
    ShapeConfig,
    input_specs,
    resolve_device,
)
from repro_torch.core import transport as TR
from repro_torch.models import transformer as T
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    compress_grads,
    compressed_allreduce,
    init_compress_state,
    sharded_global_norm,
)
from repro_torch.optim.tree import leaves, tree_map
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.runtime import DecoderRuntime, check_supported


@dataclass(frozen=True)
class StepOptions:
    remat: str = "dots"  # none | full | dots
    fsdp_axis: Any = "data"
    seq_parallel: bool = False
    loss_chunk: int = 1024
    head_2p5d: bool = False
    compress_grads: bool = False
    bf16_reduce: bool = False  # bf16 partials for TP-contracted matmuls
    microbatch: int = 1  # gradient-accumulation steps
    zero1: bool = False  # shard only the optimizer state over fsdp_axis
    aux_coef: float = 0.01


_MOMENT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# a stand-in for one input: jax.ShapeDtypeStruct with its sharding's spec
SDS = namedtuple("SDS", "shape dtype spec")


def sds_of(shapes, specs=None) -> Any:
    """A tree of ``sharding.Leaf`` (and its specs) as a tree of ``SDS``."""
    if specs is None:
        return tree_map(lambda x: SDS(tuple(x.shape), x.dtype, None), shapes)
    return tree_map(lambda x, sp: SDS(tuple(x.shape), x.dtype, sp), shapes,
                    specs)


def sds_zeros(mesh, tree, device=None) -> Any:
    """A tree of ``SDS`` as tensors: on a mesh, ``Shards`` of zeros laid
    out by each spec (``sharding.zeros``; a 0-d leaf one tensor on rank
    0's device), else one tensor on ``device``.  On ``meta`` ranks
    nothing is allocated."""
    def one(x):
        if mesh is None:
            return torch.zeros(x.shape, dtype=x.dtype, device=device)
        if not x.shape:
            return torch.zeros((), dtype=x.dtype, device=mesh.devices[0])
        return SH.zeros(mesh, x.shape, x.spec, x.dtype)

    return tree_map(one, tree)


def batch_sds(cfg: ArchConfig, shape: ShapeConfig, mesh=None) -> dict:
    """The model inputs' ``SDS`` (``config.input_specs``), on a mesh with
    the batch dim over the batch axes (``sharding.input_specs_sharded``).
    """
    specs = (SH.input_specs_sharded(cfg, shape, mesh) if mesh is not None
             else None)
    return {name: SDS(x.shape, x.dtype, None if specs is None
                      else specs[name])
            for name, x in input_specs(cfg, shape).items()}


def abstract_state(cfg: ArchConfig, mesh, opt: AdamWConfig | None,
                   options: StepOptions):
    """(params shapes, opt-state shapes, params specs, opt-state specs):
    trees of ``sharding.Leaf`` and ``sharding.P``.  Under ZeRO-1 the
    parameters drop FSDP and the moments keep it; the residual ``efb``
    takes the parameters' specs."""
    p_shape = SH.param_shapes(cfg)
    p_fsdp = None if options.zero1 else options.fsdp_axis
    p_spec = SH.param_specs(cfg, p_shape, mesh, fsdp_axis=p_fsdp,
                            head_2p5d=options.head_2p5d)
    if opt is None:
        return p_shape, None, p_spec, None
    m_spec = SH.param_specs(cfg, p_shape, mesh, fsdp_axis=options.fsdp_axis,
                            head_2p5d=options.head_2p5d)
    mdt = _MOMENT[opt.moment_dtype]
    moments = tree_map(lambda x: SH.Leaf(x.shape, mdt), p_shape)
    o_shape = {"mu": moments, "nu": moments,
               "step": SH.Leaf((), torch.int32)}
    o_spec = {"mu": m_spec, "nu": m_spec, "step": SH.P()}
    if options.compress_grads:
        o_shape["efb"] = tree_map(lambda x: SH.Leaf(x.shape, torch.float32),
                                  p_shape)
        o_spec["efb"] = p_spec
    return p_shape, o_shape, p_spec, o_spec


def init_opt_state(params: Any, opt: AdamWConfig,
                   options: StepOptions = StepOptions()) -> dict:
    """Zero AdamW state for ``params``, with the f32 residual ``efb`` when
    the options compress the grads."""
    state = adamw_init(opt, params)
    if options.compress_grads:
        state["efb"] = init_compress_state(params)
    return state


def _grads(cfg, options, params, batch):
    """(loss, {ce, moe_aux}, grads in the parameters' dtype) of one batch;
    a leaf the loss does not reach gets a zero gradient."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = T.loss_fn(cfg, live, batch, aux_coef=options.aux_coef,
                              remat=options.remat,
                              loss_chunk=options.loss_chunk)
    got = iter(torch.autograd.grad(loss, leaves(live), allow_unused=True))

    def grad_or_zeros(t):
        g = next(got)
        return torch.zeros_like(t.detach()) if g is None else g

    grads = tree_map(grad_or_zeros, live)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _check_options(shape: ShapeConfig, options: StepOptions) -> int:
    k = options.microbatch
    if k < 1 or shape.global_batch % k:
        raise ValueError(f"microbatch {k} must divide the global batch "
                         f"{shape.global_batch}")
    if options.remat not in T.REMAT:
        raise ValueError(f"remat {options.remat!r}: one of {T.REMAT}")
    return k


def build_train_step(cfg: ArchConfig, shape: ShapeConfig, *,
                     opt: AdamWConfig | None = None,
                     options: StepOptions = StepOptions(),
                     device=None, mesh=None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` for batches of ``shape`` (``tokens`` / ``targets`` (B, S)
    on ``device``, CUDA unless asked otherwise).  ``opt`` defaults to
    AdamW with the arch's moment dtype; ``opt_state`` comes from
    ``init_opt_state``.  With ``mesh`` (a ``launch.mesh.Mesh`` whose ranks
    sit on ``device``'s type) the sharded step: params and state as
    ``init_sharded`` places them, the batch as per-rank ``Shards``
    (``data.make_global_batch(..., mesh)``) or whole tensors."""
    if opt is None:
        opt = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
    T.check_supported(cfg)
    dev = resolve_device(device)
    k = _check_options(shape, options)
    if mesh is not None:
        return _sharded_step(cfg, shape, opt, options, dev, mesh)

    def train_step(params, opt_state, batch):
        for name in ("tokens", "targets"):
            x = batch[name]
            if tuple(x.shape) != (shape.global_batch, shape.seq_len):
                raise ValueError(f"{name} {tuple(x.shape)} != "
                                 f"{(shape.global_batch, shape.seq_len)}")
            if x.device.type != dev.type:
                raise ValueError(f"{name} on {x.device}, step on {dev}")
        if k > 1:
            rows = shape.global_batch // k
            zero = lambda: torch.zeros((), dtype=torch.float32,
                                       device=dev)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss, ce, aux = zero(), zero(), zero()
            for i in range(k):
                mb = {n: x[i * rows:(i + 1) * rows] if x.dim() >= 1 else x
                      for n, x in batch.items()}
                l_i, m_i, g_i = _grads(cfg, options, params, mb)
                grads = tree_map(lambda a, g: a + g.float() / k, grads, g_i)
                loss = loss + l_i / k
                ce = ce + m_i["ce"] / k
                aux = aux + m_i["moe_aux"] / k
            metrics = {"ce": ce, "moe_aux": aux}
        else:
            loss, metrics, grads = _grads(cfg, options, params, batch)
        residual = None
        if options.compress_grads:
            grads, residual = compress_grads(grads, opt_state["efb"])
            grads = tree_map(lambda g: g.float(), grads)
        core = {n: opt_state[n] for n in ("mu", "nu", "step")}
        params, core, om = adamw_update(opt, params, grads, core)
        opt_state = dict(core, efb=residual) if residual is not None else core
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------


def _rules(cfg, mesh, shape, options):
    return SH.activation_rules(
        cfg, mesh, batch=shape.global_batch,
        seq_parallel=options.seq_parallel, head_2p5d=options.head_2p5d,
        reduce_dtype=torch.bfloat16 if options.bf16_reduce else None)


def _batch_names(mesh) -> tuple[str, ...]:
    ba = SH.batch_axes(mesh)
    return ba if isinstance(ba, tuple) else (ba,)


def _sync_plan(p_spec, m_spec, batch) -> list:
    """The reduction of one leaf's gradient into its moment layout:
    ("scatter", axes, dim) where the moments shard a dim the parameters do
    not, then ("psum", axes) over the batch axes no FSDP gather and no
    scatter summed (the model axis never: its ranks' gradients are whole
    or their own shards')."""
    done = {a for e in p_spec for a in SH.entry_axes(e)}
    plan = []
    for dim, (pe, me) in enumerate(zip(p_spec, m_spec)):
        if pe != me:
            plan.append(("scatter", me, dim))
            done |= set(SH.entry_axes(me))
    rest = tuple(a for a in batch if a not in done)
    if rest:
        plan.append(("psum", rest, None))
    return plan


def _distinct(fn, *lists) -> list:
    """``fn`` rank by rank over per-rank lists, once per distinct tuple of
    inputs (replicas share their result)."""
    seen, out = {}, []
    for args in zip(*lists):
        key = tuple(id(a) for a in args)
        if key not in seen:
            seen[key] = fn(*args)
        out.append(seen[key])
    return out


def init_sharded(cfg: ArchConfig, mesh, params: Any, opt: AdamWConfig,
                 options: StepOptions = StepOptions()):
    """(sharded params, their zero optimizer state): ``params`` — a full
    tree, drawn once — placed on the ranks by ``abstract_state``'s
    specs, so a sharded run starts from a one-device run's parameters.
    The state: moments in the moment layout, the step on rank 0's device,
    one residual per rank."""
    p_shape, o_shape, p_spec, o_spec = abstract_state(cfg, mesh, opt,
                                                      options)
    # in the specs' key order, which the step's leaf lists follow: a tree
    # carried across from the JAX package (``interop``) has its keys sorted
    params = tree_map(lambda _, x: x, p_spec, params)
    sharded = SH.shard_tree(mesh, params, p_spec)
    state = {name: tree_map(lambda x, s: SH.zeros(mesh, x.shape, s, x.dtype),
                            o_shape[name], o_spec[name])
             for name in ("mu", "nu")}
    state["step"] = torch.zeros((), dtype=torch.int32,
                                device=mesh.devices[0])
    if options.compress_grads:
        state["efb"] = tree_map(
            lambda x, s: SH.zeros(mesh, x.shape, s, torch.float32,
                                  per_rank=True), p_shape, o_spec["efb"])
    return sharded, state


def _sharded_step(cfg, shape, opt, options, dev, mesh):
    check_supported(cfg, mesh)
    for d in mesh.devices:
        if d.type != dev.type:
            raise ValueError(f"a rank on {d}, the step on {dev}")
    k = options.microbatch
    rules = _rules(cfg, mesh, shape, options)
    _, _, p_spec, o_spec = abstract_state(cfg, mesh, opt, options)
    m_spec = o_spec["mu"]
    batch_axes = _batch_names(mesh)
    n_batch = math.prod(mesh.shape[a] for a in batch_axes)
    if shape.global_batch % (k * n_batch):
        raise ValueError(f"the global batch {shape.global_batch} must "
                         f"split into {k} microbatches over {n_batch} "
                         f"batch ranks")
    if options.seq_parallel and shape.seq_len % mesh.shape["model"]:
        raise ValueError(f"seq_parallel: seq_len {shape.seq_len} over "
                         f"model {mesh.shape['model']}")
    runtime = DecoderRuntime(cfg, mesh, p_spec, rules, remat=options.remat,
                             loss_chunk=options.loss_chunk)
    p_specs, m_specs = leaves(p_spec), leaves(m_spec)
    plans = [_sync_plan(ps, ms, batch_axes)
             for ps, ms in zip(p_specs, m_specs)]
    batch_spec = SH.batch_spec(mesh, shape.global_batch, shape.seq_len)
    rows = shape.global_batch // n_batch // k
    n_tokens = shape.global_batch // k * shape.seq_len

    def sync(g, plan):
        for op, axes, dim in plan:
            if op == "scatter":
                g = TR.psum_scatter(mesh, g, axes, dim)
            else:
                g = TR.psum(mesh, g, axes)
        return g

    def micro_grads(params, tokens, targets, embeds):
        live = [[t.detach().requires_grad_() for t in s]
                for s in leaves(params)]
        it = iter(live)
        tree = tree_map(lambda _: next(it), params)
        losses, ce, aux = runtime.local_losses(
            tree, tokens, targets, n_tokens, aux_coef=options.aux_coef,
            **embeds)
        flat = [t for s in live for t in s]
        got = iter(torch.autograd.grad(
            losses, flat, grad_outputs=[torch.ones_like(x) for x in losses],
            allow_unused=True))
        grads = [[g if g is not None else torch.zeros_like(t)
                  for t, g in zip(s, got)] for s in live]
        return [x.detach() for x in ce], aux[0].detach(), grads

    def train_step(params, opt_state, batch):
        parts = {}
        for name in ("tokens", "targets", *EMBEDS):
            if batch.get(name) is None:
                continue
            x = batch[name]
            if not isinstance(x, SH.Shards):
                if name in EMBEDS:
                    x = _embed_rows(mesh, x, shape)
                elif tuple(x.shape) != (shape.global_batch, shape.seq_len):
                    raise ValueError(f"{name} {tuple(x.shape)} != "
                                     f"{(shape.global_batch, shape.seq_len)}")
                else:
                    x = SH.shard(mesh, x, batch_spec)
            if any(t.device.type != dev.type for t in x):
                raise ValueError(f"{name} off {dev}")
            parts[name] = x
        acc, loss, aux = None, None, 0.0
        for i in range(k):
            mb = {n: [t[i * rows:(i + 1) * rows] for t in x]
                  for n, x in parts.items()}
            l_i, a_i, g_i = micro_grads(params, mb.pop("tokens"),
                                        mb.pop("targets"), mb)
            aux = aux + a_i / k
            if not options.compress_grads:
                g_i = [sync(g, plan) for g, plan in zip(g_i, plans)]
            if k > 1:
                g_i = [_distinct(lambda a: a.float() / k, g) for g in g_i]
                acc = g_i if acc is None else [
                    _distinct(torch.add, a, g) for a, g in zip(acc, g_i)]
                loss = [x / k for x in l_i] if loss is None else [
                    a + x / k for a, x in zip(loss, l_i)]
            else:
                acc, loss = g_i, l_i
        residual = None
        if options.compress_grads:
            acc, residual = _compressed_sync(mesh, acc, opt_state["efb"],
                                             plans, p_specs, m_specs)
        grads_tree = _tree_of(params, acc)
        gn = sharded_global_norm(mesh, grads_tree, m_spec)
        new_p, mu, nu, step = _adamw_sharded(
            mesh, opt, params, acc, opt_state, p_specs, m_specs, gn)
        opt_state = {"mu": mu, "nu": nu, "step": step}
        if residual is not None:
            opt_state["efb"] = residual
        ce = TR.psum(mesh, loss, batch_axes)[0].to(dev)
        aux = aux.to(dev)
        metrics = {"ce": ce, "moe_aux": aux,
                   "loss": ce + options.aux_coef * aux,
                   "grad_norm": gn.to(dev)}
        return new_p, opt_state, metrics

    return train_step


# the model inputs beside the tokens: whisper's frames, pixtral's patches
EMBEDS = ("frame_embeds", "patch_embeds")


def _embed_rows(mesh, x, shape) -> SH.Shards:
    """Whole (B, n, d) embeddings as the ranks' rows, or ``Shards`` as
    they are."""
    if isinstance(x, SH.Shards):
        return x
    if x.shape[0] != shape.global_batch:
        raise ValueError(f"embeddings {tuple(x.shape)}: batch "
                         f"{shape.global_batch}")
    return SH.shard(mesh, x, SH.batch_spec(mesh, *x.shape))


def _tree_of(like, flat_lists) -> Any:
    """``like``'s structure with ``Shards`` of ``flat_lists`` (in leaf
    order) at its leaves."""
    it = iter(flat_lists)
    return tree_map(lambda _: SH.Shards(next(it)), like)


def _compressed_sync(mesh, acc, efb, plans, p_specs, m_specs):
    """Compress every rank's accumulated gradient with its residual, sum
    the bf16 payloads over each leaf's remaining axes
    (``compressed_allreduce``), and slice the result into the moment
    layout.  Returns (grads, residual tree)."""
    grads, res = [], []
    for g, r, plan, ps, ms in zip(acc, leaves(efb), plans, p_specs,
                                  m_specs):
        axes = tuple(a for _, ax, _ in plan for a in SH.entry_axes(ax))
        if axes:
            synced, r2 = compressed_allreduce(
                mesh, SH.Shards(g), SH.Shards(r), axis=axes, mean=False)
        else:
            q, r2 = zip(*(compress_grads(a, b) for a, b in zip(g, r)))
            synced = _distinct(lambda x: x.float(), list(q))
        out = []
        for rank, t in enumerate(synced):
            sub = tuple((i, n) if pe != me else (0, 1) for pe, me, (i, n)
                        in zip(ps, ms, SH.chunk_index(mesh, ms, rank)))
            out.append(SH.take(t, sub))
        grads.append(out)
        res.append(SH.Shards(r2))
    it = iter(res)
    return grads, tree_map(lambda _: next(it), efb)


def _adamw_sharded(mesh, opt, params, grads, opt_state, p_specs, m_specs,
                   gn):
    """AdamW on every distinct moment-layout shard once (clipped by the
    global norm ``gn``), written into the shards given (the step donates
    its parameters and moments, as the reference's jit does); ZeRO-1's
    shards all-gathered back to the parameters' layout.  Returns (params,
    mu, nu, step)."""
    fp, fg, fmu, fnu, owners = {}, {}, {}, {}, []
    for li, (p, g, mu, nu, ps, ms) in enumerate(zip(
            leaves(params), grads, leaves(opt_state["mu"]),
            leaves(opt_state["nu"]), p_specs, m_specs)):
        keys = []
        for r in range(mesh.size):
            idx = SH.chunk_index(mesh, ms, r)
            key = f"{li}/{idx}/{mesh.home(r)}"
            if key not in fp:
                sub = tuple((i, n) if pe != me else (0, 1)
                            for pe, me, (i, n) in zip(ps, ms, idx))
                fp[key], fg[key] = SH.take(p[r], sub), g[r]
                fmu[key], fnu[key] = mu[r], nu[r]
            keys.append(key)
        owners.append(keys)
    new_p, core, _ = adamw_update(
        opt, fp, fg, {"mu": fmu, "nu": fnu, "step": opt_state["step"]},
        grad_norm=gn, donate=True)
    out_p, out_mu, out_nu = [], [], []
    for keys, ps, ms in zip(owners, p_specs, m_specs):
        pl = [new_p[key] for key in keys]
        for dim, (pe, me) in enumerate(zip(ps, ms)):
            if pe != me:
                pl = TR.all_gather(mesh, pl, me, dim)
        out_p.append(SH.Shards(pl))
        out_mu.append(SH.Shards(core["mu"][key] for key in keys))
        out_nu.append(SH.Shards(core["nu"][key] for key in keys))
    return (_tree_of(params, out_p), _tree_of(params, out_mu),
            _tree_of(params, out_nu), core["step"])


# ---------------------------------------------------------------------------
# serving (prefill / decode)
# ---------------------------------------------------------------------------


def _serve_abstract(cfg, shape, mesh, options):
    """(params SDS, cache SDS, batch SDS, params specs, cache specs) of a
    serving step: parameters as ``abstract_state``'s without optimizer,
    the cache ``init_cache(global_batch, seq_len)`` by ``cache_specs``."""
    b = shape.global_batch
    c_shape = SH.cache_shapes(cfg, b, shape.seq_len)
    if mesh is None:
        return (sds_of(SH.param_shapes(cfg)), sds_of(c_shape),
                batch_sds(cfg, shape), None, None)
    p_shape, _, p_spec, _ = abstract_state(cfg, mesh, None, options)
    c_spec = SH.cache_specs(cfg, c_shape, mesh, batch=b)
    return (sds_of(p_shape, p_spec), sds_of(c_shape, c_spec),
            batch_sds(cfg, shape, mesh), p_spec, c_spec)


def init_sharded_cache(cfg: ArchConfig, mesh, batch: int,
                       max_len: int) -> Any:
    """A zero decode cache on the ranks, laid out by ``cache_specs``."""
    c_shape = SH.cache_shapes(cfg, batch, max_len)
    c_spec = SH.cache_specs(cfg, c_shape, mesh, batch=batch)
    return sds_zeros(mesh, sds_of(c_shape, c_spec))


def _serving_runtime(cfg, shape, options, dev, mesh, p_spec):
    check_supported(cfg, mesh)
    for d in mesh.devices:
        if d.type != dev.type:
            raise ValueError(f"a rank on {d}, the step on {dev}")
    # the tensor-parallel partials summed in f32 and rounded once, as one
    # device rounds each product once: bf16 partials flip near-tied MoE
    # choices, and a capacity dispatch spreads a flip over its row
    wide = None if T.model_dtype(cfg) == torch.float32 else torch.float32
    rules = SH.activation_rules(cfg, mesh, batch=shape.global_batch,
                                reduce_dtype=wide)
    return DecoderRuntime(cfg, mesh, p_spec, rules,
                          loss_chunk=options.loss_chunk,
                          max_len=shape.seq_len)


def _rows(mesh, x, shape, width: int) -> SH.Shards:
    """Whole (B, width) tokens as the ranks' rows, or ``Shards`` as they
    are."""
    if isinstance(x, SH.Shards):
        return x
    want = (shape.global_batch, width)
    if tuple(x.shape) != want:
        raise ValueError(f"tokens {tuple(x.shape)} != {want}")
    return SH.shard(mesh, x, SH.batch_spec(mesh, *want))


def build_prefill_step(cfg: ArchConfig, shape: ShapeConfig, *,
                       options: StepOptions = StepOptions(), device=None,
                       mesh=None):
    """Prefill a ``shape.seq_len``-deep cache from a whole prompt (the
    prefill_* cells).  Returns (``prefill_step(params, cache, batch) ->
    (logits, cache)``, (params SDS, cache SDS, batch SDS)); ``batch``
    holds ``tokens`` (B, S) and pixtral's / whisper's embeddings (on a
    mesh whole or as ``Shards`` of the ranks' rows)."""
    T.check_supported(cfg)
    dev = resolve_device(device)
    p_sds, c_sds, b_sds, p_spec, _ = _serve_abstract(cfg, shape, mesh,
                                                     options)
    if mesh is None:
        def prefill_step(params, cache, batch):
            return T.prefill(cfg, params, batch["tokens"], cache,
                             patch_embeds=batch.get("patch_embeds"),
                             frame_embeds=batch.get("frame_embeds"))

        return prefill_step, (p_sds, c_sds, b_sds)
    runtime = _serving_runtime(cfg, shape, options, dev, mesh, p_spec)

    def sharded_prefill_step(params, cache, batch):
        tokens = batch["tokens"]
        width = tokens[0].shape[1] if isinstance(tokens, SH.Shards) else (
            tokens.shape[1])
        embeds = {n: _embed_rows(mesh, batch[n], shape) for n in EMBEDS
                  if batch.get(n) is not None}
        logits = runtime.prefill(params, _rows(mesh, tokens, shape, width),
                                 cache, **embeds)
        return SH.Shards(logits), cache

    return sharded_prefill_step, (p_sds, c_sds, b_sds)


def build_serve_step(cfg: ArchConfig, shape: ShapeConfig, *,
                     options: StepOptions = StepOptions(), device=None,
                     mesh=None):
    """Decode one token against a ``shape.seq_len``-deep cache (the
    decode_* cells).  Returns (``serve_step(params, cache, tokens,
    position) -> (logits, cache)``, (params SDS, cache SDS, batch SDS));
    ``tokens`` (B, 1), ``position`` the fill level (on a mesh one int for
    every row)."""
    T.check_supported(cfg)
    dev = resolve_device(device)
    p_sds, c_sds, b_sds, p_spec, _ = _serve_abstract(cfg, shape, mesh,
                                                     options)
    if mesh is None:
        def serve_step(params, cache, tokens, position):
            return T.decode_step(cfg, params, tokens, cache, position)

        return serve_step, (p_sds, c_sds, b_sds)
    runtime = _serving_runtime(cfg, shape, options, dev, mesh, p_spec)

    def sharded_serve_step(params, cache, tokens, position):
        logits = runtime.decode(params, _rows(mesh, tokens, shape, 1), cache,
                                position)
        return SH.Shards(logits), cache

    return sharded_serve_step, (p_sds, c_sds, b_sds)


def step_bytes(cfg: ArchConfig, mesh, shape: ShapeConfig,
               options: StepOptions = StepOptions(),
               opt: AdamWConfig | None = None, *,
               frames: bool = True) -> float:
    """Bytes per rank one sharded step moves, counted from the specs and
    shapes alone (whisper's with frames through its encoder, unless not
    ``frames``): each microbatch's forward and backward
    (``DecoderRuntime.loss_bytes``) and its gradient reduction into the moment
    layout (a psum-scatter (n - 1) times its output, a psum 2 (n - 1) / n
    of its input), or under ``compress_grads`` one bf16 psum of each
    gradient; the loss's psum over the batch axes and the clipping norm's
    over the mesh (one f32 each); ZeRO-1's all-gather of the updated
    parameters ((n - 1) / n of each output)."""
    if opt is None:
        opt = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
    k = options.microbatch
    rules = _rules(cfg, mesh, shape, options)
    p_shape, _, p_spec, o_spec = abstract_state(cfg, mesh, opt, options)
    axes = dict(mesh.shape)
    batch_axes = _batch_names(mesh)
    n_batch = math.prod(axes[a] for a in batch_axes)
    runtime = DecoderRuntime(cfg, mesh, p_spec, rules, remat=options.remat,
                             loss_chunk=options.loss_chunk)
    total = k * runtime.loss_bytes(p_shape,
                                   rows=shape.global_batch // n_batch // k,
                                   seq=shape.seq_len, frames=frames)

    def size(entry):
        return math.prod(axes[a] for a in SH.entry_axes(entry))

    for leaf, ps, ms in zip(leaves(p_shape), leaves(p_spec),
                            leaves(o_spec["mu"])):
        item = torch.empty((), dtype=leaf.dtype).element_size()
        local = math.prod(leaf.shape) * item
        for e in ps:
            local /= size(e)
        plan = _sync_plan(ps, ms, batch_axes)
        if options.compress_grads:
            n = math.prod(size(ax) for _, ax, _ in plan)
            total += 2 * (n - 1) / n * local / item * 2
        else:
            g = local
            for op, ax, _ in plan:
                n = size(ax)
                if op == "scatter":
                    g /= n
                    total += k * (n - 1) * g
                else:
                    total += k * 2 * (n - 1) / n * g
        for pe, me in zip(ps, ms):
            if pe != me:
                n = size(me)
                total += (n - 1) / n * local
    n_all = mesh.size
    total += 2 * (n_batch - 1) / n_batch * 4 + 2 * (n_all - 1) / n_all * 4
    return total
