"""The training step — the twin of ``repro/launch/steps.py``'s
``build_train_step`` on one device.

``StepOptions`` holds the reference's options that act on one device,
with its defaults: ``remat``, ``loss_chunk``, ``aux_coef``,
``microbatch`` and ``compress_grads``.  The reference's sharding options
(``fsdp_axis``, ``seq_parallel``, ``head_2p5d``, ``bf16_reduce``,
``zero1``) come with sharded training, ROADMAP.md Queue A item 15b;
``build_serve_step`` / ``build_prefill_step`` of the dry run are item
16 (the port serves through ``serving/engine.py``).

The step: gradients of ``transformer.loss_fn`` by autograd (in the
parameters' dtype), or with ``microbatch = k`` the mean over k row slices
of the batch in f32 accumulators (g / k added per slice, loss, ce and aux
averaged the same way); with ``compress_grads`` the bf16 payload and its
f32 residual (``opt_state["efb"]``), cast back to f32; then one AdamW
update.  Metrics: ``loss``, ``ce``, ``moe_aux``, ``grad_norm``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.config import ArchConfig, ShapeConfig, resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    compress_grads,
    init_compress_state,
)
from repro_torch.optim.tree import leaves, tree_map


@dataclass(frozen=True)
class StepOptions:
    remat: str = "dots"  # none | full | dots
    loss_chunk: int = 1024
    compress_grads: bool = False
    microbatch: int = 1  # gradient-accumulation steps
    aux_coef: float = 0.01


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


def build_train_step(cfg: ArchConfig, shape: ShapeConfig, *,
                     opt: AdamWConfig | None = None,
                     options: StepOptions = StepOptions(),
                     device=None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` for batches of ``shape`` (``tokens`` / ``targets`` (B, S)
    on ``device``, CUDA unless asked otherwise).  ``opt`` defaults to
    AdamW with the arch's moment dtype; ``opt_state`` comes from
    ``init_opt_state``."""
    if opt is None:
        opt = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
    T.check_supported(cfg)
    dev = resolve_device(device)
    k = options.microbatch
    if k < 1 or shape.global_batch % k:
        raise ValueError(f"microbatch {k} must divide the global batch "
                         f"{shape.global_batch}")
    if options.remat not in T.REMAT:
        raise ValueError(f"remat {options.remat!r}: one of {T.REMAT}")

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
