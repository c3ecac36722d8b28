"""AdamW with configurable moment dtype and global-norm clipping — the
twin of ``repro/optim/adamw.py``.

Plain functions of trees (nested dicts / lists of tensors) in and out.
The math is the reference's: update math in f32, moments stored in
``moment_dtype``, parameters kept in their own dtype with no master copy;
weight decay applies to every leaf; clipping scales the grads by
``min(1, clip / max(gn, 1e-9))`` cast to each grad's dtype.  Updates run
under ``torch.no_grad`` and return new tensors (the reference returns new
arrays), or with ``donate`` write them into the parameters and moments
given (the reference's train step donates them to its jit), so a step
holds one copy of its state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.optim.tree import leaves, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    moment_dtype: str = "float32"


def adamw_init(cfg: AdamWConfig, params: Any) -> dict[str, Any]:
    """Zero moments in ``moment_dtype`` on each leaf's device, step 0
    (int32, a 0-d tensor on the first leaf's device)."""
    dt = _DTYPES[cfg.moment_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    dev = leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    total = sum(torch.sum(torch.square(x.float())) for x in leaves(tree))
    return torch.sqrt(total)


@torch.no_grad()
def sharded_global_norm(mesh, grads: Any, specs: Any) -> torch.Tensor:
    """``global_norm`` of a gradient tree on a mesh of ranks (``Shards``
    leaves laid out by ``specs``): every rank sums the squares of the
    shards it is the first holder of — its coordinate 0 on every axis its
    leaf's spec does not name, so a replica counts once — and one psum
    over the whole mesh adds the ranks' sums.  Returns the norm on rank
    0's device."""
    from repro_torch.core import transport as TR

    names = mesh.axis_names
    local = [torch.zeros((), dtype=torch.float32, device=d)
             for d in mesh.devices]
    for g, spec in zip(leaves(grads), leaves(specs)):
        named = {a for e in spec if e is not None
                 for a in (e if isinstance(e, tuple) else (e,))}
        for r in range(mesh.size):
            if all(c == 0 for a, c in zip(names, mesh.coords(r))
                   if a not in named):
                local[r] = local[r] + torch.sum(torch.square(g[r].float()))
    return torch.sqrt(TR.psum(mesh, local, tuple(names))[0])


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params: Any,
    grads: Any,
    state: dict[str, Any],
    lr_scale: float | torch.Tensor = 1.0,
    *,
    grad_norm: torch.Tensor | None = None,
    donate: bool = False,
) -> tuple[Any, dict[str, Any], dict[str, torch.Tensor]]:
    """One update.  Returns (params, state, {"grad_norm"}).  ``grad_norm``
    is the norm to clip by when the trees hold only part of the gradient
    (a sharded step's shards: ``sharded_global_norm``); by default the
    trees' own ``global_norm``.  ``donate``: the new values are written
    into ``params`` and the moments, leaf by leaf, and those are
    returned."""
    step = state["step"] + 1
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9),
                            max=1.0)
        if not donate:  # the whole tree scaled first; donated, leaf by leaf
            grads = tree_map(lambda g: g * scale.to(g.device, g.dtype),
                             grads)
            scale = None
    s32 = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=s32.device), s32)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=s32.device), s32)
    lr = cfg.lr * lr_scale
    mdt = _DTYPES[cfg.moment_dtype]

    def upd(p, g, mu, nu):
        if scale is not None:
            g = g * scale.to(g.device, g.dtype)
        g32 = g.float()
        mu32 = mu.float() * cfg.b1 + g32 * (1 - cfg.b1)
        nu32 = nu.float() * cfg.b2 + torch.square(g32) * (1 - cfg.b2)
        mhat = mu32 / b1c.to(p.device)
        nhat = nu32 / b2c.to(p.device)
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        p_new = p.float() - lr * delta
        out = p_new.to(p.dtype), mu32.to(mdt), nu32.to(mdt)
        if not donate:
            return out
        for dst, src in zip((p, mu, nu), out):
            dst.copy_(src)
        return p, mu, nu

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    pick = lambda i: tree_map(lambda o: o[i], out)
    new_state = {"mu": pick(1), "nu": pick(2), "step": step}
    return pick(0), new_state, {"grad_norm": gn}
