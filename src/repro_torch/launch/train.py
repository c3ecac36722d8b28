"""Training driver: checkpointed, resumable, straggler-aware — the twin of
``repro/launch/train.py``, on one device or on a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --reduced --steps 6 --seq-len 32 --global-batch 4 [--mesh 2x2]

Runs on CUDA unless ``--device cpu`` is given, and raises without a CUDA
device.  As in the reference:
  * auto-resume from the latest complete checkpoint (atomic, keep-k,
    ``--ckpt-dir`` / ``--ckpt-every``);
  * step-addressable data (a restart regenerates the exact stream);
  * a straggler watchdog (per-step wall clock against an EMA; a slow step
    is logged and checkpointed early);
  * SIGTERM asks for a checkpoint at the next step edge, then exit 0;
  * ``--compress-grads`` (bf16 payload, f32 error feedback), ``--remat``;
  * elastic restart: checkpoints carry the mesh, and a resume on another
    mesh re-shards to the current specs;
  * exit 1 on a non-finite loss, 0 otherwise.
Parameters are drawn on the device from ``--seed``
(``T.init_params(cfg, torch.Generator(device).manual_seed(seed))``); the
optimizer is AdamW at ``--lr`` with the arch's moment dtype.  ``--mesh
DxM`` / ``PxDxM`` (any size but 1) trains on a mesh of (pod,) data and
model ranks that all sit on the one device (``launch.steps``'s sharded
step, every family): the full tree is drawn once
from the seed and then
sharded, so a sharded run starts from a ``1x1`` run's parameters;
``--fsdp-axis``, ``--seq-parallel``, ``--head-2p5d``, ``--bf16-reduce``,
``--zero1`` and ``--microbatch`` set the step's options.  ``--layers N``
trains the arch's first N layers (``cut_depth``: a cut of the depth that
keeps the widths, for a card that cannot hold the AdamW state of all of
them).

``run(argv)`` returns what a caller measures: the losses, grad norms and
wall seconds of every step run, and the exit code; ``main`` returns the
exit code.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import ShapeConfig, resolve_device
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticLMData, make_global_batch
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.steps import (
    StepOptions,
    abstract_state,
    build_train_step,
    init_opt_state,
    init_sharded,
)
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig


class StragglerWatchdog:
    """EMA-based per-step wall-clock anomaly detector."""

    def __init__(self, factor: float = 3.0, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.ema: float | None = None
        self.events: list[tuple[int, float]] = []
        self._n = 0

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self._n += 1
        if self.ema is None:
            self.ema = dt
            return False
        slow = self._n > self.warmup and dt > self.factor * self.ema
        if slow:
            self.events.append((step, dt))
        # slow steps don't poison the EMA
        self.ema = 0.9 * self.ema + 0.1 * min(dt, self.factor * self.ema)
        return slow


def parse_mesh(spec: str, device) -> Mesh:
    """``DxM`` -> a (data, model) mesh, ``PxDxM`` -> (pod, data, model),
    every rank on ``device``."""
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) == 2:
        return make_mesh(dims, ("data", "model"), device)
    if len(dims) == 3:
        return make_mesh(dims, ("pod", "data", "model"), device)
    raise ValueError(f"mesh spec {spec!r}: want DxM or PxDxM")


def cut_depth(cfg, n_layers: int):
    """``cfg`` cut to its first ``n_layers`` layers: a whole number of
    layer patterns, or a hybrid's first attention layer and the mamba
    layers that follow it (jamba's first two: attention + MLP, then mamba
    + MoE), the pattern then ending at the cut."""
    import dataclasses

    if n_layers % cfg.layer_pattern_period == 0:
        return dataclasses.replace(cfg, n_layers=n_layers)
    cut = dataclasses.replace(cfg, n_layers=n_layers,
                              attn_layer_period=n_layers)
    if (cfg.mixer != "mamba_hybrid" or n_layers >= cfg.attn_layer_period
            or n_layers % cut.layer_pattern_period):
        raise ValueError(f"{cfg.name}: no cut to {n_layers} layers (a "
                         f"multiple of its {cfg.layer_pattern_period}-layer "
                         f"pattern, or a hybrid's first layers)")
    return cut


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--fsdp-axis", default="data",
                    help="data, pod,data or none")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--head-2p5d", action="store_true")
    ap.add_argument("--bf16-reduce", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None,
                    help="train the arch's first N layers (cut_depth)")
    return ap


def run(argv=None) -> dict:
    """Train as ``main`` does; returns {"rc", "start_step", "losses",
    "grad_norms", "moe_aux", "step_s"} (one entry per step run)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = cut_depth(cfg, args.layers)
    mesh = parse_mesh(args.mesh, dev)
    sharded = mesh.size > 1
    shape = ShapeConfig("train", args.seq_len, args.global_batch, "train")
    fsdp = {"none": None, "pod,data": ("pod", "data")}.get(args.fsdp_axis,
                                                          args.fsdp_axis)
    options = StepOptions(remat=args.remat, compress_grads=args.compress_grads,
                          loss_chunk=min(512, args.seq_len), fsdp_axis=fsdp,
                          seq_parallel=args.seq_parallel,
                          head_2p5d=args.head_2p5d,
                          bf16_reduce=args.bf16_reduce, zero1=args.zero1,
                          microbatch=args.microbatch)
    opt = AdamWConfig(lr=args.lr, moment_dtype=cfg.opt_state_dtype)
    step_fn = build_train_step(cfg, shape, opt=opt, options=options,
                               device=dev, mesh=mesh if sharded else None)

    # ---- init or resume -------------------------------------------------
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                           device=dev)
    specs = None
    if sharded:
        params, opt_state = init_sharded(cfg, mesh, params, opt, options)
        _, _, p_spec, o_spec = abstract_state(cfg, mesh, opt, options)
        specs = {"params": p_spec, "opt": o_spec}
    else:
        opt_state = init_opt_state(params, opt, options)
    mgr = (CheckpointManager(args.ckpt_dir, mesh=mesh, specs=specs)
           if args.ckpt_dir else None)
    start_step = 0
    if mgr is not None and mgr.latest() is not None:
        start_step, restored = mgr.restore_latest(
            {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        print(f"[train] resumed from step {start_step}", flush=True)

    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                      global_batch=args.global_batch,
                                      seed=args.seed))

    # ---- SIGTERM = checkpoint at the next step edge (preemption safety) --
    stop_requested = False

    def _on_term(signum, frame):
        nonlocal stop_requested
        stop_requested = True

    prev_handler = signal.signal(signal.SIGTERM, _on_term)
    out = {"rc": 0, "start_step": start_step, "losses": [], "grad_norms": [],
           "moe_aux": [], "step_s": []}
    try:
        watchdog = StragglerWatchdog()
        t_start = time.time()
        for step in range(start_step, args.steps):
            batch = make_global_batch(data, step, mesh if sharded else dev)
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])  # blocks; also the step boundary
            dt = time.time() - t0
            out["losses"].append(loss)
            out["grad_norms"].append(float(metrics["grad_norm"]))
            out["moe_aux"].append(float(metrics["moe_aux"]))
            out["step_s"].append(dt)
            if not np.isfinite(loss):
                print(f"[train] step {step}: NON-FINITE LOSS {loss}",
                      flush=True)
                out["rc"] = 1
                return out
            if watchdog.observe(step, dt):
                print(f"[train] step {step}: straggler ({dt:.2f}s vs EMA "
                      f"{watchdog.ema:.2f}s) — checkpointing early",
                      flush=True)
                if mgr is not None:
                    mgr.save(step + 1, {"params": params, "opt": opt_state})
            if step % args.log_every == 0:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f}ms", flush=True)
            if mgr is not None and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, {"params": params, "opt": opt_state})
            if stop_requested:
                print(f"[train] SIGTERM: checkpoint at step {step + 1} and "
                      "exit", flush=True)
                if mgr is not None:
                    mgr.save(step + 1, {"params": params, "opt": opt_state})
                return out
        if mgr is not None:
            mgr.save(args.steps, {"params": params, "opt": opt_state})
        dt = time.time() - t_start
        if out["losses"]:
            print(f"[train] done: {args.steps - start_step} steps in "
                  f"{dt:.1f}s; loss {out['losses'][0]:.4f} -> "
                  f"{out['losses'][-1]:.4f}; "
                  f"stragglers={len(watchdog.events)}", flush=True)
        return out
    finally:
        signal.signal(signal.SIGTERM, prev_handler)


def main(argv=None) -> int:
    return run(argv)["rc"]


if __name__ == "__main__":
    sys.exit(main())
