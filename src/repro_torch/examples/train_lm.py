"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \
        [--seq-len 128] [--global-batch 16] [--device cpu]

Uses the public API end to end: arch config (olmo-1b family scaled to
~100M params), synthetic Zipf+Markov data pipeline, AdamW, checkpointing,
on a (2, 2) data x model mesh of ranks (``launch.mesh``, every rank on
the one device) — the sharded step the production launcher
(``repro_torch.launch.train --mesh``) runs: tensor parallelism over
``model``, FSDP over ``data``.  On a card attention runs the flash kernel
forward (twice a step: remat recomputes it) and backward on every rank's
local heads.  Asserts the loss actually drops below the unigram entropy
floor's neighbourhood.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import ShapeConfig, resolve_device
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticLMData, make_global_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (
    StepOptions,
    abstract_state,
    build_train_step,
    init_sharded,
)
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig
from repro_torch.optim.tree import leaves
from repro_torch.parallel.sharding import batch_spec


def config():
    """~100M params: the olmo family at 8 layers x d 768, f32."""
    return dataclasses.replace(
        get_arch("olmo-1b"), n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=12, d_ff=3072, vocab=32768, dtype="float32",
    )


def run(cfg=None, *, steps: int = 200, seq_len: int = 128,
        global_batch: int = 16, params=None, ckpt_dir: str | None = None,
        device=None) -> dict:
    """Train ``cfg`` (default ``config()``) for ``steps`` steps on the 2 x 2
    mesh from ``params`` (a full one-device tree; default drawn from seed
    0), checkpointing every 100 steps and at the end into ``ckpt_dir``
    (default a fresh temporary directory).  Returns the losses, grad
    norms, wall seconds, tokens/s, the checkpoint directory and its latest
    step."""
    dev = resolve_device(device)
    cfg = config() if cfg is None else cfg
    mesh = make_mesh((2, 2), ("data", "model"), dev)
    shape = ShapeConfig("train", seq_len, global_batch, "train")
    options = StepOptions(remat="full", loss_chunk=seq_len)
    opt = AdamWConfig(lr=3e-4, weight_decay=0.01)

    step_fn = build_train_step(cfg, shape, opt=opt, options=options,
                               device=dev, mesh=mesh)
    if params is None:
        params = T.init_params(cfg, torch.Generator(dev).manual_seed(0),
                               device=dev)
    n_params = sum(x.numel() for x in leaves(params))
    params, opt_state = init_sharded(cfg, mesh, params, opt, options)
    _, _, p_spec, o_spec = abstract_state(cfg, mesh, opt, options)
    print(f"model: {n_params/1e6:.1f}M params on mesh {dict(mesh.shape)}",
          flush=True)

    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                      global_batch=global_batch))
    spec = batch_spec(mesh, global_batch, seq_len)

    if ckpt_dir is None:
        ckpt_dir = tempfile.mkdtemp(prefix="train_lm_")
    mgr = CheckpointManager(ckpt_dir, keep=2, mesh=mesh,
                            specs={"params": p_spec, "opt": o_spec})

    losses, grad_norms = [], []
    t0 = time.time()
    for step in range(steps):
        batch = make_global_batch(data, step, mesh, spec)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
        if step % 25 == 0:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"gnorm {grad_norms[-1]:.2f}", flush=True)
        if (step + 1) % 100 == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state})
    mgr.save(steps, {"params": params, "opt": opt_state})
    dt = time.time() - t0
    return dict(losses=losses, grad_norms=grad_norms, wall_s=dt,
                tokens_s=steps * global_batch * seq_len / dt,
                ckpt_dir=ckpt_dir, latest=mgr.latest(), n_params=n_params,
                n_layers=cfg.n_layers, ranks=mesh.size)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch path)")
    args = ap.parse_args(argv)
    r = run(steps=args.steps, seq_len=args.seq_len,
            global_batch=args.global_batch, device=args.device)
    losses = r["losses"]
    print(f"{args.steps} steps in {r['wall_s']:.0f}s "
          f"({r['tokens_s']:.0f} tok/s)")
    print(f"loss: {losses[0]:.4f} -> {min(losses[-10:]):.4f}")
    assert min(losses[-10:]) < losses[0] - 1.0, "model failed to learn"
    print(f"checkpoints in {r['ckpt_dir']}: latest step {r['latest']}")
    print("train_lm OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
