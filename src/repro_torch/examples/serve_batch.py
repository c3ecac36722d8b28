"""Example: batched serving with prefill + decode against a KV cache.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch \
        [--tuning-db tuning_db.json] [--device cpu]

Drives the ``ServingEngine`` (slot-based batching, greedy + temperature
sampling, EOS early-exit) with a reduced qwen-family model, and verifies
decode consistency: the engine's greedy continuation equals teacher-forced
argmax over a full forward pass.  ``--tuning-db`` binds the tuner database
(as ``repro_torch.launch.serve`` does) so any dispatch decisions resolved
during the run persist; without it the static analytic fallback decides.
On a card the prefill runs the flash-attention kernel once per layer, as
does the teacher-forced forward.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import tuner
from repro_torch.config import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core import plan as plan_mod
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.engine import GenerationConfig, ServingEngine


def config():
    """The reduced qwen1.5-4b: 2 layers, d 128, 4 heads of 32, f32."""
    return get_arch("qwen1.5-4b").reduced()


def prompts(vocab: int) -> list[np.ndarray]:
    """Four 16-token prompts from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=16).astype(np.int32)
            for _ in range(4)]


def run(params=None, *, tuning_db: str | None = None, device=None) -> dict:
    """Serve ``prompts()`` greedily (12 new tokens each) with ``params``
    (default: drawn from seed 0), then the teacher-forced check on
    request 0.  Returns the outputs, the teacher-forced argmax, the match
    count, the wall seconds and the flash launches of the generation and
    of the forward."""
    dev = resolve_device(device)
    if tuning_db:
        plan_mod.clear_cache()
        tuner.set_default_db(tuning_db)
    cfg = config()
    if params is None:
        params = T.init_params(cfg, torch.Generator(dev).manual_seed(0),
                               device=dev)
    engine = ServingEngine(
        cfg, params, batch=4, max_len=128,
        gen=GenerationConfig(max_new_tokens=12, temperature=0.0),
    )
    reqs = prompts(cfg.vocab)

    launches0 = FA.launches
    t0 = time.time()
    outs = engine.generate(reqs)
    dt = time.time() - t0
    gen_launches = FA.launches - launches0
    print(f"4 requests x 12 tokens in {dt:.1f}s", flush=True)
    for i, o in enumerate(outs):
        print(f"  req{i}: {o}", flush=True)

    # consistency oracle: greedy engine output == teacher-forced argmax.
    # ``forward`` ends with the final norm; the second one is the JAX
    # package's example's own (idempotent for rmsnorm up to its eps)
    full = np.concatenate([reqs[0], np.asarray(outs[0][:-1], np.int32)])
    launches0 = FA.launches
    with torch.no_grad():
        x, _ = T.forward(cfg, params, torch.from_numpy(full[None]).to(
            dev, torch.long))
        logits = L.logits_matmul(
            cfg, params["embed"], L.apply_norm(cfg, params["final_norm"], x))
    fwd_launches = FA.launches - launches0
    greedy = torch.argmax(logits[0, len(reqs[0]) - 1:], -1).cpu().numpy()
    match = int((greedy[: len(outs[0])] == np.asarray(outs[0])).sum())
    print(f"teacher-forced consistency: {match}/{len(outs[0])} tokens match",
          flush=True)
    return dict(outs=outs, greedy=greedy, match=match, wall_s=dt,
                gen_launches=gen_launches, fwd_launches=fwd_launches,
                n_layers=cfg.n_layers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tuning-db", default=None,
                    help="tuning database path (omitted = static fallback)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch path)")
    args = ap.parse_args(argv)
    r = run(tuning_db=args.tuning_db, device=args.device)
    assert r["match"] >= len(r["outs"][0]) - 1  # one borderline tie flip
    print("serve_batch OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
