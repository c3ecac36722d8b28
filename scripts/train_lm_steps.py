"""The example ``train_lm``'s loss trajectory on the card, and the fewest
steps at which its learning check passes.

    PYTHONPATH=src python scripts/train_lm_steps.py [--steps 200]

Runs ``repro_torch.examples.train_lm.run`` at its defaults (the
olmo-family model of 8 layers x d 768 on 2 x 2 ranks, seed 0) and prints
one JSON line: every step's loss and the fewest steps N whose run passes
the example's learning check, ``min(losses[:N][-10:]) < losses[0] - 1.0``.  The
optimizer's learning rate is constant, so an N-step run takes the first N
steps of this one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile

import torch

from repro_torch.examples import train_lm


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    with tempfile.TemporaryDirectory() as tmp:
        r = train_lm.run(steps=args.steps, ckpt_dir=tmp)
    losses = r["losses"]
    passes = [min(losses[:n][-10:]) < losses[0] - 1.0
              for n in range(1, len(losses) + 1)]
    print(json.dumps(dict(card=card.strip(), losses=losses,
                          fewest=passes.index(True) + 1 if any(passes)
                          else None, wall_s=r["wall_s"])))


if __name__ == "__main__":
    main()
