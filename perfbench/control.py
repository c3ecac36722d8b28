"""The controls of ``correct``: each cell's comparison run with the plain
reference put in the program's place one precision step down, on the
program's own run of the same seed, so that the two readings of every
compared number come from one process.

    python3 perfbench/control.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed it runs the cell once (window ``--seconds``) and prints one
JSON line: the seed, the program's readings (``checks``) and the
control's (``control``).  A served model's control is the reference in
float8 e4m3 reading the gap of its own first choice at every checked
position; a density matrix's is the dense sign iteration in TF32.  The
benchmark's runs never run it.  Needs the cell's CUDA devices, as
``run.py`` does.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import run  # noqa: F401  (caches and import paths, as for a run)
from run import ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dump", default=None,
                    help="also write each seed's full readings (per-token "
                    "gaps) as JSON lines to this file")
    args = ap.parse_args(argv)
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device; no result", file=sys.stderr)
        return 2
    for seed in args.seeds:
        line, lines = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                                   False, device="cuda", control=True)
        ctl = line["control"]
        brief = {k: v for k, v in ctl.items()
                 if not isinstance(v, (list, dict))}
        print(json.dumps({"seed": seed, "correct": line["correct"],
                          "checks": line["checks"], "control": brief,
                          "metrics": line["metrics"]}), flush=True)
        if args.dump:
            with open(args.dump, "a") as f:
                f.write(json.dumps({"seed": seed, "control": ctl}) + "\n")
        print("\n".join(lines), file=sys.stderr, flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
