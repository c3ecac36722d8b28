"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout (``BENCHMARK.json`` beside ``perfbench/``
and the program under ``src/``).  It needs as many CUDA devices as the
cell asks for, and exits 2 without printing a result when they are not
there; it never falls back to the CPU.  The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each compared number beside its limit); the compared numbers are also the
last lines of standard error.  It exits 3 without a result when ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` was loaded.

Caches stay inside the checkout, at fixed paths under ``build/``: the
program's kernels (``build/kernels``), and Triton's, the CUDA driver's
and PyTorch's extension builds where anything uses them.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
# the package by its name, not this script's folder (which would shadow
# the standard library with the package's module names)
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "perfbench"]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from perfbench import harness

    bench = harness.load_bench(ROOT)
    work, _ = harness.cell(bench, args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < work["chips"]:
        print(f"run: {args.workload} needs {work['chips']} CUDA device(s), "
              f"found {have}; no result", file=sys.stderr)
        return 2
    line, checks = harness.run_cell(ROOT, args.workload, args.seed,
                                    args.seconds, bool(args.trace),
                                    device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run: modules of JAX or the JAX package were loaded: {bad}; "
              "no result", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for c in checks:
        print(c, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
