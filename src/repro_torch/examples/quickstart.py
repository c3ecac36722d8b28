"""Quickstart: distributed block-sparse matrix multiplication (the paper's
core operation) on a mesh of ranks, every communication engine.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks through: building block-sparse matrices (DBCSR-style block grid +
occupation mask + block norms), multiplying them with the Cannon/PTP
baseline, the one-sided OS1 analogue, the all-gather pull and the 2.5D
engine, with on-the-fly norm filtering — and verifies all engines agree
with the single-device result.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.config import resolve_device
from repro_torch.core import bsm as B
from repro_torch.core.engine import multiply, multiply_reference
from repro_torch.launch.mesh import make_spgemm_mesh

THRESHOLD = 1e-8
ERR_TOL = 1e-5  # every engine against the single-device oracle (f32)


def operands(device=None) -> tuple[B.BlockSparseMatrix, B.BlockSparseMatrix]:
    """A and B: H2O-DFT-LS-like operators, ~10% block occupancy with
    exponential decay."""
    return tuple(B.random_bsm(seed, nb=16, bs=16, occupancy=0.10,
                              pattern="decay", device=device)
                 for seed in (0, 1))


def _err(c, ref) -> float:
    return float((c.to_dense() - ref.to_dense()).abs().max())


def run(a: B.BlockSparseMatrix | None = None,
        b: B.BlockSparseMatrix | None = None, *, device=None) -> dict:
    """Multiply A and B (default ``operands()``) on every engine and
    layout, then filtered; returns the oracle, each product (``c``, keyed
    by engine / layout) with its max |err|, and the filtered product."""
    dev = resolve_device(device)
    if a is None or b is None:
        a, b = operands(dev)
    print(f"A: {a.shape} elements, occupancy {float(a.occupancy()):.1%}, "
          f"{int(a.nnz_blocks())} occupied blocks", flush=True)

    ref = multiply_reference(a, b, threshold=THRESHOLD)
    print(f"C=A*B fill-in: occupancy {float(ref.occupancy()):.1%}",
          flush=True)

    c, err = {}, {}
    # 2D engines on a 2x2 (r, c) grid
    mesh2d = make_spgemm_mesh(p=2, device=dev)
    for engine in ("cannon", "onesided", "gather"):
        c[engine] = multiply(a, b, mesh2d, engine=engine, threshold=THRESHOLD)
        err[engine] = _err(c[engine], ref)
        print(f"engine={engine:9s} grid=2x2    max|err| = {err[engine]:.2e}",
              flush=True)

    # the paper's 2.5D engine on an (L=2, 2, 2) mesh
    mesh25 = make_spgemm_mesh(p=2, l=2, device=dev)
    for layout in ("2d", "scatter"):
        key = f"twofive/{layout}"
        c[key] = multiply(a, b, mesh25, engine="twofive", threshold=THRESHOLD,
                          c_layout=layout)
        err[key] = _err(c[key], ref)
        print(f"engine=twofive   grid=2x2x2 c_layout={layout:7s} "
              f"max|err| = {err[key]:.2e}", flush=True)

    # on-the-fly filtering: an aggressive threshold drops small products
    c_filt = multiply(a, b, mesh25, engine="twofive", threshold=0.5,
                      filter_eps=0.05)
    print(f"filtered multiply: occupancy {float(c_filt.occupancy()):.1%} "
          f"(vs {float(ref.occupancy()):.1%} unfiltered)", flush=True)
    return dict(ref=ref, c=c, err=err, filtered=c_filt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch path)")
    args = ap.parse_args(argv)
    r = run(device=args.device)
    for key, e in r["err"].items():
        assert e < ERR_TOL, (key, e)
    print("quickstart OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
