"""The paper's Table 1 benchmark matrices, scaled to block-grid form — a
copy of the JAX package's ``configs/dbcsr_benchmarks.py`` (pure data).

Paper values:                      H2O-DFT-LS   S-E          Dense
  block size (n x n)               23           6            32
  rows/columns                     158,976      1,119,744    60,000
  occupancy                        7-15 %       0.04-0.06 %  100 %
  multiplications                  193          1198         10

The *occupancy and pattern* are kept at the block-grid level; the port
runs a block grid cut to one card (``chip_smoke.py``: H2O-DFT-LS at
nb = 512 blocks of 23, 11,776 rows).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MatrixBench:
    name: str
    block_size: int  # atomic block edge (paper Table 1)
    n_rows: int  # matrix dimension
    occupancy: float  # typical block occupancy
    pattern: str  # generator pattern (bsm.random_bsm)
    n_mults: int  # multiplications per application run
    flops: float  # paper-reported DBCSR FLOPs for the full run
    filter_eps: float = 1e-9


BENCHMARKS: dict[str, MatrixBench] = {
    "h2o_dft_ls": MatrixBench(
        name="H2O-DFT-LS",
        block_size=23,
        n_rows=158_976,
        occupancy=0.10,
        pattern="decay",
        n_mults=193,
        flops=4.038e15,
    ),
    "s_e": MatrixBench(
        name="S-E",
        block_size=6,
        n_rows=1_119_744,
        occupancy=5e-4,
        pattern="decay",
        n_mults=1198,
        flops=0.146e15,
    ),
    "dense": MatrixBench(
        name="Dense",
        block_size=32,
        n_rows=60_000,
        occupancy=1.0,
        pattern="dense",
        n_mults=10,
        flops=4.320e15,
    ),
}

# paper §4.1: measured average S_C / S_{A,B} panel-size ratios per benchmark
SC_OVER_SAB = {"h2o_dft_ls": 2.7, "s_e": 2.1, "dense": 1.0}

# strong-scaling node counts of Table 2
TABLE2_NODES = (200, 400, 729, 1296, 2704)
