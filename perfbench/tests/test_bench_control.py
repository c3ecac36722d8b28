"""The controls at a size a test run holds: the plain reference put in
the program's place one precision step down (float8 e4m3 for the
bfloat16 model, TF32 products for the f32 purification, rounded as the
tensor cores read them) fails a compared number on every seed, where the
program passes them all.  On the chip the same runs are made at each
cell's own size by ``perfbench/control.py``."""
from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.tests import tiny

CELLS = {"h2o-dft-ls.scf": (tiny.h2o, tiny.SCF),
         "deepseek-moe-16b.decode": (tiny.moe, tiny.DECODE),
         "deepseek-moe-16b.prefill": (tiny.moe, tiny.ROUNDS)}


@pytest.mark.parametrize("seed", [21, 22, 2 ** 31 + 23])
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails_where_the_program_passes(workload, seed):
    cfg, traffic = CELLS[workload]
    line, _ = harness.run_cell(tiny.ROOT, workload, seed, 0.4, False,
                               device="cpu", cfg=cfg(), traffic=dict(traffic),
                               control=True)
    assert line["correct"] is True, line["checks"]
    limits = {k: c["limit"] for k, c in line["checks"].items()}
    failed = [k for k in limits if line["control"][k] > limits[k]]
    assert failed, (line["control"], limits)
