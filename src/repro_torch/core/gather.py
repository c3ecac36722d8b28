"""All-gather ("pull from home") SpGEMM engine — the twin of
``repro/core/gather.py``.

Every rank pulls the A panels of its block row (gather along ``c``) and
the B panels of its block column (gather along ``r``) from their home
ranks — no pre-shift, 2D data layout retained — then runs one local
multiply.  The per-rank volume equals Cannon's, V (S_A + S_B) (Table 2's
PTP == OS1), in one collective pair instead of V ring hops.  Memory: the
full gathered row / column instead of double buffers.  Any (r, c) grid.
Under compressed transport each home shard is gathered packed and decoded
into its place (``transport.all_gather_panels``).
"""
from __future__ import annotations

from repro_torch.core import transport as T
from repro_torch.core.bsm import BlockSparseMatrix
from repro_torch.core.cannon import local_stage


def gather_body(
    plan,
    *,
    threshold: float = 0.0,
    backend: str = "dense",
    stack_capacity: int | None = None,
    transport: T.PanelTransport = T.DENSE,
    tile: tuple[int, int] | None = None,
):
    """The all-gather body over rank lists (shards in, C shards out)."""
    mesh, tr = plan.mesh, transport

    def body(ab, am, an, bb, bm, bn):
        del an, bn  # norms are not gathered (recomputed from the blocks)
        # pull the full block row of A / block column of B from home
        ga = T.all_gather_panels(mesh, tr, tr.cap_a, ab, am, "c", axis=1)
        gb = T.all_gather_panels(mesh, tr, tr.cap_b, bb, bm, "r", axis=0)
        return local_stage(ga, gb, threshold=threshold,
                           backend=backend, stack_capacity=stack_capacity,
                           tile=tile)

    return body


def multiply_gather(
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    mesh,
    *,
    threshold: float = 0.0,
    backend: str = "dense",
) -> BlockSparseMatrix:
    """Distributed C = A . B with the all-gather engine."""
    from repro_torch.core import plan as plan_mod

    return plan_mod.execute(a, b, mesh, "gather", threshold=threshold,
                            backend=backend)
