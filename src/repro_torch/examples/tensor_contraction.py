"""Blocked sparse tensor contraction: einsum onto the SpGEMM stack.

    PYTHONPATH=src python -m repro_torch.examples.tensor_contraction \
        [--device cpu]

Walks through the tensor layer (``core.tensor``): building a screened
3-index integral tensor (ij|k), contracting it against a 2-index operator
with ``contract("ijk,kl->ijl")`` — which matricizes both operands onto a
tall-skinny block-sparse matrix product and runs the ordinary distributed
SpGEMM, with ``engine="auto"`` letting the tuner pick engine, depth and
backend (on a card the block-SpGEMM kernel, where it wins its trial) and
persist its decision in a tuning database — then keeps a two-step
contraction chain on the ranks end to end with ``shard_tensor``.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from repro_torch import tuner
from repro_torch.config import resolve_device
from repro_torch.core import plan as plan_mod
from repro_torch.core import tensor as T
from repro_torch.core.bsm import host_array
from repro_torch.kernels import block_spgemm as K
from repro_torch.launch.mesh import make_spgemm_mesh

ERR_TOL = 1e-5  # f32 against the float64 einsum, relative to its largest


def operands(device=None) -> tuple:
    """The screened three-center tensor (ij|k) — occupation decays with
    the spread of the block coordinates, ~10% of blocks survive — and two
    2-index operators."""
    t = T.random_tensor(0, nbs=(8, 8, 8), bss=8, occupancy=0.10,
                        pattern="decay", device=device)
    op, op2 = (T.random_tensor(seed, nbs=(8, 8), bss=8, occupancy=0.3,
                               pattern="decay", device=device)
               for seed in (1, 2))
    return t, op, op2


def run(t=None, op=None, op2=None, *, tuning_db: str | None = None,
        device=None) -> dict:
    """The single contraction under ``engine="auto"`` and the two-step
    sharded chain, against ``contract_reference``.  ``tuning_db``: the
    database the tuner reads and writes (default: a fresh temporary one).
    Returns both results, their errors, the tuner's counters and the
    block-SpGEMM launches."""
    dev = resolve_device(device)
    if t is None:
        t, op, op2 = operands(dev)
    print(f"T: shape {t.shape}, {int(t.nnz_blocks())} of "
          f"{np.prod(t.nbs)} blocks occupied "
          f"({float(t.occupancy()):.1%})", flush=True)

    # the contraction is a matricized SpGEMM: (ij | k) x (k | l) — a
    # (64, 8) x (8, 8) tall-skinny block matrix product underneath
    mesh = make_spgemm_mesh(p=2, device=dev)
    launches0 = K.launches
    with tempfile.TemporaryDirectory() as tmp:
        # engine="auto": the tuner measures candidates once, persists the
        # winner, and every later contraction of this pattern resolves
        # from the database without timing anything
        plan_mod.clear_cache()
        tuner.set_default_db(tuning_db
                             or os.path.join(tmp, "tuning_db.json"))
        c = T.contract("ijk,kl->ijl", t, op, mesh=mesh, engine="auto",
                       threshold=1e-8)
        ref = T.contract_reference("ijk,kl->ijl", t, op)
        err = float(np.abs(host_array(c.to_dense()) - ref).max())
        print(f"contract('ijk,kl->ijl') on 2x2 mesh: max|err| = {err:.2e}",
              flush=True)

        # chain two contractions on the ranks: shard once, contract twice,
        # gather once — the intermediate never leaves the ranks
        st = T.shard_tensor(t, mesh, row_axes=(0, 1), col_axes=(2,))
        s1 = T.shard_tensor(op, mesh, row_axes=(0,), col_axes=(1,))
        s2 = T.shard_tensor(op2, mesh, row_axes=(0,), col_axes=(1,))
        mid = T.contract("ijk,kl->ijl", st, s1, mesh=mesh, engine="auto")
        print(f"intermediate stays sharded: {mid}", flush=True)
        fin = T.contract("ijl,lm->ijm", mid, s2, mesh=mesh, engine="auto")
        chain_ref = T.contract_reference("ijk,kl,lm->ijm", t, op, op2)
        chain = fin.to_tensor()
        chain_err = float(np.abs(host_array(chain.to_dense())
                                 - chain_ref).max())
        print(f"two-step sharded chain:       max|err| = {chain_err:.2e}",
              flush=True)
        cache = plan_mod.cache_stats()
        tuner.set_default_db(None)  # the temporary file goes with tmp
    return dict(c=c, ref=ref, err=err, mid=mid, chain=chain,
                chain_ref=chain_ref, chain_err=chain_err,
                tuner_trials=cache["tuner_trials"],
                tuner_hits=cache["tuner_hits"],
                tuner_misses=cache["tuner_misses"],
                launches=K.launches - launches0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch path)")
    args = ap.parse_args(argv)
    r = run(device=args.device)
    print(f"tuner: {r['tuner_trials']} trial(s), {r['tuner_hits']} db/cache "
          f"hit(s); block-SpGEMM kernel launches {r['launches']}")
    for e, want in ((r["err"], r["ref"]), (r["chain_err"], r["chain_ref"])):
        assert e < ERR_TOL * max(1.0, float(np.abs(want).max())), e
    assert r["mid"].sharded
    print("tensor_contraction OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
