"""Purification: the port's entry point for the paper's workload.

    PYTHONPATH=src python -m repro_torch.launch.purify --device cpu --nb 8
    PYTHONPATH=src python -m repro_torch.launch.purify --device cpu --nb 8 \
        --p 2 --l 2

Builds a sparse model Hamiltonian H (``random_bsm``: decay pattern,
symmetric, from ``--seed``), runs ``density_matrix(H, mu=0)`` through the
fused sign iteration, and reports per purification: sweeps, the occupancy
trajectory, wall time, launches of the CUDA kernel, local multiplies,
trace(P), the number of eigenvalues of H below mu (``torch.linalg.
eigvalsh`` in float64 on the same device) and max |P^2 - P|.  Like the
reference's launcher it re-purifies a slightly scaled H ``--repeats`` times
(an SCF-like outer loop; the pattern repeats, so the sweep is reused).

``--p`` / ``--l`` select the SpGEMM mesh as in the reference's launcher
(``make_spgemm_mesh``; every rank on the one device): H is sharded once
and the chain runs sharded with ``--engine``, and the report adds the
mesh, the engine and the bytes the collectives moved per rank.  ``--p 1
--l 1`` (the default here, where the reference defaults to a 2 x 2 mesh of
fake host devices) is the single-device run.

Engine selection is tuned as in the reference: with ``--engine auto`` and
``--tuning-db PATH`` the tuner picks (engine, L) for H's pattern once per
chain (``tuner.autotune(..., chain=True)``), timing short trials on a cold
database, resolving by lookup on a warm one, and writing winners to the
file for the next launch; the tuner's counters are printed per repeat.
Without a database ``--engine auto`` falls back to ``twofive``: a service
loop should not re-measure on every start.  The reference's checks hold at
the end: one sweep program for the whole run and at most one tuner
decision that needed the model.

Exits 1 when |trace(P) - n_occ| exceeds ``TRACE_TOL`` in any repeat.
Runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
import time

# |trace(P) - #{eig < mu}|: trace(P) counts states, so an error of 1/2
# would miscount; 0.05 leaves room for f32 rounding over ~10^4 diagonal
# terms and still fails on one eigenvalue left unconverged near mu
TRACE_TOL = 0.05
MU = 0.0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nb", type=int, default=16, help="block-grid side")
    ap.add_argument("--bs", type=int, default=8, help="atomic block size")
    ap.add_argument("--p", type=int, default=1, help="(r, c) grid side")
    ap.add_argument("--l", type=int, default=1, help="2.5D depth (l axis)")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "cannon", "onesided", "gather",
                             "twofive"))
    ap.add_argument("--tuning-db", default=None,
                    help="tuning-database JSON path: with --engine auto, "
                    "the tuner picks the engine (warm-started when the file "
                    "exists, written after measuring)")
    ap.add_argument("--occupancy", type=float, default=0.10)
    ap.add_argument("--threshold", type=float, default=1e-9)
    ap.add_argument("--filter-eps", type=float, default=1e-8)
    ap.add_argument("--sync-every", type=int, default=4)
    ap.add_argument("--max-iter", type=int, default=100)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--repeats", type=int, default=3,
                    help="purifications of the (perturbed) Hamiltonian")
    ap.add_argument("--backend", default="auto",
                    choices=("dense", "stacks", "cuda", "auto"),
                    help="local multiply backend (auto: chosen once from "
                    "H.H's pattern)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch path)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def run(argv=None) -> dict:
    """Run the purifications and return the report (also printed)."""
    args = _parser().parse_args(argv)

    import torch

    from repro_torch import tuner
    from repro_torch.config import resolve_device
    from repro_torch.core import bsm as B
    from repro_torch.core import local_mm
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import transport as T
    from repro_torch.core.engine import choose_backend
    from repro_torch.core.signiter import density_matrix, trace
    from repro_torch.kernels import block_spgemm as kernel
    from repro_torch.launch.mesh import make_spgemm_mesh

    dev = resolve_device(args.device)
    mesh = None
    if (args.p, args.l) != (1, 1):
        mesh = make_spgemm_mesh(p=args.p, l=args.l, device=dev)
    engine = args.engine
    h = B.random_bsm(args.seed, nb=args.nb, bs=args.bs,
                     occupancy=args.occupancy, pattern="decay",
                     symmetric=True, device=dev)
    backend = args.backend
    if backend == "auto":
        backend = choose_backend(h, h, args.threshold)
    plan_mod.clear_cache()
    if engine == "auto":
        if args.tuning_db and mesh is not None:
            # after clear_cache, which unbinds the tuner's database
            tuner.set_default_db(args.tuning_db)
        else:
            # no database to consult or write: the static engine
            engine = "twofive"
    eig = torch.linalg.eigvalsh(h.to_dense().to(torch.float64))
    n_occ = int((eig < MU).sum())
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    where = "one device" if mesh is None else (
        f"mesh {dict(mesh.shape)} ({mesh.size} ranks), engine {engine}"
        + (f" (db {args.tuning_db})" if engine == "auto" else ""))
    print(f"purify: H {h.shape[0]}x{h.shape[1]} (nb={args.nb}, "
          f"bs={args.bs}, {float(h.occupancy()):.2%} blocks), device "
          f"{name}, {where}, backend {backend}, sync_every "
          f"{args.sync_every}, n_occ(eig<{MU})={n_occ}", flush=True)
    if mesh is not None:
        h = B.shard_bsm(h, mesh)  # the one chain-boundary scatter
    runs = []
    p = None
    for rep in range(args.repeats):
        launches0, calls0 = kernel.launches, local_mm.calls
        T.reset_bytes()
        _sync(dev)
        t0 = time.perf_counter()
        p, stats = density_matrix(
            h, MU, engine=engine, threshold=args.threshold,
            filter_eps=args.filter_eps, max_iter=args.max_iter, tol=args.tol,
            mode="fused", sync_every=args.sync_every, backend=backend,
        )
        tr = float(trace(p))
        _sync(dev)
        wall = time.perf_counter() - t0
        p = B.unshard_bsm(p)
        pd = p.to_dense().to(torch.float64)
        idem = float((pd @ pd - pd).abs().max())
        del pd
        r = dict(
            repeat=rep, iterations=stats.iterations,
            converged=stats.converged, residual=stats.residual,
            occupancy_trace=stats.occupancy_trace, wall_s=wall,
            launches=kernel.launches - launches0,
            local_multiplies=local_mm.calls - calls0,
            bytes_per_rank=T.bytes_moved(), trace=tr,
            trace_err=abs(tr - n_occ), idempotency=idem,
            chain=plan_mod.cache_stats(), engine=stats.engine, l=stats.l,
        )
        runs.append(r)
        occ = " ".join(f"{o:.3f}" for o in stats.occupancy_trace)
        cache = r["chain"]
        comm = "" if mesh is None else (
            f", {r['bytes_per_rank'] / stats.iterations:.6g} bytes per "
            f"rank per sweep, engine {stats.engine}"
            + ("" if stats.l is None else f" L={stats.l}")
            + f", tuner {cache['tuner_hits']}h/{cache['tuner_misses']}m/"
            f"{cache['tuner_trials']}t")
        print(f"  repeat {rep}: {stats.iterations} sweeps "
              f"({stats.host_syncs} syncs) in {wall:.3f}s, converged="
              f"{stats.converged}, residual={stats.residual:.3e}, kernel "
              f"launches={r['launches']}, local multiplies="
              f"{r['local_multiplies']}{comm}, trace(P)={tr:.4f} vs n_occ="
              f"{n_occ} (|err|={r['trace_err']:.2e}), max|P^2-P|="
              f"{idem:.2e}\n    occupancy: {occ}", flush=True)
        # SCF-like drift: the same pattern re-purified (the sweep is reused)
        scale = 1.0 + 1e-3 * (rep + 1)
        h = h.scale(scale) if mesh is not None else B.scale(h, scale)
    final = plan_mod.cache_stats()
    # one sweep program serves every repeat (PyTorch builds no other
    # program, so it is also the reference's bound on builds); one tuner
    # decision per pattern
    if not (final["chain_misses"] == 1 and final["tuner_misses"] <= 1):
        raise AssertionError(f"purify cache counters: {final}")
    ok = all(r["trace_err"] <= TRACE_TOL for r in runs)
    print(f"purify {'OK' if ok else 'FAILED'}: trace tolerance {TRACE_TOL}",
          flush=True)
    db = tuner.get_default_db()
    if db is not None and db.path:
        print(f"tuning db: {len(db)} record(s) at {db.path}", flush=True)
    return dict(ok=ok, device=name, backend=backend, n=h.shape[0],
                nb=args.nb, bs=args.bs, n_occ=n_occ, runs=runs,
                mesh=None if mesh is None else dict(mesh.shape),
                ranks=1 if mesh is None else mesh.size,
                engine=runs[-1]["engine"] if runs else engine, tuner=final,
                p=p)


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
