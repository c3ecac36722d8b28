#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``), one GPU.

    python3 chip_smoke.py

Phases, each raising on failure:

1. the device (name, and name / power limit from nvidia-smi) and the
   kernel build (``nvcc`` into ``build/kernels/``), with its seconds;
2. the CUDA kernel against its plain PyTorch version and the ``ref``
   oracle on the card, over block shapes, f32 / bf16, occupancy and the
   on-the-fly threshold (capacity 0 included);
3. a full-width multiply, ``engine.multiply(H, H, backend="cuda")`` at
   nb = 512, bs = 23, occupancy 0.10 decay (the paper's H2O-DFT-LS blocks
   and occupancy, cut to one card), checked against the plain version;
   kernel, plain and library (dense ``torch.matmul``) times and the bound;
   then the kernel alone on a full 512^3 product list (the later sweeps);
4. the full-width purification through ``repro_torch.launch.purify``,
   with the kernel's launch count set to 0 just before and read just
   after: sweeps, occupancy trajectory, wall time, launches, trace(P)
   against the float64 eigenvalue count, max |P^2 - P|.

Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2
and prints no result.  Imports nothing of jax or of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

NB, BS, OCC, SEED = 512, 23, 0.10, 0
THRESHOLD, FILTER_EPS = 1e-9, 1e-8
# published H100 SXM peaks (data sheet, 700 W): f32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# kernel vs plain / oracle: f32 up to summation order; bf16 one output
# rounding of unit-scaled blocks (the reference's _DTYPE_TOL)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
IDEMPOTENCY_TOL = 1e-3  # max |P^2 - P|, as the reference's own test


def _time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _close(got, want, tol: float) -> tuple[bool, float]:
    d = (got.float() - want.float()).abs()
    if d.numel() == 0:
        return True, 0.0
    ok = bool((d <= tol + tol * want.float().abs()).all())
    return ok, float(d.max())


def _bound(ok, bs: int, itemsize: int) -> tuple[float, str]:
    """Least time for this product list: its f32 FMAs at the f32 peak, or
    each used operand block read once and each non-empty output tile
    written once at the memory rate, whichever is larger."""
    n = int(ok.sum())
    flops = 2.0 * n * bs**3
    blocks = int(ok.any(2).sum() + ok.any(0).sum() + ok.any(1).sum())
    t_ops = flops / PEAK_F32_FLOPS
    t_bytes = blocks * bs * bs * itemsize / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_kernel_vs_plain(torch, np, K, S, ref, lm, B) -> float:
    """Phase 2: kernel against plain version and oracle; returns max err."""
    rng = np.random.default_rng(SEED)
    ni, nk, nj = 5, 6, 4
    worst, cases, bad = 0.0, 0, []
    for shape in ((4, 4, 4), (8, 8, 8), (23, 23, 23), (64, 64, 64),
                  (128, 128, 128), (4, 16, 8)):
        bs_r, bs_k, bs_c = shape
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            for occ in (0.0, 0.05, 0.3, 1.0):
                for thr in (0.0, 0.05):
                    a = rng.standard_normal((ni, nk, bs_r, bs_k)) / np.sqrt(bs_k)
                    b = rng.standard_normal((nk, nj, bs_k, bs_c)) / np.sqrt(bs_k)
                    am = torch.from_numpy(rng.random((ni, nk)) < occ).cuda()
                    bm = torch.from_numpy(rng.random((nk, nj)) < occ).cuda()
                    ta = torch.from_numpy(a.astype(np.float32)).cuda().to(dt)
                    tb = torch.from_numpy(b.astype(np.float32)).cuda().to(dt)
                    ta = ta * am[:, :, None, None].to(dt)
                    tb = tb * bm[:, :, None, None].to(dt)
                    ok = lm.pair_filter(am, B.block_norms(ta), bm,
                                        B.block_norms(tb), thr)
                    n = S.product_count(ok)
                    stacks = S.compact_pair_mask(
                        ok, capacity=S.bucket_capacity(n))
                    before = K.launches
                    got = K.block_spgemm_stacks(ta, tb, stacks, ni=ni, nj=nj)
                    if K.launches != before + (1 if n else 0):
                        bad.append((shape, dtype, occ, thr, "no launch"))
                    plain = K.block_spgemm_stacks_plain(ta, tb, stacks,
                                                        ni=ni, nj=nj)
                    oracle = ref.block_spgemm_ref(ta, tb, ok)
                    for want in (plain, oracle):
                        good, err = _close(got, want, TOL[dtype])
                        worst = max(worst, err)
                        if not good:
                            bad.append((shape, dtype, occ, thr, err))
                    cases += 1
    torch.cuda.synchronize()
    print(f"[2] kernel vs plain and oracle: {cases} cases, max |err| "
          f"{worst:.3e}, tolerances {TOL}", flush=True)
    if bad:
        raise AssertionError(f"kernel disagrees: {bad}")
    return worst


def phase_full_width_multiply(torch, K, S, B, E, plan) -> dict:
    """Phase 3: engine.multiply at full width, checked and timed."""
    h = B.random_bsm(SEED, nb=NB, bs=BS, occupancy=OCC, pattern="decay",
                     symmetric=True, device="cuda")
    plan.clear_cache()
    c = E.multiply(h, h, backend="cuda", threshold=THRESHOLD,
                   filter_eps=FILTER_EPS)
    ok = S.pair_cube(h.mask, h.mask, h.norms, h.norms, THRESHOLD)
    stacks, n = plan.get_product_stacks(ok)  # the multiply's cached list
    runs = K.tile_runs(stacks)

    def kernel():
        return K.block_spgemm_runs(h.blocks, h.blocks, stacks.ik, runs,
                                   ni=NB, nj=NB)

    def plain():
        return K.block_spgemm_stacks_plain(h.blocks, h.blocks, stacks,
                                           ni=NB, nj=NB)

    ck, cp = kernel(), plain()
    good, err = _close(ck, cp, TOL["float32"])
    if not good:
        raise AssertionError(f"full-width kernel vs plain: max |err| {err}")
    cm = ok.any(1)
    want = B.filter_bsm(B.make_bsm(cp, cm), FILTER_EPS)
    good_c, err_c = _close(c.blocks, want.blocks, TOL["float32"])
    if not (good_c and torch.equal(c.mask, want.mask)):
        raise AssertionError(f"multiply result vs plain: max |err| {err_c}")
    del ck, cp, want
    ms = _time_ms(kernel, reps=7, warmup=2)
    plain_ms = _time_ms(plain, reps=5, warmup=1)
    dense = h.to_dense()
    library_ms = _time_ms(lambda: torch.matmul(dense, dense), reps=5,
                          warmup=1)
    bound_ms, bound_by = _bound(ok, BS, 4)
    occ = float(h.occupancy())
    tiles = int(cm.sum())
    print(f"[3] multiply H.H: n={NB * BS}, H occupancy {occ:.4f}, products "
          f"{n} ({n / NB**3:.2%} of the cube), output tiles {tiles}, "
          f"C occupancy {float(c.occupancy()):.4f}; kernel vs plain max "
          f"|err| {err:.3e}", flush=True)
    print(f"[3] times (ms, median of CUDA events): kernel {ms:.4f}  plain "
          f"{plain_ms:.4f}  library(torch.matmul dense f32) {library_ms:.4f} "
          f" bound {bound_ms:.4f} ({bound_by}); kernel "
          f"{2.0 * n * BS**3 / ms / 1e9:.3f} TFLOP/s", flush=True)
    del dense, stacks, runs, c, ok
    # the later sweeps: X fills to 100 %, the full 512^3 list
    x = B.random_bsm(SEED + 1, nb=NB, bs=BS, pattern="dense", device="cuda")

    def list_build():
        # what each multiply does before the kernel: filter cube, count,
        # compaction and tile runs (three host syncs)
        ok = S.pair_cube(x.mask, x.mask, x.norms, x.norms, THRESHOLD)
        st = S.compact_pair_mask(
            ok, capacity=S.bucket_capacity(S.product_count(ok)))
        return ok, st, K.tile_runs(st)

    ok_full, st_full, runs_full = list_build()
    n_full = int(st_full.valid.sum())
    build_ms = _time_ms(list_build, reps=3)
    full_ms = _time_ms(lambda: K.block_spgemm_runs(
        x.blocks, x.blocks, st_full.ik, runs_full, ni=NB, nj=NB), reps=3)
    full_bound_ms, full_by = _bound(ok_full, BS, 4)
    print(f"[3] full fill: products {n_full}, list build {build_ms:.4f} ms, "
          f"kernel {full_ms:.4f} ms, bound {full_bound_ms:.4f} ({full_by}), "
          f"{2.0 * n_full * BS**3 / full_ms / 1e9:.3f} TFLOP/s", flush=True)
    del x, ok_full, st_full, runs_full
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_purify(torch, K, purify) -> int:
    """Phase 4: the main path, through the user's entry point."""
    argv = ["--nb", str(NB), "--bs", str(BS), "--occupancy", str(OCC),
            "--threshold", str(THRESHOLD), "--filter-eps", str(FILTER_EPS),
            "--max-iter", "100", "--tol", "1e-6", "--sync-every", "4",
            "--backend", "cuda", "--repeats", "1", "--seed", str(SEED)]
    torch.cuda.reset_peak_memory_stats()
    K.launches = 0
    report = purify.run(argv)
    launches = K.launches
    r = report["runs"][0]
    print(f"[4] purification: {r['iterations']} sweeps, converged "
          f"{r['converged']}, wall {r['wall_s']:.3f} s, kernel launches "
          f"{launches}, trace(P) {r['trace']:.4f} vs eigenvalue count "
          f"{report['n_occ']} (|err| {r['trace_err']:.3e}, tolerance "
          f"{purify.TRACE_TOL}), max|P^2-P| {r['idempotency']:.3e}, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    if launches == 0:
        raise AssertionError("the purification never launched the kernel")
    if not (report["ok"] and r["converged"]):
        raise AssertionError(f"purification failed: {r}")
    if r["idempotency"] > IDEMPOTENCY_TOL:
        raise AssertionError(f"P is no projector: {r['idempotency']}")
    return launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import bsm as B
    from repro_torch.core import engine as E
    from repro_torch.core import local_mm as lm
    from repro_torch.core import plan
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import block_spgemm as K
    from repro_torch.kernels import stacks as S
    from repro_torch.launch import purify

    # full f32 in every matmul the checks compare against
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device {name} | {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    build_s = _build.build()
    for line in _build.ptxas_log.get("block_spgemm", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[1]   {line.strip()}")
    print(f"[1] kernel build {build_s:.2f} s into "
          f"{_build.BUILD_DIR.relative_to(ROOT)}", flush=True)

    phase_kernel_vs_plain(torch, np, K, S, ref, lm, B)
    m = phase_full_width_multiply(torch, K, S, B, E, plan)
    launches = phase_purify(torch, K, purify)

    kernels = [dict(
        name="block_spgemm", route="cuda",
        source="src/repro_torch/kernels/csrc/block_spgemm.cu",
        replaces="src/repro/kernels/block_spgemm.py:217",
        launches=launches, max_abs_err=m["max_abs_err"], ms=m["ms"],
        plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
        bound_by=m["bound_by"], library_ms=m["library_ms"],
    )]
    print(f"[5] all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
