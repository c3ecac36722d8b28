"""Purification driver: an SCF-like loop over the program's density matrix
(``repro_torch.core.signiter.density_matrix``, the fused sign iteration).

Set-up makes H from the seed and runs ``warm_sweeps`` sweeps of one
purification (the kernels load, the sweep program is built, the
allocator fills).  In the window, purification k runs on H scaled by 1 +
``scale_step`` k, with the one sweep program reused; a purification
starts while the window has time left, and the window ends with the last
one.  Only whole purifications count.

A traced run profiles the whole window, with a probe on the local
multiply that keeps each operand's mask and norms for the work counts.
The check compares every purification's P with the dense float64
reference's P of H (H scaled by a positive factor has the same P) and its
trace with the count of eigenvalues below mu.
"""
from __future__ import annotations

import contextlib
import time

import torch

from perfbench import gen, workcount as W
from perfbench.probes import probe
from perfbench.reference import purification as ref

_DTYPES = {"float32": torch.float32}


def _purify(cfg: dict, h, max_iter: int):
    from repro_torch.core import signiter

    return signiter.density_matrix(
        h, cfg["mu"], threshold=cfg["threshold"],
        filter_eps=cfg["filter_eps"], max_iter=max_iter, tol=cfg["tol"],
        mode="fused", sync_every=cfg["sync_every"], backend=cfg["backend"])


def run(ctx) -> dict:
    from repro_torch.core import bsm as B
    from repro_torch.core import signiter

    cfg, t = ctx.cfg, ctx.traffic
    nb, bs = cfg["block_rows"], cfg["block_size"]
    blocks, mask = gen.hamiltonian(ctx.seed, nb, bs, cfg["occupancy"],
                                   ctx.device,
                                   pattern_seed=cfg["pattern_seed"])
    h = B.make_bsm(blocks.to(_DTYPES[cfg["dtype"]]), mask)
    ctx.mark("inputs")
    _purify(cfg, h, t["warm_sweeps"])
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)

    mults: list[tuple] = []

    def on_multiply(out, ab, am, an, bb, bm, bn, **kw):
        mults.append((am, an, bm, bn, ab is bb, kw.get("threshold", 0.0)))

    runs = []
    with contextlib.ExitStack() as probes:
        if ctx.window.on:
            probes.enter_context(probe("repro_torch.core.signiter",
                                       "local_filtered_mm", on_multiply,
                                       ctx.window))
        opened = time.perf_counter()
        ctx.open(opened)
        ctx.window.start()
        k = 0
        while k == 0 or time.perf_counter() - opened < ctx.seconds:
            hk = B.scale(h, 1.0 + t["scale_step"] * k)
            p, stats = _purify(cfg, hk, cfg["max_iter"])
            tr = float(signiter.trace(p))
            runs.append((p, stats, tr))
            k += 1
        done = time.perf_counter()
        ctx.window.stop()
    ctx.closed()

    rec = {
        "window_s": done - opened,
        "purifications": len(runs),
        "sweeps": sum(s.iterations for _, s, _ in runs) / len(runs),
        "host_syncs_per_sweep": (sum(s.host_syncs for _, s, _ in runs)
                                 / sum(s.iterations for _, s, _ in runs)),
    }
    if mults:
        flops = nbytes = 0.0
        for am, an, bm, bn, same, thr in mults:
            w = W.spgemm_work(am, an, bm, bn, threshold=thr, bs=bs,
                              dtype=cfg["dtype"], same_operand=same)
            flops += w["flops"]
            nbytes += w["bytes"]
        rec["work"] = {"block_spgemm": {"flops": flops, "bytes": nbytes,
                                        "roof": W.ROOF_BY_DTYPE[cfg["dtype"]]}}
    del mults

    p_ref, n_occ = ref.density_matrix(ref.dense(blocks, mask), cfg["mu"])
    err = trace_err = 0.0
    for p, _, tr in runs:
        err = max(err, ref.max_abs_error(ref.dense(p.blocks, p.mask,
                                                   torch.float32), p_ref))
        trace_err = max(trace_err, abs(tr - n_occ))
    rec["attempted"] = len(runs)
    rec["failed"] = sum(1 for _, s, _ in runs if not s.converged)
    rec["checks"] = {"p_max_abs_err": err, "trace_err": trace_err}
    if ctx.control:
        h32 = ref.dense(blocks, mask, torch.float32)
        p_ctl = ref.newton_schulz(h32, cfg["mu"], tol=cfg["tol"],
                                  max_iter=cfg["max_iter"], tf32=True)
        rec["control"] = {"p_max_abs_err": ref.max_abs_error(p_ctl, p_ref),
                          "trace_err": abs(float(torch.trace(p_ctl)) - n_occ)}
    return rec
