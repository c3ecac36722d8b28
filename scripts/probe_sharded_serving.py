"""What moves the MoE and hybrid families' sharded serving off the
one-device steps: the witnesses behind ``chip_smoke.py`` phase 27 (c)'s
gates, and the one-device training beside phase 27 (b)'s sharded steps.

    PYTHONPATH=src python scripts/probe_sharded_serving.py [serve] [train]
        [f32] [--split-k-f32]

``serve`` (deepseek-moe-16b at full depth, jamba-v0.1-52b cut to 8
layers; bf16, seed 0; 8 prompts of 256 tokens, then 16 decode steps on
the one-device run's greedy tokens): the one-device steps batched as 2 x 2
ranks' data ranks batch the rows, recording their expert choices; then,
each against that run (``chip_smoke._agree``: max |logits err| / max(1,
max |logit|), the share of greedy tokens equal, overall and per step):
the same steps batched whole (8 rows a call), on their own choices and
on the recorded ones; the same steps again (determinism); weights one
ulp off, on their own choices and on the recorded ones; and the 2 x 2
ranks' prefill + decode with the tensor-parallel partials summed in f32
(the serving rules' ``reduce_dtype``) and in the model's dtype, each on
the recorded choices and on the ranks' own.  ``--split-k-f32`` turns
off cuBLAS's reduced-precision split-K reductions for bf16 GEMMs first.

``f32``: the same weights upcast to f32 (the config at dtype
float32): the one-device steps on the recorded choices and greedy
tokens against the bf16 one-device run; then 2 x 2 ranks' steps in bf16
and in f32 on the same, each against both one-device runs.

``train``: deepseek-moe-16b cut to 4 layers (8 x 2,048 tokens, remat
full), 5 steps through ``launch.train`` on one device and on ``--mesh
2x2``, at lr 3e-4 and 3e-3: losses, peak memory, step seconds.

On a machine without a card it runs ``serve`` on the reduced configs at
a tiny size (a check of the script, no measurement).
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

from repro_torch.config import ShapeConfig  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.parallel import sharding as SH  # noqa: E402

SEED = CS.SEED
DEV = "cuda" if torch.cuda.is_available() else "cpu"
SMALL = DEV == "cpu"


def per_step(got, want):
    return [tuple(float(f"{v:.4g}") for v in CS._agree([g], [w]))
            for g, w in zip(got, want)]


def serve_probe(arch, layers, f32=False):
    b, s, new = (4, 16, 3) if SMALL else (8, 256, 16)
    depth = s + new
    shape = ShapeConfig("serve", depth, b, "prefill")
    cfg = get_arch(arch)
    if SMALL:
        cfg = cfg.reduced()
    if layers is not None:
        cfg = train.cut_depth(cfg, layers)
    mesh = CS._mesh_of(mesh_mod, (2, 2), DEV)
    routing = CS._Routing(torch, MoE, mesh, b)
    params = T.init_params(cfg, torch.Generator(DEV).manual_seed(SEED),
                           device=DEV)
    g = torch.Generator(DEV).manual_seed(SEED + 27)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=g, device=DEV)
    pre1, _ = ST.build_prefill_step(cfg, shape, device=DEV)
    dec1, _ = ST.build_serve_step(cfg, shape, device=DEV)
    groups = routing.groups
    nxt = []

    def one(grps, rec=False, forced=False):
        caches = [T.init_cache(cfg, hi - lo, depth, device=DEV)
                  for lo, hi in grps]
        out = []
        MoE.reset_drop_counts()
        for i in range(new + 1):
            lg = []
            for (lo, hi), c1 in zip(grps, caches):
                ctx = (routing.record() if rec
                       else routing.replay_rows(i, lo, hi) if forced
                       else contextlib.nullcontext())
                with ctx:
                    lg.append((pre1(params, c1, {"tokens": toks[lo:hi]})
                               if i == 0 else dec1(params, c1,
                                                   nxt[i - 1][lo:hi],
                                                   s + i - 1))[0])
            if rec:
                routing.merge(len(grps))
            if i == 0:
                drops = MoE.drop_counts()
            lg = torch.cat(lg)
            out.append(lg.float().cpu())
            if rec and i < new:
                nxt.append(lg[:, -1].argmax(-1)[:, None])
        return out, drops

    t0 = time.perf_counter()
    with torch.no_grad():
        want, d0 = one(groups, rec=True)
        print(f"[{arch}] one-device drops {d0}", flush=True)
    if f32:
        held = [params]  # f32_probe owns the weights from here
        del params
        return f32_probe(arch, cfg, mesh, routing, held, toks, nxt, want,
                         b, s, new, t0)
    with torch.no_grad():
        runs = (("batched whole, own choices", [(0, b)], False),
                ("batched whole, recorded choices", [(0, b)], True),
                ("again (determinism)", groups, False))
        for tag, grps, forced in runs:
            got, dr = one(grps, forced=forced)
            print(f"[{arch}] one device {tag}: {CS._agree(got, want)} drops "
                  f"{dr}; per step {per_step(got, want)}", flush=True)
        CS._one_ulp_(torch, params, SEED + 1)
        for tag, forced in (("one ulp off, own choices", False),
                            ("one ulp off, recorded choices", True)):
            got, dr = one(groups, forced=forced)
            print(f"[{arch}] one device {tag}: {CS._agree(got, want)} drops "
                  f"{dr}; per step {per_step(got, want)}", flush=True)
    del params
    params = T.init_params(cfg, torch.Generator(DEV).manual_seed(SEED),
                           device=DEV)
    real_rules = SH.activation_rules
    variants = {}
    for var in ("f32 partials", "model-dtype partials"):
        if var != "f32 partials":
            SH.activation_rules = (lambda *a, reduce_dtype=None, **k:
                                   real_rules(*a, **k))
        try:
            pre, _ = ST.build_prefill_step(cfg, shape, device=DEV,
                                           mesh=mesh)
            dec, _ = ST.build_serve_step(cfg, shape, device=DEV, mesh=mesh)
        finally:
            SH.activation_rules = real_rules
        variants[var] = (pre, dec)
    spec = ST.abstract_state(cfg, mesh, None, ST.StepOptions())[2]
    sharded = CS._shard_in_place(mesh, SH, params, spec)
    del params
    for var, (pre, dec) in variants.items():
        for mode in ("recorded choices", "own choices"):
            forced = mode == "recorded choices"
            cache = ST.init_sharded_cache(cfg, mesh, b, depth)
            with torch.no_grad():
                MoE.reset_drop_counts()
                FA.launches = 0
                with routing.replay(0, forced):
                    lg, cache = pre(sharded, cache, {"tokens": toks})
                drops = MoE.drop_counts()
                got = [CS._unshard_logits(torch, SH, mesh, lg, b, cfg.vocab)]
                for i in range(new):
                    with routing.replay(i + 1, forced):
                        lg, cache = dec(sharded, cache, nxt[i], s + i)
                    got.append(CS._unshard_logits(torch, SH, mesh, lg, b,
                                                  cfg.vocab))
            print(f"[{arch}] 2 x 2 ranks, {var}, {mode}: "
                  f"{CS._agree(got, want)} drops {drops} flash launches "
                  f"{FA.launches}; per step {per_step(got, want)}",
                  flush=True)
            del cache, got
    print(f"[{arch}] {time.perf_counter() - t0:.1f} s", flush=True)


def f32_probe(arch, cfg, mesh, routing, held, toks, nxt, want, b, s,
              new, t0):
    """The bf16 run's weights in f32 (``cfg`` at dtype float32): the
    one-device steps on the recorded choices and greedy tokens against
    the bf16 one-device run; then 2 x 2 ranks' steps in bf16 and in f32
    on the same, each against both one-device runs."""
    import dataclasses

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    depth = s + new
    shape = ShapeConfig("serve", depth, b, "prefill")
    groups = routing.groups
    params = held.pop()
    CS._upcast_(params)
    pre1, _ = ST.build_prefill_step(cfg32, shape, device=DEV)
    dec1, _ = ST.build_serve_step(cfg32, shape, device=DEV)
    with torch.no_grad():
        caches = [T.init_cache(cfg32, hi - lo, depth, device=DEV)
                  for lo, hi in groups]
        want32 = []
        for i in range(new + 1):
            lg = []
            for (lo, hi), c1 in zip(groups, caches):
                with routing.replay_rows(i, lo, hi):
                    lg.append((pre1(params, c1, {"tokens": toks[lo:hi]})
                               if i == 0 else dec1(params, c1,
                                                   nxt[i - 1][lo:hi],
                                                   s + i - 1))[0])
            want32.append(torch.cat(lg).float().cpu())
        del caches
    print(f"[{arch}] one device f32, recorded choices, vs bf16: "
          f"{CS._agree(want32, want)}; per step {per_step(want32, want)}",
          flush=True)
    del params
    for c in (cfg, cfg32):
        params = T.init_params(cfg, torch.Generator(DEV).manual_seed(SEED),
                               device=DEV)
        if c is cfg32:
            CS._upcast_(params)
        pre, _ = ST.build_prefill_step(c, shape, device=DEV, mesh=mesh)
        dec, _ = ST.build_serve_step(c, shape, device=DEV, mesh=mesh)
        spec = ST.abstract_state(c, mesh, None, ST.StepOptions())[2]
        sharded = CS._shard_in_place(mesh, SH, params, spec)
        del params
        cache = ST.init_sharded_cache(c, mesh, b, depth)
        with torch.no_grad():
            with routing.replay(0, True):
                lg, cache = pre(sharded, cache, {"tokens": toks})
            got = [CS._unshard_logits(torch, SH, mesh, lg, b, cfg.vocab)]
            for i in range(new):
                with routing.replay(i + 1, True):
                    lg, cache = dec(sharded, cache, nxt[i], s + i)
                got.append(CS._unshard_logits(torch, SH, mesh, lg, b,
                                              cfg.vocab))
        print(f"[{arch}] 2 x 2 ranks {c.dtype}, recorded choices: vs one "
              f"device f32 {CS._agree(got, want32)}, per step "
              f"{per_step(got, want32)}; vs one device bf16 "
              f"{CS._agree(got, want)}", flush=True)
        del sharded, cache, got
    print(f"[{arch}] f32 {time.perf_counter() - t0:.1f} s", flush=True)


def train_probe():
    arch, layers, b, seq = "deepseek-moe-16b", 4, 8, 2048
    for lr, mesh in (("3e-4", None), ("3e-3", None), ("3e-4", "2x2"),
                     ("3e-3", "2x2")):
        argv = ["--arch", arch, "--layers", str(layers), "--seq-len",
                str(seq), "--global-batch", str(b), "--remat", "full",
                "--lr", lr, "--log-every", "1", "--seed", str(SEED),
                "--steps", "5"]
        if mesh:
            argv += ["--mesh", mesh]
        torch.cuda.reset_peak_memory_stats()
        run = train.run(argv)
        print(f"[train] {arch} {layers} layers lr {lr} mesh {mesh}: rc "
              f"{run['rc']} losses {run['losses']} peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB step_s "
              f"{run['step_s']}", flush=True)
        del run
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", nargs="*", default=["serve"],
                    choices=["serve", "f32", "train"])
    ap.add_argument("--split-k-f32", action="store_true")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.split_k_f32:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    if not SMALL:
        _build.build()
    if "train" in args.what and not SMALL:
        train_probe()
    for what in ("serve", "f32"):
        if what in args.what:
            serve_probe("deepseek-moe-16b", None, f32=what == "f32")
            serve_probe("jamba-v0.1-52b", 8, f32=what == "f32")


if __name__ == "__main__":
    main()
