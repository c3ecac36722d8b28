"""Serving driver: batched prefill + decode with the slot engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced

Builds the model (``--arch``, random weights from ``--seed``, drawn on the
device), runs synthetic prompts through the ``ServingEngine`` (one static
``generate`` round, or ``--queue N`` requests drained through continuous
slot batching) and reports: wall seconds, prefill seconds per round,
per-step decode times, tokens, tokens/s, requests, refills, launches of
the flash-attention and block-SpGEMM kernels, and peak device memory on
CUDA.  Runs on CUDA unless ``--device cpu`` is given, and raises without a
CUDA device.  Exits 1 when a request got a token outside the vocabulary or
too few tokens.

Recurrent archs run through the same path: jamba-v0.1-52b (mamba and
attention layers 7:1, MoE every other layer) and rwkv6-7b (attention
free); ``--arch jamba-v0.1-52b --reduced`` and ``--arch rwkv6-7b
--reduced`` rehearse on the CPU.  Their prompts must be a multiple of the
mixer's chunk (256 at full width, 8 reduced) once longer than it.  jamba
at full depth (51.45 B parameters, 95.8 GiB in bf16) needs more than one
card, as llama4 does (sharded serving of every family:
``launch.steps.build_prefill_step`` / ``build_serve_step(..., mesh=)``);
one card serves it at full width and 16 of its 32 layers.

whisper-large-v3 and pixtral-12b serve text-only prompts, as the
reference's launcher serves them: whisper's decoder without frames (its
cross-attention attends to a zero cache and adds nothing), pixtral
without a patch prefix.  Frames and patches reach the model through
``models.transformer.prefill(..., frame_embeds=)`` / ``patch_embeds=``.

MoE archs: ``--moe-impl`` overrides ``cfg.moe.impl`` (``spgemm`` routes
the expert matmuls through ``engine.multiply``, on a card the
block-SpGEMM kernel, under a covering decode envelope resolved through
``core.envelope.DispatchCache``; the decision is printed as
``capacity=``, ``backend=``, ``source=``).  ``--tuning-db PATH`` binds the
tuning database, so the dispatch decision persists across launches
(``source=db`` on a warm file).  The report adds the routed and dropped
(token, choice) pairs and the ``dispatch_*`` counters.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduced --arch deepseek-moe-16b --moe-impl spgemm
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queue", type=int, default=0,
                    help="drain N requests through continuous batching "
                         "(0 = one static generate round)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch path)")
    ap.add_argument("--moe-impl", default=None,
                    help="override cfg.moe.impl (dense | tp | ep | spgemm) "
                    "for MoE archs")
    ap.add_argument("--tuning-db", default=None,
                    help="tuning database path (created if missing); "
                    "omitted = analytic dispatch decisions only")
    return ap


def _dispatch_spec(cfg, batch: int, device):
    """Covering decode-grid dispatch spec, resolved through the bucket
    cache (the decision from the bound tuning database when one is set);
    returns (spec, decision)."""
    import numpy as np

    from repro_torch.core.envelope import DispatchCache
    from repro_torch.models.moe import DispatchSpec, moe_dims

    e, _ = moe_dims(cfg)
    tb = cfg.moe.token_block
    nb = (batch + tb - 1) // tb
    # covers every routing of the decode grid, so no request is clipped
    full = np.ones((nb, e), bool)
    cache = DispatchCache(np.eye(e, dtype=bool), dtype=cfg.dtype,
                          device=device)
    env, dec = cache.resolve(full)
    return DispatchSpec(envelope=env, backend=dec["backend"],
                        stack_capacity=dec["capacity"]), dec


def build(argv=None, *, params=None):
    """(args, cfg, engine, prompts) for the given flags: the model drawn on
    the device from ``--seed`` (or ``params``, already drawn for the same
    arch, served as they are), and the prompts from a numpy generator
    with the same seed."""
    import dataclasses

    import numpy as np

    from repro_torch.config import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import GenerationConfig, ServingEngine

    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.tuning_db:
        from repro_torch import tuner
        from repro_torch.core import plan as plan_mod

        plan_mod.clear_cache()
        tuner.set_default_db(args.tuning_db)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.moe_impl:
        if cfg.moe is None:
            raise SystemExit(f"--moe-impl: arch {args.arch} has no MoE")
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl=args.moe_impl))
    if params is None:
        params = T.init_params(cfg, args.seed, device=dev)
    gen = GenerationConfig(max_new_tokens=args.max_new,
                           temperature=args.temperature, seed=args.seed)
    engine = ServingEngine(cfg, params, batch=args.batch,
                           max_len=args.max_len, gen=gen)
    rng = np.random.default_rng(args.seed)
    n_req = args.queue if args.queue > 0 else args.batch
    prompts = [rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32)
               for _ in range(n_req)]
    return args, cfg, engine, prompts


def run(argv=None, *, built=None) -> dict:
    """Serve the synthetic requests and return the report (also printed).
    ``built`` — ``build(argv)``'s tuple, to serve a model already built.
    An MoE spgemm engine gets its dispatch spec here, and keeps it."""
    import torch

    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import block_spgemm as spgemm
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import moe as MoE

    args, cfg, engine, prompts = build(argv) if built is None else built
    dev = engine.device
    counters = ("dispatch_hits", "dispatch_misses", "drift_retunes")
    stats0 = plan_mod.cache_stats()
    decision = None
    if cfg.moe is not None and cfg.moe.impl == "spgemm":
        spec, decision = _dispatch_spec(cfg, args.batch, dev)
        engine.set_dispatch(spec)
        print(f"[serve] spgemm dispatch: capacity={spec.stack_capacity} "
              f"backend={spec.backend} source={decision['source']}",
              flush=True)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads (hd {cfg.hd}), {cfg.dtype}, "
          f"{cfg.param_count() / 1e9:.3f} B params; device {name}; batch "
          f"{args.batch}, prompt {args.prompt_len}, max_new {args.max_new},"
          f" max_len {args.max_len}", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    launches0, spgemm0 = flash.launches, spgemm.launches
    MoE.reset_drop_counts()
    t0 = time.perf_counter()
    if args.queue > 0:
        outs = engine.serve(prompts)
        st = engine.last_serve_stats
        prefill_s = [p["wall_s"] for p in st["prefills"]]
        decode_s = [s["decode_s"] for s in st["steps"]]
        n_refills = st["n_refills"]
    else:
        outs = engine.generate(prompts)
        prefill_s, decode_s, n_refills = [], [], 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    n_tokens = sum(len(o) for o in outs)
    want = args.max_new
    if args.queue > 0:  # serve stops a request where the cache ends
        want = min(want, args.max_len - args.prompt_len - 1)
    ok = all(len(o) == want and all(0 <= t < cfg.vocab for t in o)
             for o in outs)
    report = dict(
        ok=ok, arch=cfg.name, device=name, n_layers=cfg.n_layers,
        requests=len(prompts), tokens=n_tokens, wall_s=wall,
        tokens_per_s=n_tokens / wall, prefill_s=prefill_s,
        decode_ms=[1e3 * s for s in decode_s],
        decode_ms_median=(1e3 * statistics.median(decode_s)
                          if decode_s else None),
        refills=n_refills, flash_launches=flash.launches - launches0,
        spgemm_launches=spgemm.launches - spgemm0,
        prefill_calls=len(prefill_s), decode_steps=len(decode_s),
        dispatch=decision,
        moe=MoE.drop_counts() if cfg.moe is not None else None,
        # this launch's, its own dispatch resolution included
        dispatch_counters={k: plan_mod.cache_stats()[k] - stats0[k]
                           for k in counters},
        peak_mem_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                      if dev.type == "cuda" else None),
        outputs=outs,
    )
    pf = ", ".join(f"{s:.4f}" for s in prefill_s)
    print(f"[serve] {len(prompts)} requests, {n_tokens} tokens in "
          f"{wall:.3f} s ({n_tokens / wall:.1f} tok/s), refills "
          f"{n_refills}, prefill s per round [{pf}], decode ms/step median "
          f"{report['decode_ms_median']}, flash launches "
          f"{report['flash_launches']}, block_spgemm launches "
          f"{report['spgemm_launches']}, peak memory "
          f"{report['peak_mem_gib']} GiB", flush=True)
    if cfg.moe is not None:
        print(f"[serve] moe impl {cfg.moe.impl}: dropped "
              f"{report['moe']['dropped']} of {report['moe']['routed']} "
              f"routed (token, choice) pairs; dispatch counters "
              f"{report['dispatch_counters']}", flush=True)
    if args.tuning_db:
        from repro_torch import tuner

        db = tuner.get_default_db()
        print(f"[serve] tuning db: {len(db)} record(s) at {db.path}",
              flush=True)
    for i, o in enumerate(outs[: min(4, len(outs))]):
        print(f"[serve] req{i}: {o[:12]}{'...' if len(o) > 12 else ''}")
    if not ok:
        print("[serve] FAILED: a request got too few tokens or a token "
              "outside the vocabulary", flush=True)
    return report


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
