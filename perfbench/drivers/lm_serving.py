"""Serving driver: a MoE decoder served by the program's slot engine
(``repro_torch.serving.engine.ServingEngine``), in one of two mixes.

``decode``: ``sessions`` concurrent sessions with ``prompt_len``-token
prompts.  One ``serve`` call admits them all (one full-batch prefill) and
decodes; after ``warm_steps`` decode steps the window opens, and it holds
only decode steps: the output budget (``max_len``) outlasts the window,
so no session is admitted or ends inside it.  The window closes at the
first step that starts ``seconds`` after it opened; the run ends there.
A step's time is the gap between the starts of two consecutive decode
calls, which ends with the host receiving the step's tokens.

``rounds``: closed rounds of ``requests_per_round`` requests of one
length, each generating ``new_tokens``, admitted together through one
``serve`` call; a cycle is one round of each length class of the mix.
Set-up runs ``warm_cycles`` cycles.  A cycle starts while the window has
time left, and the window ends with the last cycle's last round, so that
every class counts alike.  A request's time to first token runs from the
round's submission to ``serve`` returning it.

The timed runs call the program bare.  A traced run profiles the first
``trace_steps`` steps (or ``trace_rounds`` rounds) of the window, with
probes on the router and the attention kernel's entry for the work counts.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from perfbench import checks, gen, generator as TR, workcount as W
from perfbench.probes import probe


class _WindowClosed(Exception):
    pass


def arch_config(cfg: dict):
    """The program's ``ArchConfig`` for the configuration file: the arch
    it names, with every width, count and the dtype from the file."""
    from repro_torch.configs import get_arch

    if cfg["first_k_dense_replace"] != 0 or not cfg["norm_topk_prob"]:
        raise ValueError("the program runs every layer as an expert layer "
                         "with renormalised router weights")
    prog = cfg["program"]
    base = get_arch(prog["arch"])
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    moe = dataclasses.replace(
        base.moe, n_experts=cfg["n_routed_experts"],
        top_k=cfg["num_experts_per_tok"], n_shared=cfg["n_shared_experts"],
        d_expert=cfg["moe_intermediate_size"],
        layer_period=cfg["moe_layer_freq"], impl=prog["moe_impl"])
    return dataclasses.replace(
        base, n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv_heads=cfg["num_key_value_heads"], head_dim=d // h,
        vocab=cfg["vocab_size"], rope_theta=float(cfg["rope_theta"]),
        dtype=cfg["torch_dtype"], tie_embeddings=cfg["tie_word_embeddings"],
        moe=moe)


def _engine(acfg, params, *, batch: int, max_len: int, new: int, seed: int):
    from repro_torch.launch import serve as S
    from repro_torch.serving.engine import GenerationConfig, ServingEngine

    engine = ServingEngine(acfg, params, batch=batch, max_len=max_len,
                           gen=GenerationConfig(max_new_tokens=new,
                                                temperature=0.0, seed=seed))
    if acfg.moe is not None and acfg.moe.impl == "spgemm":
        spec, _ = S._dispatch_spec(acfg, batch, engine.device)
        engine.set_dispatch(spec)
    return engine


def _decode(ctx, engine, t: dict, vocab: int) -> dict:
    prompts = TR.session_prompts(t, ctx.seed, vocab)
    warm, traced = t["warm_steps"], t["trace_steps"]
    win = ctx.window
    stamps: list[float] = []
    fed: list[torch.Tensor] = []
    opened: list[float] = []
    orig = engine._decode

    def step(toks, cache, position):
        now = time.perf_counter()
        n = len(stamps)
        stamps.append(now)
        fed.append(toks)  # the tokens served by the step before this one
        if n == warm:
            opened.append(now)
            ctx.open(now)
            win.start()
        elif n == warm + traced:
            win.stop()
        if opened and now - opened[0] >= ctx.seconds:
            raise _WindowClosed
        with win.span():
            return orig(toks, cache, position)

    engine._decode = step
    try:
        engine.serve(prompts)
    except _WindowClosed:
        pass
    else:
        raise RuntimeError("every session ended before the window closed: "
                           "the output budget is too short for the window")
    finally:
        engine._decode = orig
    gaps = np.diff(np.asarray(stamps[warm:]))
    served = torch.cat(fed, dim=1).cpu().numpy()  # (sessions, n)
    return {
        "itl_s": gaps.tolist(),
        "window_s": stamps[-1] - stamps[warm],
        "tokens": int(gaps.size * len(prompts)),
        "prompts": prompts,
        "slots": list(range(len(prompts))),  # session i fills slot i
        "served": [list(row) for row in served],
        "model_flops": sum(len(prompts) * W.lm_decode_flops(
            ctx.cfg, t["prompt_len"] + n) for n in range(warm, warm + traced)),
    }


def _rounds(ctx, engine, t: dict, vocab: int) -> dict:
    win = ctx.window
    sampled: list[torch.Tensor] = []  # the logits of each serve's first sample
    orig = engine._sample

    def sample(logits):
        sampled.append(logits[:, -1])
        return orig(logits)

    classes = t["classes"]
    for w in range(t["warm_cycles"] * classes):
        engine.serve(TR.round_prompts(t, ctx.seed, vocab, w, warm=True))
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    opened = time.perf_counter()
    ctx.open(opened)
    win.start()
    ttft, prompts, slots, served, logits = [], [], [], [], []
    rounds_s: list[str] = []
    flops = 0.0
    engine._sample = sample
    r = 0
    try:
        while True:
            now = time.perf_counter()
            if r % classes == 0 and r > 0 and now - opened >= ctx.seconds:
                break
            if r == t["trace_rounds"]:
                win.stop()
            batch = TR.round_prompts(t, ctx.seed, vocab, r)
            sampled.clear()
            with win.span():
                outs = engine.serve(batch)
            done = time.perf_counter()
            ttft += [done - now] * len(batch)
            rounds_s.append(f"{len(batch[0])}:{done - now:.3f}")
            if r < t["trace_rounds"]:
                flops += len(batch) * W.lm_prefill_flops(ctx.cfg,
                                                         len(batch[0]))
            prompts += batch
            slots += list(range(len(batch)))  # request i of a round: slot i
            served += outs
            logits += [row[None] for row in sampled[0][:len(batch)]]
            r += 1
    finally:
        engine._sample = orig
    win.stop()
    return {
        "ttft_s": ttft,
        "window_s": done - opened,
        "prompts": prompts,
        "slots": slots,
        "served": served,
        "logits": logits,
        "note": "window rounds (length:s): " + ", ".join(rounds_s),
        "model_flops": flops,
    }


def run(ctx) -> dict:
    cfg, t = ctx.cfg, ctx.traffic
    acfg = arch_config(cfg)
    vocab = cfg["vocab_size"]
    params = gen.lm_params(cfg, ctx.seed, ctx.device)
    ctx.mark("weights")
    if t["mode"] == "decode":
        engine = _engine(acfg, params, batch=t["sessions"],
                         max_len=t["max_len"], new=t["max_len"],
                         seed=ctx.seed)
        drive = _decode
    elif t["mode"] == "rounds":
        longest = max(TR.lengths(t["prompt_tokens"], t["classes"]))
        engine = _engine(acfg, params, batch=t["requests_per_round"],
                         max_len=longest + t["new_tokens"] + 1,
                         new=t["new_tokens"], seed=ctx.seed)
        drive = _rounds
    else:
        raise ValueError(f"mix mode {t['mode']!r}")

    routes: list[torch.Tensor] = []
    attn: list[dict] = []

    def on_route(out, moe, logits32):
        routes.append(out[1])

    def on_attention(out, q, k, v, *, causal=True, window=None, q_offset=0,
                     **_):
        attn.append(dict(batch=q.shape[0], heads=q.shape[1],
                         kv_heads=k.shape[1], sq=q.shape[2], skv=k.shape[2],
                         hd=q.shape[3], causal=causal, window=window,
                         q_offset=q_offset))

    with contextlib.ExitStack() as probes:
        if ctx.window.on:
            probes.enter_context(probe("repro_torch.models.moe",
                                       "router_probs", on_route, ctx.window))
            probes.enter_context(probe("repro_torch.kernels.flash_attention",
                                       "flash_attention", on_attention,
                                       ctx.window))
        rec = drive(ctx, engine, t, vocab)
    ctx.closed()
    del engine

    d, de = cfg["hidden_size"], cfg["moe_intermediate_size"]
    dt = cfg["torch_dtype"]
    spg = [W.moe_work(e, d_model=d, d_expert=de, dtype=dt) for e in routes]
    fla = [W.flash_work(dtype=dt, **a) for a in attn]
    rec["work"] = {
        "block_spgemm": {"flops": sum(w["flops"] for w in spg),
                         "bytes": sum(w["bytes"] for w in spg),
                         "roof": W.ROOF_BY_DTYPE[dt]} if spg else None,
        "flash": {"flops": sum(w["flops"] for w in fla),
                  "bytes": sum(w["bytes"] for w in fla),
                  "roof": W.ROOF_BY_DTYPE[dt]} if fla else None,
        "model_flops": rec.pop("model_flops"),
    }

    prompts, served = rec.pop("prompts"), rec.pop("served")
    slots = rec.pop("slots")
    logits = rec.pop("logits", None)
    want = t["new_tokens"] if t["mode"] == "rounds" else None
    failed = sum(1 for s in served
                 if (want is not None and len(s) != want)
                 or any(not 0 <= x < vocab for x in s))
    pick = TR.check_sample(ctx.seed, len(prompts), t["check_requests"])
    args = (cfg, params, [prompts[i] for i in pick],
            [served[i] for i in pick])
    kw = {"device": ctx.device, "slots": [slots[i] for i in pick],
          "program_logits": None if logits is None
          else [logits[i] for i in pick]}
    got = checks.logit_gaps(*args, **kw)
    rec["attempted"] = len(prompts)
    rec["failed"] = failed + got["off_vocab"]
    rec["judged"] = got["judged"]
    rec["checks"] = {k: got[k] for k in t["checks"]}
    if ctx.control:
        ctl = checks.logit_gaps(*args, control=True, **kw)
        rec["control"] = ctl
        rec["control"]["program"] = got
    return rec
