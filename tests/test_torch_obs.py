"""The port's spans (``repro_torch.obs``): a shared no-op outside a
profiler; under one, nested at the layer boundaries the benchmark's cells
run (the fused sign iteration's sweep, multiply and list build; the
serving engine's refill and decode step), and changing no result."""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.core import bsm as B
from repro_torch.core import signiter
from repro_torch.models import transformer as T
from repro_torch.serving.engine import GenerationConfig, ServingEngine


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spans(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of the ``repro.*`` events."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("repro."):
            s = ev.start_ns()
            out.append((ev.name(), s, s + ev.duration_ns()))
    return out


def _inside(inner, outer) -> bool:
    return any(o[1] <= inner[1] and inner[2] <= o[2] for o in outer)


def test_span_off_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = obs.span("repro.a"), obs.span("repro.b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        with b:  # reentrant
            pass


def test_span_on_is_a_profiler_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("repro.test"):
            torch.ones(2).sum()
    (name, s, e), = _spans(prof)
    assert name == "repro.test" and e > s


def _purify(h):
    return signiter.sign_iteration(h, mode="fused", backend="stacks",
                                   threshold=1e-9, filter_eps=1e-8,
                                   max_iter=6, tol=0.0, sync_every=2)


def test_sign_iteration_spans_nest():
    h = B.random_bsm(5, nb=6, bs=4, occupancy=0.4, pattern="banded",
                     symmetric=True, device="cpu")
    p_off, st_off = _purify(h)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        p_on, st_on = _purify(h)
    spans = _spans(prof)
    by = {n: [x for x in spans if x[0] == n] for n in {x[0] for x in spans}}
    sweeps = by["repro.signiter.sweep"]
    mults = by["repro.local_mm.multiply"]
    builds = by["repro.local_mm.list_build"]
    assert len(sweeps) == st_on.iterations == 6
    assert len(mults) == 2 * len(sweeps)
    assert all(_inside(m, sweeps) for m in mults)
    assert builds and all(_inside(b, mults) for b in builds)
    assert len(by["repro.signiter.sync"]) == st_on.host_syncs == 3
    assert not any(_inside(s, sweeps) for s in by["repro.signiter.sync"])
    assert torch.equal(p_on.blocks, p_off.blocks)
    assert torch.equal(p_on.mask, p_off.mask)
    assert st_on.residual_trace == st_off.residual_trace


def _moe_engine():
    cfg = get_arch("deepseek-moe-16b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl="spgemm"))
    params = T.init_params(cfg, 0, device="cpu")
    return cfg, ServingEngine(cfg, params, batch=2, max_len=16,
                              gen=GenerationConfig(max_new_tokens=1))


def test_serve_one_token_round_spans():
    cfg, engine = _moe_engine()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, 5).astype(np.int32)
               for _ in range(2)]
    off = engine.serve(prompts)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = engine.serve(prompts)
    assert on == off and all(len(t) == 1 for t in on)
    spans = _spans(prof)
    names = [n for n, *_ in spans]
    assert names.count("repro.serve.refill") == 1
    assert names.count("repro.serve.decode") == 1
    refill = [x for x in spans if x[0] == "repro.serve.refill"]
    decode = [x for x in spans if x[0] == "repro.serve.decode"]
    assert all(_inside(x, refill) for x in spans
               if x[0] == "repro.model.prefill")
    assert all(_inside(x, decode) for x in spans
               if x[0] == "repro.model.decode_step")
    moe_layers = sum(1 for k in T.layer_kinds(cfg) if k.get("moe"))
    for part in ("route", "dispatch", "experts", "combine", "shared"):
        # a prefill and a decode step; on the CPU no group list to build
        assert names.count(f"repro.moe.{part}") == 2 * moe_layers, part
    assert names.count("repro.attention") == 2 * cfg.n_layers
