"""The port's serving engine against the reference's ``ServingEngine``, on
reduced olmo-1b (f32) with the reference's parameters carried across.

Greedy decoding must give the very same tokens: the two models agree to
about 1e-6 in the logits (``test_torch_transformer.py``), far inside the
margin between the top two logits of these runs, which the tests check.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import transformer as JT
from repro.serving.engine import GenerationConfig as JGen
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.launch import serve as serve_launch
from repro_torch.models import transformer as T
from repro_torch.serving.engine import GenerationConfig, ServingEngine

MAX_LEN = 64


@pytest.fixture(scope="module")
def models():
    jcfg = jget_arch("olmo-1b").reduced()
    cfg = get_arch("olmo-1b").reduced()
    jp = JT.init_params(jcfg, jax.random.key(0))
    p = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    return jcfg, jp, cfg, p


def _prompts(n, plen, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=plen).astype(np.int32)
            for _ in range(n)]


def _engines(models, batch, **gen):
    jcfg, jp, cfg, p = models
    return (JEngine(jcfg, jp, batch=batch, max_len=MAX_LEN, gen=JGen(**gen)),
            ServingEngine(cfg, p, batch=batch, max_len=MAX_LEN,
                          gen=GenerationConfig(**gen)))


def test_greedy_generate_matches_reference(models):
    jeng, eng = _engines(models, 3, max_new_tokens=10)
    prompts = _prompts(3, 12, models[2].vocab)
    prompts[1] = prompts[1][:7]  # left-padded, pads attended
    want = jeng.generate(prompts)
    got = eng.generate(prompts)
    assert got == want
    assert all(len(o) == 10 for o in got)


def test_greedy_margin_is_wide(models):
    """The top-two logit gap of the first step, so that the 1e-6 model
    agreement decides the argmax."""
    _, _, cfg, p = models
    toks = torch.from_numpy(np.stack(_prompts(3, 12, cfg.vocab))).long()
    logits, _ = T.prefill(cfg, p, toks, T.init_cache(cfg, 3, MAX_LEN,
                                                     device="cpu"))
    top2 = torch.topk(logits[:, -1], 2).values
    assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-4


def test_serve_staggered_queue_matches_reference(models):
    """Five requests through two slots, arriving at steps 0, 0, 3, 3, 30:
    refills, per-slot positions and an idle gap."""
    jeng, eng = _engines(models, 2, max_new_tokens=6)
    prompts = _prompts(5, 10, models[2].vocab, seed=1)
    arrivals = [0, 0, 3, 3, 30]
    want = jeng.serve(prompts, arrivals)
    got = eng.serve(prompts, arrivals)
    assert got == want
    st, jst = eng.last_serve_stats, jeng.last_serve_stats
    assert st["n_refills"] == jst["n_refills"] and st["n_requests"] == 5
    assert ([s["step"] for s in st["steps"]]
            == [s["step"] for s in jst["steps"]])
    assert ([s["occupancy"] for s in st["steps"]]
            == [s["occupancy"] for s in jst["steps"]])
    assert sum(p["slots"] for p in st["prefills"]) == 5


def test_serve_request_equals_solo_generate(models):
    _, eng = _engines(models, 2, max_new_tokens=7)
    prompts = _prompts(4, 9, models[2].vocab, seed=2)
    outs = eng.serve(prompts, [0, 1, 2, 2])
    for i in (0, 3):
        assert outs[i] == eng.generate([prompts[i]])[0]


def test_eos_frees_a_slot_for_the_queue(models):
    """With eos set to a token the first request emits, its slot refills
    early; tokens still match the reference."""
    _, eng0 = _engines(models, 2, max_new_tokens=8)
    prompts = _prompts(3, 10, models[2].vocab, seed=3)
    eos = eng0.generate([prompts[0]])[0][2]
    jeng, eng = _engines(models, 2, max_new_tokens=8, eos_token=eos)
    want = jeng.serve(prompts)
    got = eng.serve(prompts)
    assert got == want
    assert got[0][-1] == eos and len(got[0]) <= 3
    refill_steps = [s["step"] for s in eng.last_serve_stats["steps"]
                    if s["refilled"]]
    assert refill_steps[0] == 0 and refill_steps[1] < 8


def test_temperature_sampling_is_seeded(models):
    prompts = _prompts(2, 8, models[2].vocab, seed=4)
    _, a = _engines(models, 2, max_new_tokens=6, temperature=1.0, seed=5)
    _, b = _engines(models, 2, max_new_tokens=6, temperature=1.0, seed=5)
    _, greedy = _engines(models, 2, max_new_tokens=6)
    ta, tb = a.generate(prompts), b.generate(prompts)
    assert ta == tb
    assert ta != greedy.generate(prompts)
    assert all(0 <= t < models[2].vocab for o in ta for t in o)


def test_set_dispatch_not_ported(models):
    """A dense model takes a dispatch spec and ignores it (no MoE layer
    reads it); the spec key is the reference's."""
    from repro_torch.models.moe import DispatchSpec

    jeng, eng = _engines(models, 2, max_new_tokens=4)
    prompts = _prompts(2, 8, models[2].vocab, seed=9)
    plain = eng.generate(prompts)
    for e in (jeng, eng):
        e.set_dispatch(None)
    assert eng._spec_key() == jeng._spec_key() == (None,)
    eng.set_dispatch(DispatchSpec(backend="stacks", stack_capacity=8))
    assert eng._spec_key() == (None, "stacks", 8)
    assert eng.generate(prompts) == plain


def test_launcher_rehearsal_on_cpu(capsys):
    report = serve_launch.run(["--device", "cpu", "--reduced", "--batch",
                               "2", "--queue", "3", "--prompt-len", "8",
                               "--max-new", "4", "--max-len", "32"])
    assert report["ok"] and report["requests"] == 3
    assert report["tokens"] == 12 and report["refills"] == 2
    assert len(report["prefill_s"]) == 2 and report["flash_launches"] == 0
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out
