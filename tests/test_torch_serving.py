"""The port's serving engine against the reference's ``ServingEngine``, on
reduced olmo-1b (f32) with the reference's parameters carried across, and
on the reduced recurrent archs (jamba's mamba hybrid, rwkv6; f32), whose
refill splices state rows where olmo's splices K/V rows.

Greedy decoding must give the very same tokens: the two models agree to
about 1e-6 in the logits (``test_torch_transformer.py``), far inside the
margin between the top two logits of these runs, which the tests check.
"""
from __future__ import annotations

from collections import deque

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
from repro_torch.serving.engine import _Request

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


# -- recurrent mixers: the refill splices conv / ssm and wkv / shift rows --

RECURRENT = ["jamba-v0.1-52b", "rwkv6-7b"]
PLEN = 8  # one reduced chunk: the reference's prefill wants multiples


@pytest.fixture(scope="module", params=RECURRENT)
def recurrent(request):
    jcfg = jget_arch(request.param).reduced()
    cfg = get_arch(request.param).reduced()
    jp = JT.init_params(jcfg, jax.random.key(1))
    p = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    return jcfg, jp, cfg, p


def test_recurrent_serve_matches_reference(recurrent):
    """Five requests through two slots, arriving at steps 0, 0, 2, 2, 9:
    three refill rounds, the slots at their own positions; the tokens are
    the reference's."""
    jeng, eng = _engines(recurrent, 2, max_new_tokens=5)
    prompts = _prompts(5, PLEN, recurrent[2].vocab, seed=11)
    arrivals = [0, 0, 2, 2, 9]
    want = jeng.serve(prompts, arrivals)
    got = eng.serve(prompts, arrivals)
    assert got == want
    assert eng.last_serve_stats["n_refills"] == \
        jeng.last_serve_stats["n_refills"] >= 3


def test_recurrent_served_request_equals_solo(recurrent):
    """The request in a refilled slot equals itself generated alone, as
    does the first."""
    _, eng = _engines(recurrent, 2, max_new_tokens=6)
    prompts = _prompts(3, PLEN, recurrent[2].vocab, seed=12)
    outs = eng.serve(prompts)
    assert eng.last_serve_stats["n_refills"] == 2
    for i in (0, 2):
        assert outs[i] == eng.generate([prompts[i]])[0]


def test_refill_starts_from_the_prompt_state(recurrent):
    """A refill overwrites every state leaf of the refilled slot with the
    state of its own prompt (a fresh full-batch prefill's, the other slot
    padded), whatever the slot held, and leaves the other slot's rows as
    they were."""
    _, eng = _engines(recurrent, 2, max_new_tokens=4)
    cfg = recurrent[2]
    cache = T.init_cache(cfg, 2, MAX_LEN, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for layer in cache["blocks"]:
        for t in layer.values():  # a previous request's leftovers
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    before = [{k: v.clone() for k, v in c.items()} for c in cache["blocks"]]
    prompt = _prompts(1, PLEN, cfg.vocab, seed=13)[0]
    queue = deque([_Request(0, prompt)])
    active = [object(), None]  # slot 0 busy, slot 1 free
    next_tok = torch.zeros(2, dtype=torch.long)
    pos = torch.zeros(2, dtype=torch.long)
    assert eng._refill(queue, active, cache, next_tok, pos, PLEN, 0, []) == 1
    toks = torch.zeros((2, PLEN), dtype=torch.long)
    toks[1] = torch.from_numpy(prompt)
    _, fresh = T.prefill(cfg, eng.params, toks,
                         T.init_cache(cfg, 2, MAX_LEN, device="cpu"))
    for got, old, new in zip(cache["blocks"], before, fresh["blocks"]):
        for name in got:
            assert torch.equal(got[name][1], new[name][1]), name
            assert torch.equal(got[name][0], old[name][0]), name
    assert int(pos[1]) == PLEN and int(pos[0]) == 0


@pytest.mark.parametrize("arch", RECURRENT)
def test_launcher_rehearses_recurrent_archs(arch):
    """``launch.serve --arch ... --reduced`` on the CPU: every request its
    tokens, no flash launch (CPU tensors take the plain version)."""
    report = serve_launch.run(["--device", "cpu", "--reduced", "--arch",
                               arch, "--batch", "2", "--queue", "3",
                               "--prompt-len", "16", "--max-new", "3",
                               "--max-len", "32"])
    assert report["ok"] and report["tokens"] == 9
    assert report["refills"] == 2 and report["flash_launches"] == 0
