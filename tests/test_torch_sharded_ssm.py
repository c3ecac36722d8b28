"""The ssm family on a mesh of ranks (``parallel/runtime.py``): rwkv6-7b
reduced (f32, d 128, four heads of 32, chunk 8): trained on meshes
2 x 2, 1 x 2, 2 x 1 x 2 and 1 x 4, served on those, and whole on 1 x 8
(four heads do not divide eight model ranks).  Trained on 1 x 4 (one head
a rank), the third step's grad norm is 1.5e-4 of itself off the
one-device step's: past this file's fixed 1e-4 but inside the one-device
step's own spread from a one-ulp start (6.5e-4; a step without the sum
over ``model`` below misses at the first step by 5.1e-4 while that
spread is 1.4e-6), so that case's metrics are held to 1e-4 or
twice that spread (``_run_case(..., witness=True)``, the rule of
``tests/test_torch_sharded_step.py``'s chaotic runs).

Training: three sharded steps against the port's one-device step
(``tests/test_torch_sharded_step.py``'s ``_run_case``: loss, ce and the
grad norm within 1e-4, params / mu / nu by that file's rules, the bytes
per rank of every step equal to ``launch.steps.step_bytes``), under
``seq_parallel`` too; the one-device step's gradients are held to
``jax.grad`` of the reference's loss in ``tests/test_torch_train.py``.
The trap of the time mix's tensor parallelism: ``decay_w1`` and the
interpolation factors act whole on every model rank, each rank for its
own channels, so their gradients must be summed over ``model``; without
that sum the step misses the one-device step.

Serving: a prefill of 16 tokens (two chunks) and three decode steps
against the one-device steps: logits and every cache leaf — the shift
tails (whole on every model rank) and the wkv state (heads over
``model``) — within 1e-4, the cache laid out as ``cache_specs`` gives
it.
"""
from __future__ import annotations

import pytest
import test_torch_serve_step as SV
import test_torch_sharded_step as SS
import torch

from repro_torch.configs import get_arch
from repro_torch.optim.tree import named_leaves
from repro_torch.parallel import runtime as RT


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg():
    return get_arch("rwkv6-7b").reduced()


CASES = [
    ("rwkv6-7b", (2, 2), dict(remat="full")),
    ("rwkv6-7b", (1, 2), dict(remat="none")),
    ("rwkv6-7b", (2, 1, 2), dict(remat="dots")),
    ("rwkv6-7b", (2, 2), dict(remat="full", seq_parallel=True)),
    ("rwkv6-7b", (2, 2), dict(remat="full", zero1=True)),
]


@pytest.mark.parametrize("arch,dims,opts", CASES,
                         ids=[SS._id(c) for c in CASES])
def test_sharded_step_matches_one_device(arch, dims, opts, monkeypatch):
    SS._run_case(_cfg(), dims, opts, monkeypatch)


def test_sharded_step_one_head_a_rank(monkeypatch):
    """1 x 4: one head a model rank, held by the one-ulp witness."""
    SS._run_case(_cfg(), (1, 4), dict(remat="none"), monkeypatch,
                 witness=True)


def test_without_the_model_sum_the_step_misses(monkeypatch):
    """decay_w1 and the mu factors used whole on each model rank with no
    sum of their gradients over ``model``: the step misses."""
    monkeypatch.setattr(RT, "RWKV_SUMMED", ())
    with pytest.raises(AssertionError):
        SS._run_case(_cfg(), (1, 2), dict(remat="none"), monkeypatch)


def test_without_the_model_sum_one_head_a_rank_misses(monkeypatch):
    """The planted fault also fails the 1 x 4 case under its witness."""
    monkeypatch.setattr(RT, "RWKV_SUMMED", ())
    with pytest.raises(AssertionError):
        SS._run_case(_cfg(), (1, 4), dict(remat="none"), monkeypatch,
                     witness=True)


@pytest.mark.parametrize("dims,names", SV.MESHES + [
    ((1, 4), ("data", "model")), ((1, 8), ("data", "model"))],
    ids=["d2m2", "p2d1m2", "m4", "m8-whole"])
def test_sharded_serving_matches_one_device(dims, names):
    c_spec = SV._sharded_vs_one_device(_cfg(), dims, names, prompt=16)
    specs = dict(named_leaves(c_spec))
    b = specs["blocks__0__shift_t"][0]
    assert tuple(specs["blocks__0__shift_t"]) == (b, None)
    assert tuple(specs["blocks__0__shift_c"]) == (b, None)
    heads = None if dims[-1] == 8 else "model"
    assert tuple(specs["blocks__0__wkv"]) == (b, heads, None, None)


def test_runtime_runs_whole_where_the_heads_do_not_divide():
    """The rule: channels over ``model`` where the heads divide it (64
    heads on 16 at full width), else whole on every model rank."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as ST
    from repro_torch.parallel import sharding as SH

    for cfg, m, want in ((get_arch("rwkv6-7b"), 16, True),
                         (_cfg(), 4, True), (_cfg(), 8, False)):
        mesh = M.Mesh(("data", "model"), (1, m),
                      (torch.device("meta"),) * m, abstract=True)
        spec = ST.abstract_state(cfg, mesh, None, ST.StepOptions())[2]
        rt = RT.DecoderRuntime(cfg, mesh, spec, SH.activation_rules(
            cfg, mesh, batch=8))
        assert rt.rwkv_tp(spec["blocks"][0]["rwkv"]) is want
