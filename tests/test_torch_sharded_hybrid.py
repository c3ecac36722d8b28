"""The hybrid family on a mesh of ranks (``parallel/runtime.py``):
jamba-v0.1-52b reduced (f32; trained cut to its first two layers,
attention + MLP then mamba + MoE; served with one 8-layer pattern) on
meshes 1 x 2, 2 x 2, 2 x 1 x 2 and 1 x 4.

Training: three sharded steps against the port's one-device step
(``tests/test_torch_sharded_step.py``'s ``_run_case``: loss, ce,
``moe_aux`` and the grad norm within 1e-4, params / mu / nu by that
file's rules, the bytes per rank of every step equal to
``launch.steps.step_bytes``); the one-device step's gradients (the mamba
scan's backward among them, under remat full) against ``jax.grad`` of the
reference's loss.
The trap of mamba's tensor parallelism: ``in_proj``'s column shard is
not the rank's slices of x and z (on ``model`` 2 rank 0 holds all of x,
rank 1 all of z), so each rank's product is dealt round ``model``
(``collectives.deal``) before the split; without the deal a ``model``-2
step misses the one-device step.  On ``model`` 4 the deal is not an
all-to-all (each rank's x chunk and z chunk come from two other ranks).

Serving: a prefill of 16 tokens (two mamba chunks) and three decode steps
against the one-device steps: logits and every cache leaf — the K/V
(heads over ``model``, or the sequence on ``model`` 4 where jamba's two
kv heads do not divide it), the ssm state and the conv tail (channels
over ``model``) — within 1e-4.  ``launch.train --mesh 2x2`` trains jamba
cut to its first two layers (``--layers 2``) as ``--mesh 1x1`` does.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import test_torch_serve_step as SV
import test_torch_sharded_step as SS
import torch

from repro.configs import get_arch as jget_arch
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.core import transport as TR
from repro_torch.launch import steps as ST
from repro_torch.launch import train
from repro_torch.optim.tree import leaves, named_leaves
from repro_torch.parallel import collectives as C
from repro_torch.parallel import runtime as RT


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(impl="tp", layers=8):
    """Reduced jamba, its MoE under ``impl``: one 8-layer pattern, or cut
    to its first two layers (``launch.train.cut_depth``: attention + MLP,
    then mamba + MoE — every mixer of the family)."""
    cfg = train.cut_depth(get_arch("jamba-v0.1-52b").reduced(), layers)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            impl=impl))


CASES = [
    ("tp", (1, 2), dict(remat="none")),
    ("tp", (2, 2), dict(remat="full")),
    ("tp", (2, 1, 2), dict(remat="dots")),
    ("tp", (1, 4), dict(remat="full")),
    ("ep", (2, 2), dict(remat="full", seq_parallel=True)),
]


@pytest.mark.parametrize("impl,dims,opts", CASES,
                         ids=[SS._id(c) for c in CASES])
def test_sharded_step_matches_one_device(impl, dims, opts, monkeypatch):
    """The noise rule as for the MoE family (up to 5 % of the entries:
    the experts see only their tokens)."""
    SS._run_case(_cfg(impl, 2), dims, opts, monkeypatch, noisy_share=5e-2)


def test_without_the_deal_model_2_misses(monkeypatch):
    """in_proj's column shards taken as the rank's x and z slices (no
    deal): the model-2 step misses the one-device step."""
    monkeypatch.setattr(RT.C, "deal", lambda mesh, xs, *a, **k: list(xs))
    with pytest.raises(AssertionError):
        SS._run_case(_cfg(layers=2), (1, 2), dict(remat="none"),
                     monkeypatch)


@pytest.mark.parametrize("n", [2, 4, 16])
def test_deal_gives_each_rank_its_channels(n):
    """``deal`` with two parts of every rank's contiguous column shard of
    (x | z) gives rank j x's and z's j-th chunks; dealt back, the shards
    again; the bytes counted are the most any rank receives."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, n), ("data", "model"), "cpu")
    c = 3
    full = torch.arange(2 * n * c, dtype=torch.float32)[None]
    shards = list(full.chunk(n, dim=1))
    TR.reset_bytes()
    got = TR.deal(mesh, shards, "model", dim=1, parts=2)
    x, z = full.chunk(2, dim=1)
    for j, g in enumerate(got):
        assert torch.equal(g, torch.cat([x[:, j * c:(j + 1) * c],
                                         z[:, j * c:(j + 1) * c]], dim=1))
    want = 4 * c * (1 if n == 2 else 2)
    assert TR.bytes_moved() == want
    back = TR.deal(mesh, got, "model", dim=1, parts=2, inverse=True)
    assert all(torch.equal(a, b) for a, b in zip(back, shards))
    if n == 2:  # on two ranks it is the all-to-all
        a2a = TR.all_to_all(mesh, shards, "model", 1, 1)
        assert all(torch.equal(a, b) for a, b in zip(a2a, got))
    xs = [t.clone().requires_grad_() for t in shards]
    out = C.deal(mesh, xs, "model", dim=1, parts=2)
    gouts = [torch.randn(o.shape, generator=torch.Generator().manual_seed(j))
             for j, o in enumerate(out)]
    grads = torch.autograd.grad(out, xs, grad_outputs=gouts)
    want = TR.deal(mesh, gouts, "model", dim=1, parts=2, inverse=True)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


def test_one_device_gradients_match_jax_grad():
    """The oracle's gradients: the port's one-device jamba loss (mamba's
    chunk scan and its reverse-loop backward, attention, MoE tp) against
    ``jax.grad`` of the reference's, every leaf within 1e-4 of its
    largest entry."""
    jcfg = dataclasses.replace(jget_arch("jamba-v0.1-52b").reduced(),
                               n_layers=2, attn_layer_period=2)
    cfg = _cfg(layers=2)
    jp = JT.init_params(jcfg, jax.random.key(0))
    params = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    jb = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (jl, _), jg = jax.value_and_grad(
        lambda pp: JT.loss_fn(jcfg, pp, jb, loss_chunk=8), has_aux=True)(jp)
    want = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jg),
                                   device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in jb.items()}
    loss, _, grads = ST._grads(cfg, ST.StepOptions(remat="full",
                                                   loss_chunk=8),
                               params, batch)
    assert abs(float(loss) - float(jl)) <= 1e-5 * float(jl)
    for (name, g), w in zip(named_leaves(grads), leaves(want)):
        scale = max(1e-6, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("dims,names", SV.MESHES + [
    ((1, 2), ("data", "model")), ((1, 4), ("data", "model"))],
    ids=["d2m2", "p2d1m2", "m2", "m4"])
def test_sharded_serving_matches_one_device(dims, names):
    c_spec = SV._sharded_vs_one_device(_cfg(), dims, names, prompt=16)
    specs = [tuple(s) for s in leaves(c_spec)]
    b = specs[0][0]
    assert specs[0][1:3] == ((None, "model") if dims[-1] == 4
                             else ("model", None))  # layer 0's K
    assert (b, None, "model") in specs  # a mamba layer's conv tail
    assert (b, "model", None) in specs  # its ssm state


def test_launch_train_on_a_mesh_matches_1x1():
    """``launch.train --mesh 2x2`` takes the hybrid family; ``--layers 2``
    cuts jamba to attention + MLP, then mamba + MoE."""
    args = ["--device", "cpu", "--reduced", "--seq-len", "16",
            "--global-batch", "4", "--log-every", "1", "--steps", "3",
            "--arch", "jamba-v0.1-52b", "--layers", "2"]
    one = train.run(args)
    two = train.run([*args, "--mesh", "2x2"])
    assert one["rc"] == two["rc"] == 0
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=0,
                               atol=1e-4)
    with pytest.raises(ValueError, match="no cut"):
        train.cut_depth(get_arch("jamba-v0.1-52b"), 3)
