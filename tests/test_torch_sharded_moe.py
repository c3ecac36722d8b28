"""The MoE family on a mesh of ranks (``parallel/runtime.py``):
deepseek-moe-16b (every layer MoE, shared experts) under ``tp``, ``ep``
and ``dense``, and llama4-maverick (dense and MoE layers interleaved,
top-1 with a shared expert), reduced, f32, on meshes 1 x 2, 2 x 2 and
2 x 1 x 2.

Training: three sharded steps against the port's one-device step from the
same parameters and batches, with ``tests/test_torch_sharded_step.py``'s
check (``_run_case``): loss, ce, ``moe_aux`` and the grad norm within
1e-4 at every step, params, mu and nu by that file's rules after the
first and the third, and the bytes per rank of every step equal to
``launch.steps.step_bytes``.  The one-device step is itself held to the
reference's ``loss_fn`` (``tests/test_torch_train.py``) and its
gradients to ``jax.grad`` here.  The router's gradient (aux_coef 0.01)
is held to the one-device step's at 1e-4 on its own: every model rank
computes the router whole, but its combine weights multiply expert
outputs that are partial over ``model``, so their gradient must be summed
over ``model`` once, and the load-balance loss (formed from sums over the
global batch) must not be counted once per model rank.  llama4 also runs
with 3 heads over 3 kv heads (attention whole on every model rank of 2,
as its 40 heads on 16).  Under ``seq_parallel`` the router runs on each
rank's positions and the choices are all-gathered.

Serving: a prefill and three decode steps against the one-device steps
(``tests/test_torch_serve_step.py``'s check): logits and every cache leaf
within 1e-4.  ``spgemm`` on a mesh raises naming ROADMAP.md item 15c.2.
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
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, SyntheticLMData, make_global_batch
from repro_torch.launch import steps as ST
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.optim.tree import leaves, named_leaves, tree_map
from repro_torch.parallel import sharding as SH


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(name):
    """deepseek-<impl>, llama4, or llama4-replicated-heads, reduced."""
    if name.startswith("deepseek"):
        cfg = get_arch("deepseek-moe-16b").reduced()
        impl = name.split("-")[1]
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                impl=impl))
    cfg = get_arch("llama4-maverick-400b-a17b").reduced()
    if name == "llama4-replicated-heads":
        cfg = dataclasses.replace(cfg, n_heads=3, n_kv_heads=3)
    return cfg


CASES = [
    ("deepseek-tp", (2, 2), dict(remat="full")),
    ("deepseek-tp", (2, 1, 2), dict(remat="dots", head_2p5d=True)),
    ("deepseek-ep", (2, 2), dict(remat="dots")),
    ("deepseek-dense", (1, 2), dict(remat="full")),
    ("deepseek-tp", (2, 2), dict(remat="full", seq_parallel=True)),
    ("deepseek-ep", (2, 2), dict(remat="full", seq_parallel=True,
                                 zero1=True)),
    ("llama4", (2, 1, 2), dict(remat="none", fsdp_axis=("pod", "data"))),
    ("llama4-replicated-heads", (2, 2), dict(remat="dots")),
]


@pytest.mark.parametrize("name,dims,opts", CASES,
                         ids=[SS._id(c) for c in CASES])
def test_sharded_step_matches_one_device(name, dims, opts, monkeypatch):
    """An expert's weights see only the tokens routed to it, so more of
    their entries take the noise rule than a dense model's (reduced
    llama4, top-1 of 8 experts: 2.1 % of all entries over three steps):
    up to 5 % may."""
    SS._run_case(_cfg(name), dims, opts, monkeypatch, noisy_share=5e-2)


def _router_grads(cfg, dims, aux_coef):
    """(one-device, sharded) gradients of every router, the sharded ones
    gathered from the ranks (the router is FSDP'd over ``data``: its
    gather's backward already summed the batch ranks')."""
    mesh = SS._mesh(dims)
    shape = ShapeConfig("train", SS.SEQ, SS.BATCH, "train")
    options = ST.StepOptions(remat="full", loss_chunk=SS.CHUNK,
                             aux_coef=aux_coef)
    params = T.init_params(cfg, 0, device="cpu")
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=SS.SEQ,
                                      global_batch=SS.BATCH, seed=0))
    _, _, grads = ST._grads(cfg, options, params, make_global_batch(
        data, 0, "cpu"))
    _, _, p_spec, _ = ST.abstract_state(cfg, mesh, None, options)
    rules = ST._rules(cfg, mesh, shape, options)
    from repro_torch.parallel.runtime import DecoderRuntime

    runtime = DecoderRuntime(cfg, mesh, p_spec, rules, remat="full",
                             loss_chunk=SS.CHUNK)
    sharded = SH.shard_tree(mesh, params, p_spec)
    live = [[t.detach().requires_grad_() for t in s]
            for s in leaves(sharded)]
    it = iter(live)
    batch = make_global_batch(data, 0, mesh)
    losses, _, _ = runtime.local_losses(
        tree_map(lambda _: next(it), sharded), batch["tokens"],
        batch["targets"], SS.BATCH * SS.SEQ, aux_coef=aux_coef)
    want, got = [], []
    for (name, g), x, sp in zip(named_leaves(grads), live, leaves(p_spec)):
        if name.endswith("router"):
            got.append(SH.unshard(mesh, torch.autograd.grad(
                losses, x, grad_outputs=[torch.ones_like(v) for v in
                                         losses], retain_graph=True), sp))
            want.append(g)
    return want, got


@pytest.mark.parametrize("name,dims", [("deepseek-tp", (2, 2)),
                                       ("deepseek-ep", (1, 2)),
                                       ("llama4", (2, 2))])
def test_router_gradient_matches_one_device(name, dims):
    """Every router's gradient (aux_coef 0.01) within 1e-4 of the
    one-device step's, relative to its largest entry; and the aux term's
    share of it is no rounding: with aux_coef 0 the gradient moves."""
    cfg = _cfg(name)
    want, got = _router_grads(cfg, dims, 0.01)
    assert want
    for w, g in zip(want, got):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale
    plain, _ = _router_grads(cfg, dims, 0.0)
    assert max(float((a - b).abs().max()) for a, b in zip(want, plain)) \
        > 1e-4


def test_one_device_gradients_match_jax_grad():
    """The oracle's gradients: the port's one-device MoE loss (deepseek:
    tp dispatch, top-2 of 8 with shared experts, aux_coef 0.01) against
    ``jax.grad`` of the reference's, on the reference's parameters, every
    leaf within 1e-4 of its largest entry."""
    arch = "deepseek-moe-16b"
    jcfg, cfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    jp = JT.init_params(jcfg, jax.random.key(0))
    params = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    jb = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (jl, _), jg = jax.value_and_grad(
        lambda pp: JT.loss_fn(jcfg, pp, jb, loss_chunk=8), has_aux=True)(jp)
    want = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jg),
                                   device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in jb.items()}
    loss, _, grads = ST._grads(cfg, ST.StepOptions(remat="none",
                                                   loss_chunk=8),
                               params, batch)
    assert abs(float(loss) - float(jl)) <= 1e-5 * float(jl)
    for (name, g), w in zip(named_leaves(grads), leaves(want)):
        scale = max(1e-6, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("dims,names", SV.MESHES + [((1, 2), ("data",
                                                             "model"))],
                         ids=["d2m2", "p2d1m2", "m2"])
@pytest.mark.parametrize("name", ["deepseek-tp", "deepseek-ep",
                                  "deepseek-dense", "llama4",
                                  "llama4-replicated-heads"])
def test_sharded_serving_matches_one_device(name, dims, names):
    """A prefill and three decode steps: logits and every K/V leaf (heads
    over ``model``, or the sequence where they do not divide it) within
    1e-4 of the one-device steps."""
    c_spec = SV._sharded_vs_one_device(_cfg(name), dims, names)
    want = (None, "model") if name.endswith("heads") else ("model", None)
    assert tuple(leaves(c_spec)[0])[1:3] == want


def test_spgemm_on_a_mesh_raises_15c2():
    cfg = _cfg("deepseek-spgemm")
    shape = ShapeConfig("s", SV.DEPTH, SV.BATCH, "prefill")
    mesh = SS._mesh((2, 2))
    with pytest.raises(NotImplementedError, match=r"item 15c\.2"):
        ST.build_train_step(cfg, ShapeConfig("t", 16, 4, "train"),
                            device="cpu", mesh=mesh)
    for build in (ST.build_prefill_step, ST.build_serve_step):
        with pytest.raises(NotImplementedError, match=r"item 15c\.2"):
            build(cfg, shape, device="cpu", mesh=mesh)


def test_bytes_count_follows_the_impl():
    """``ep`` moves the dispatch buffer (split over the experts, then
    gathered back) where ``tp`` sums the partial outputs; each count is
    what a step moves (``test_sharded_step_matches_one_device``)."""
    mesh = SS._mesh((2, 2))
    shape = ShapeConfig("t", SS.SEQ, SS.BATCH, "train")
    counts = {impl: ST.step_bytes(_cfg(f"deepseek-{impl}"), mesh, shape,
                                  ST.StepOptions(remat="full"))
              for impl in ("tp", "ep", "dense")}
    assert counts["tp"] == counts["dense"] != counts["ep"]
    assert np.isclose(ST.step_bytes(_cfg("deepseek-ep"), SS._mesh((1, 1)),
                                    shape), 0.0)


def test_launch_train_on_a_mesh_matches_1x1():
    """``launch.train --mesh 2x2`` takes the MoE family: its losses are
    the 1 x 1 run's within 1e-4."""
    args = ["--device", "cpu", "--reduced", "--seq-len", "16",
            "--global-batch", "4", "--log-every", "1", "--steps", "3",
            "--arch", "llama4-maverick-400b-a17b"]
    one = train.run(args)
    two = train.run([*args, "--mesh", "2x2"])
    assert one["rc"] == two["rc"] == 0
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=0,
                               atol=1e-4)


def test_bf16_serving_sums_partials_in_f32():
    """Serving a bf16 model on a mesh sums the tensor-parallel partials in
    f32 and rounds once (``ctx.tp_matmul`` under the serving rules; an
    f32 model's rules and the training rules keep the model's dtype), and
    sums the routed experts' outputs before the combine, which then rounds
    as one device's does.  On the one-device run's expert choices
    (``chip_smoke._Routing``, phase 27 (c)'s comparison) a reduced 8-layer
    deepseek in bf16 serves within 3e-2 of the one-device steps' logits
    with at least 0.9 of their greedy tokens, and drops what they drop."""
    import chip_smoke

    from repro_torch.models import moe as MoE
    from repro_torch.parallel import ctx

    x = torch.randn(4, 6, dtype=torch.bfloat16)
    w = torch.randn(6, 3, dtype=torch.bfloat16)
    with ctx.sharding_rules(ctx.ShardingRules(reduce_dtype=torch.float32)):
        got = ctx.tp_matmul(x, w)
    assert got.dtype == torch.float32
    assert torch.equal(got, x.float() @ w.float())
    cfg = dataclasses.replace(_cfg("deepseek-tp"), dtype="bfloat16",
                              n_layers=8)
    mesh = SS._mesh((2, 2))
    b, s, new = 8, 32, 4
    shape = ShapeConfig("s", s + new, b, "prefill")
    built = {}
    for name, m in (("one", None), ("sharded", mesh)):
        pre, (p_sds, _, _) = ST.build_prefill_step(cfg, shape, device="cpu",
                                                   mesh=m)
        dec, _ = ST.build_serve_step(cfg, shape, device="cpu", mesh=m)
        built[name] = (pre, dec, p_sds)
    for c, want in ((cfg, torch.float32), (_cfg("deepseek-tp"), None)):
        rt = ST._serving_runtime(c, shape, ST.StepOptions(), torch.device(
            "cpu"), mesh, ST.abstract_state(c, mesh, None,
                                            ST.StepOptions())[2])
        assert rt.rules.reduce_dtype == want
    assert ST._rules(cfg, mesh, shape, ST.StepOptions()).reduce_dtype is None
    params = T.init_params(cfg, 0, device="cpu")
    sharded = SH.shard_tree(mesh, params, tree_map(lambda v: v.spec,
                                                   built["sharded"][2]))
    cache1 = T.init_cache(cfg, b, s + new, device="cpu")
    cache = ST.init_sharded_cache(cfg, mesh, b, s + new)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, s)))
    rows = SH.batch_spec(mesh, b, 1, cfg.vocab)
    routing = chip_smoke._Routing(torch, MoE, mesh, b)
    same, worst, drops = 0, 0.0, []
    with torch.no_grad():
        for i in range(new + 1):
            for name, run in (("one", None), ("sharded", None)):
                pre, dec, _ = built[name]
                MoE.reset_drop_counts()
                ctx_ = (routing.record() if name == "one"
                        else routing.replay(i))
                with ctx_:
                    if name == "one":
                        want = (pre(params, cache1, {"tokens": toks})
                                if i == 0 else dec(params, cache1, nxt,
                                                   s + i - 1))[0]
                    else:
                        got = (pre(sharded, cache, {"tokens": toks})
                               if i == 0 else dec(sharded, cache, nxt,
                                                  s + i - 1))[0]
                drops.append(MoE.drop_counts())
            g = SH.unshard(mesh, got, rows).float()
            worst = max(worst, float((g - want.float()).abs().max())
                        / max(1.0, float(want.float().abs().max())))
            same += int((g[:, -1].argmax(-1) == want[:, -1].float()
                         .argmax(-1)).sum())
            nxt = want[:, -1].argmax(-1)[:, None]
    assert worst <= 3e-2 and same >= 0.9 * b * (new + 1), (worst, same)
    assert drops[0] == drops[1] and drops[0]["dropped"] > 0
