"""Parity of the port's MoE layer (``repro_torch.models.moe``), the MoE
transformer blocks and MoE serving with the reference's, on the CPU.

The reference draws every parameter (``jax.random``) and the port gets
them bit for bit; the inputs come from numpy.  Tolerances: f32 1e-5 for
one MoE layer (the same arithmetic in another summation order), 1e-4 for
the reduced deepseek-moe-16b and llama4-maverick models' logits (a few
layers of it); dropped and routed counts, dispatch masks and routing are
exact.  The spgemm impl runs through ``engine.multiply`` (``stacks`` on
the CPU) cold, under a covering envelope and under a clipping one.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ArchConfig as JArch
from repro.config import MoEConfig as JMoE
from repro.configs import get_arch as jget_arch
from repro.core import bsm as RB
from repro.core import engine as RE
from repro.core import envelope as REnv
from repro.launch import serve as jserve
from repro.models import moe as RM
from repro.models import transformer as JT
from repro.serving.engine import GenerationConfig as JGen
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.config import ArchConfig, MoEConfig
from repro_torch.configs import get_arch
from repro_torch.core import bsm as B
from repro_torch.core import engine as E
from repro_torch.core import envelope as PEnv
from repro_torch.core import plan as PP
from repro_torch.kernels import block_spgemm as K
from repro_torch.launch import serve as serve_launch
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serving.engine import GenerationConfig, ServingEngine

TOL = 1e-5
MODEL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(impl, *, capacity_factor=1.25, mlp="swiglu", n_shared=0):
    kw = dict(n_experts=8, top_k=2, d_expert=32, impl=impl,
              capacity_factor=capacity_factor, token_block=4,
              n_shared=n_shared)
    arch = dict(name=f"test-moe-{impl}", family="llama", n_layers=2,
                d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab=128,
                mlp=mlp)
    return (JArch(moe=JMoE(**kw), **arch), ArchConfig(moe=MoEConfig(**kw),
                                                      **arch))


def _layer(impl, *, s=24, b=2, seed=0, **kw):
    jcfg, cfg = _cfgs(impl, **kw)
    jp = RM.init_moe(jcfg, jax.random.PRNGKey(0), jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(seed).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    return jcfg, jp, cfg, p, x


def _apply_both(jcfg, jp, cfg, p, x):
    jy, jaux, jst = RM.apply_moe(jcfg, jp, jnp.asarray(x), collect_stats=True)
    y, aux, st = M.apply_moe(cfg, p, torch.from_numpy(x), collect_stats=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert int(st["dropped"]) == int(jst["dropped"])
    assert int(st["routed"]) == int(jst["routed"])
    return y, st


# ---------------------------------------------------------------------------
# one MoE layer, every impl
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,cf", [
    ("dense", 1.25), ("tp", 0.5), ("tp", 1.25), ("tp", 8.0), ("ep", 0.5)])
@pytest.mark.parametrize("mlp,n_shared", [("swiglu", 0), ("geglu", 2),
                                          ("gelu", 1)])
def test_dense_and_capacity_impls_match_reference(impl, cf, mlp, n_shared):
    jcfg, jp, cfg, p, x = _layer(impl, capacity_factor=cf, mlp=mlp,
                                 n_shared=n_shared)
    _, st = _apply_both(jcfg, jp, cfg, p, x)
    if impl in ("tp", "ep") and cf == 0.5:
        assert int(st["dropped"]) > 0  # capacity 0.5 must clip


@pytest.mark.parametrize("s", [24, 27])  # 27: a padded last token block
@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_spgemm_cold_matches_reference_and_dense(s, mlp):
    jcfg, jp, cfg, p, x = _layer("spgemm", s=s, mlp=mlp)
    y, st = _apply_both(jcfg, jp, cfg, p, x)
    assert int(st["dropped"]) == 0
    dcfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            impl="dense"))
    yd, _ = M.apply_moe(dcfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), yd.numpy(), rtol=TOL, atol=TOL)


def _grid_envelopes(x_shape, cfg, clip_cols):
    """(reference, port) covering or clipping envelopes of the call's
    (nb, E) grid: every block row may use every expert except
    ``clip_cols``."""
    b, s, _ = x_shape
    e, tb = cfg.moe.n_experts, cfg.moe.token_block
    nb = -(-(b * s) // tb)
    m = np.ones((nb, e), bool)
    m[:, list(clip_cols)] = False
    eye = np.eye(e, dtype=bool)
    return (REnv.union_envelope([m], [eye]),
            PEnv.union_envelope([m], [eye]))


@pytest.mark.parametrize("clip_cols", [(), (1,), (0, 3, 5)])
def test_spgemm_under_envelope_matches_reference(clip_cols):
    """A covering envelope clips nothing; a clipping one drops the routed
    choices outside it, the same ones on both sides."""
    jcfg, jp, cfg, p, x = _layer("spgemm", b=2, s=4)
    renv, penv = _grid_envelopes(x.shape, cfg, clip_cols)
    rspec = RM.DispatchSpec(envelope=renv, backend="stacks",
                            stack_capacity=renv.local_capacity())
    pspec = M.DispatchSpec(envelope=penv, backend="stacks",
                           stack_capacity=penv.local_capacity())
    with RM.dispatch_scope(rspec), M.dispatch_scope(pspec):
        y, st = _apply_both(jcfg, jp, cfg, p, x)
    assert (int(st["dropped"]) > 0) == bool(clip_cols)
    # an envelope of another grid (prefill vs decode) is not applied, nor
    # its capacity (the reference's compaction would drop products past it)
    jcfg, jp, cfg, p, x = _layer("spgemm", b=2, s=24)
    rspec = dataclasses.replace(rspec, stack_capacity=None)
    with RM.dispatch_scope(rspec), M.dispatch_scope(pspec):
        _, st = _apply_both(jcfg, jp, cfg, p, x)
    assert int(st["dropped"]) == 0


def test_unknown_impl_raises():
    _, _, cfg, p, x = _layer("dense")
    bad = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl="nope"))
    with pytest.raises(ValueError, match="unknown moe impl"):
        M.apply_moe(bad, p, torch.from_numpy(x))


# ---------------------------------------------------------------------------
# routing pieces
# ---------------------------------------------------------------------------


def test_router_ties_go_to_the_lowest_expert():
    """Tied logits: ``lax.top_k`` order (lowest index first), not
    ``torch.topk``'s unspecified one."""
    jcfg, cfg = _cfgs("dense")
    rng = np.random.default_rng(3)
    logits = rng.integers(0, 3, (64, 8)).astype(np.float32)  # many ties
    jw, je, jprobs = RM.router_probs(jcfg.moe, jnp.asarray(logits))
    w, e, probs = M.router_probs(cfg.moe, torch.from_numpy(logits))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(
        float(M.load_balance_loss(probs, e, 8)),
        float(RM.load_balance_loss(jprobs, je, 8)), rtol=1e-6)


@pytest.mark.parametrize("capacity", [1, 3, 100])
def test_dispatch_indices_and_block_mask_exact(capacity):
    rng = np.random.default_rng(4)
    te = rng.integers(0, 8, (24, 2))
    js, jk = RM._dispatch_indices(jnp.asarray(te), 8, capacity)
    ps, pk = M._dispatch_indices(torch.from_numpy(te), 8, capacity)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    valid = np.arange(24) < 21
    for v in (None, valid):
        want = RM.dispatch_block_mask(
            jnp.asarray(te), 8, 4, None if v is None else jnp.asarray(v))
        got = M.dispatch_block_mask(
            torch.from_numpy(te), 8, 4,
            None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="divisible"):
        M.dispatch_block_mask(torch.from_numpy(te[:23]), 8, 4)


# ---------------------------------------------------------------------------
# the aliased block-diagonal expert bank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["stacks", "dense", "cuda"])
def test_aliased_bank_equals_the_zeroed_bank(backend):
    """The stride-0 bank (no copy) and the reference's zeroed bank give
    bit-equal products; its norms are the zeroed bank's.  ``cuda`` on CPU
    tensors is the kernel's plain version."""
    rng = np.random.default_rng(6)
    e, tb, d, de = 8, 4, 16, 12
    w = torch.from_numpy(rng.standard_normal((e, d, de)).astype(np.float32))
    aliased = M.diag_expert_bsm(w)
    zeroed = M.diag_expert_bsm(w, aliased=False)
    assert aliased.blocks.stride()[0] == 0
    assert torch.equal(aliased.mask, zeroed.mask)
    np.testing.assert_allclose(aliased.norms.numpy(), zeroed.norms.numpy(),
                               rtol=1e-6)
    assert M.diag_expert_bsm(w).norms is not aliased.norms  # fresh diag
    jw = jnp.asarray(w.numpy())
    ref = RM._diag_expert_bsm(jw)
    np.testing.assert_array_equal(zeroed.blocks.numpy(),
                                  np.asarray(ref.blocks))
    a_mask = rng.random((5, e)) < 0.4
    a_blocks = rng.standard_normal((5, e, tb, d)).astype(np.float32)
    a = B.make_bsm(torch.from_numpy(a_blocks), torch.from_numpy(a_mask))
    c1 = E.multiply(a, aliased, backend=backend)
    c2 = E.multiply(a, zeroed, backend=backend)
    assert torch.equal(c1.blocks, c2.blocks)
    assert torch.equal(c1.mask, c2.mask) and torch.equal(c1.norms, c2.norms)
    want = RE.multiply(RB.make_bsm(jnp.asarray(a_blocks),
                                   jnp.asarray(a_mask)), ref)
    np.testing.assert_allclose(c1.blocks.numpy(), np.asarray(want.blocks),
                               rtol=TOL, atol=TOL)
    assert K.launches == 0


def test_bank_norms_follow_the_weights():
    w = torch.ones((2, 3, 3))
    n1 = M.diag_expert_bsm(w).norms.clone()
    w.mul_(2.0)  # in place: the cached norms are stale
    np.testing.assert_allclose(M.diag_expert_bsm(w).norms.numpy(),
                               2.0 * n1.numpy())


# ---------------------------------------------------------------------------
# MoE transformer blocks: reduced deepseek-moe-16b and llama4-maverick
# ---------------------------------------------------------------------------


def _models(arch, impl=None):
    jcfg, cfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    if impl is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 impl=impl))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl=impl))
    jp = JT.init_params(jcfg, jax.random.key(0))
    p = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    return jcfg, jp, cfg, p


@pytest.mark.parametrize("arch,impl", [
    ("deepseek-moe-16b", None), ("deepseek-moe-16b", "spgemm"),
    ("llama4-maverick-400b-a17b", None),
    ("llama4-maverick-400b-a17b", "spgemm")])
def test_moe_models_match_reference(arch, impl):
    """forward (hidden + aux), prefill logits and four decode steps with
    per-slot positions; llama4 interleaves dense and MoE blocks."""
    jcfg, jp, cfg, p = _models(arch, impl)
    kinds = [k["moe"] for k in T.layer_kinds(cfg)]
    assert any(kinds) and (all(kinds) or arch.startswith("llama4"))
    moe_layer = next(b for b, k in zip(p["blocks"], kinds) if k)["moe"]
    assert moe_layer["router"].dtype == torch.float32
    assert set(moe_layer) == set(jp["blocks"][-1]["moe"])
    b, s, max_len = 2, 13, 24
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (b, s))
    jx, jaux = JT.forward(jcfg, jp, jnp.asarray(toks))
    x, aux = T.forward(cfg, p, torch.from_numpy(toks))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    jc = JT.init_cache(jcfg, b, max_len)
    c = T.init_cache(cfg, b, max_len, device="cpu")
    jl, jc = JT.prefill(jcfg, jp, jnp.asarray(toks), jc)
    lg, c = T.prefill(cfg, p, torch.from_numpy(toks), c)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    pos = np.array([s, s - 3])
    for _ in range(4):
        t = rng.integers(0, cfg.vocab, (b, 1))
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(t), jc,
                                jnp.asarray(pos))
        lg, c = T.decode_step(cfg, p, torch.from_numpy(t), c,
                              torch.from_numpy(pos))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
        pos = pos + 1


def test_moe_init_params_layout():
    cfg = get_arch("llama4-maverick-400b-a17b").reduced()
    p = T.init_params(cfg, 0, device="cpu")
    kinds = T.layer_kinds(cfg)
    for blk, kind in zip(p["blocks"], kinds):
        assert ("moe" in blk) == kind["moe"] and ("mlp" in blk) != kind["moe"]
    e, de = M.moe_dims(cfg)
    moe = next(blk["moe"] for blk in p["blocks"] if "moe" in blk)
    assert tuple(moe["w_in"].shape) == (e, cfg.d_model, de)
    assert tuple(moe["shared_in"].shape) == (cfg.d_model, de)


# ---------------------------------------------------------------------------
# serving with the spgemm dispatch
# ---------------------------------------------------------------------------


def test_serving_spgemm_matches_reference_engine():
    """The launcher's covering decode spec: the same greedy tokens as the
    reference's engine, nothing dropped, and served requests equal to each
    request generated alone.  The reference's engine gets the spec with
    its capacity left to the envelope: given the spec's capacity, its
    prefill (another grid) compacts at the decode capacity and drops the
    products past it, where the port takes the structural bound."""
    jcfg, jp, cfg, p = _models("deepseek-moe-16b", "spgemm")
    batch, max_len = 3, 32
    jeng = JEngine(jcfg, jp, batch=batch, max_len=max_len,
                   gen=JGen(max_new_tokens=5))
    eng = ServingEngine(cfg, p, batch=batch, max_len=max_len,
                        gen=GenerationConfig(max_new_tokens=5))
    jspec = jserve._dispatch_spec(jcfg, batch)
    spec, dec = serve_launch._dispatch_spec(cfg, batch, "cpu")
    assert dec["backend"] == "stacks"
    assert spec.stack_capacity == jspec.stack_capacity
    jeng.set_dispatch(dataclasses.replace(jspec, stack_capacity=None))
    eng.set_dispatch(spec)
    assert eng._spec_key()[1:] == ("stacks", jspec.stack_capacity)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 9).astype(np.int32)
               for _ in range(batch)]
    M.reset_drop_counts()
    got = eng.generate(prompts)
    assert got == jeng.generate(prompts)
    assert M.drop_counts()["dropped"] == 0 and M.drop_counts()["routed"] > 0
    served = eng.serve(prompts)
    assert eng.last_serve_stats["spec_key"] == eng._spec_key()
    for i, prompt in enumerate(prompts):
        assert served[i] == eng.generate([prompt])[0]


def test_launcher_moe_rehearsal_cold_and_warm(tmp_path):
    argv = ["--device", "cpu", "--reduced", "--arch", "deepseek-moe-16b",
            "--moe-impl", "spgemm", "--batch", "2", "--queue", "3",
            "--prompt-len", "8", "--max-new", "4", "--max-len", "32",
            "--tuning-db", str(tmp_path / "db.json")]
    try:
        cold = serve_launch.run(argv)
        assert serve_launch.main(argv) == 0
        warm = serve_launch.run(argv)
        assert [r["dispatch"]["source"] for r in (cold, warm)] == [
            "analytic", "db"]
        for r in (cold, warm):
            assert r["ok"] and r["moe"]["dropped"] == 0
            assert r["spgemm_launches"] == 0  # CPU: the plain path
        assert warm["dispatch_counters"]["dispatch_misses"] == 1
        with pytest.raises(SystemExit):
            serve_launch.build(["--device", "cpu", "--reduced",
                                "--moe-impl", "spgemm"])
    finally:
        PP.clear_cache()


def test_sharding_context_on_one_device():
    """Without rules ``shard_act`` is the identity and the ep impl is tp
    (one device, as in the reference); with rules installed resharding
    one tensor raises (the sharded runtime lays out per-rank lists), and
    ``tp_reduce_dtype`` sets the down-projection's output dtype, as
    ``preferred_element_type`` does."""
    from repro.parallel import ctx as RC
    from repro_torch.parallel import ctx as C

    jcfg, jp, cfg, p, x = _layer("ep", capacity_factor=0.5)
    assert C.current_rules() is None and C.tp_reduce_dtype() is None
    t = torch.from_numpy(x)
    assert C.shard_act(t, "btd") is t
    with C.sharding_rules(C.ShardingRules(table={"moe_dispatch": "spec"})):
        assert C.current_rules().spec("moe_dispatch") == "spec"
        with pytest.raises(NotImplementedError,
                           match="one tensor cannot be resharded"):
            M.apply_moe(cfg, p, t)
    assert C.current_rules() is None
    tcfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            impl="tp"))
    jtcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                              impl="tp"))
    with C.sharding_rules(C.ShardingRules(reduce_dtype=torch.bfloat16)), \
            RC.sharding_rules(RC.ShardingRules(reduce_dtype=jnp.bfloat16)):
        xb = torch.zeros((1, cfg.moe.n_experts, 2, cfg.d_model))
        assert M._expert_ffn(tcfg, p, xb).dtype == torch.bfloat16
        y, _ = M.apply_moe(tcfg, p, t)
        jy, _ = RM.apply_moe(jtcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), rtol=2e-2,
                               atol=2e-2)
