"""Parity of the port's optimizer (``repro_torch.optim``) with the
reference's ``repro.optim`` on identical trees made from numpy.

The AdamW step (f32 and bf16 parameters, f32 and bf16 moments, clipping
on and off, weight decay on and off, an lr scale), both schedules and the
gradient compression must agree bit for bit or within 1e-7: the same f32
operations in the same order on each element.  The compression's error
feedback telescopes: the applied bf16 payloads plus the last residual sum
to the true gradients.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as J
from repro_torch import optim as O
from repro_torch.optim.tree import leaves, named_leaves, tree_map

TOL = 1e-7
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((16, 8)) * scale).astype(np.float32),
            "blocks": [{"b": (rng.standard_normal(8) * scale)
                        .astype(np.float32)} for _ in range(2)],
            "s": np.float32(rng.standard_normal() * scale)}


def _jax(tree, dtype):
    if isinstance(tree, dict):
        return {k: _jax(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax(v, dtype) for v in tree]
    return jnp.asarray(tree, _J[dtype])


def _torch(tree, dtype):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32))
                    .to(_T[dtype]), tree)


def _jnamed(tree) -> dict:
    """name -> leaf of a jax tree, names as ``named_leaves`` gives them
    (jax orders dict keys by sort, the port as stored)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"__".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): leaf for path, leaf in flat}


def _pairs(got, want):
    wn = _jnamed(want)
    gn = named_leaves(got)
    assert sorted(wn) == sorted(n for n, _ in gn)
    return [(g, wn[n]) for n, g in gn]


def _assert_tree_close(got, want, tol=TOL):
    for g, w in _pairs(got, want):
        w32 = np.asarray(jnp.asarray(w, jnp.float32))
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_allclose(g.float().numpy(), w32, rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("p_dtype,m_dtype,clip,wd", [
    ("float32", "float32", 1.0, 0.1),
    ("float32", "float32", None, 0.0),
    ("bfloat16", "float32", 1.0, 0.1),
    ("bfloat16", "bfloat16", 1.0, 0.1),
    ("float32", "bfloat16", 0.5, 0.0),
])
def test_adamw_matches_reference(p_dtype, m_dtype, clip, wd):
    """Three updates from the same state: params, mu, nu, step and the
    grad norm.  Grads of norm ~ 10 so clipping bites where it is on."""
    cfg = dict(lr=1e-2, weight_decay=wd, clip_norm=clip, moment_dtype=m_dtype)
    jcfg, tcfg = J.AdamWConfig(**cfg), O.AdamWConfig(**cfg)
    params = _np_tree(0)
    jp, tp = _jax(params, p_dtype), _torch(params, p_dtype)
    js, ts = J.adamw_init(jcfg, jp), O.adamw_init(tcfg, tp)
    _assert_tree_close(ts["mu"], js["mu"])
    for step in range(3):
        grads = _np_tree(10 + step, scale=3.0)
        lr_scale = 0.5 if step == 2 else 1.0
        jp, js, jm = J.adamw_update(jcfg, jp, _jax(grads, p_dtype), js,
                                    lr_scale)
        tp, ts, tm = O.adamw_update(tcfg, tp, _torch(grads, p_dtype), ts,
                                    lr_scale)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TOL)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        _assert_tree_close(tp, jp)
        _assert_tree_close(ts["mu"], js["mu"])
        _assert_tree_close(ts["nu"], js["nu"])


def test_global_norm_matches_reference():
    tree = _np_tree(3, scale=5.0)
    for dtype in ("float32", "bfloat16"):
        want = float(J.global_norm(_jax(tree, dtype)))
        got = O.global_norm(_torch(tree, dtype))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=TOL)


@pytest.mark.parametrize("total,warmup,final", [(100, 10, 0.1), (7, 0, 0.0),
                                                (50, 50, 0.2)])
def test_schedules_match_reference(total, warmup, final):
    steps = np.arange(0, total + 5, dtype=np.int32)
    want_cos = J.cosine_schedule(jnp.asarray(steps), total, final)
    got_cos = O.cosine_schedule(torch.from_numpy(steps), total, final)
    np.testing.assert_allclose(got_cos.numpy(), np.asarray(want_cos),
                               rtol=TOL, atol=TOL)
    want = J.linear_warmup_cosine(jnp.asarray(steps), warmup, total, final)
    got = O.linear_warmup_cosine(torch.from_numpy(steps), warmup, total,
                                 final)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_compress_grads_bit_for_bit_and_telescoping():
    """Five steps of compression with feedback: each payload (bf16) and
    residual (f32) equal to the reference's bit for bit, and the applied
    payloads plus the last residual sum to the true gradient sum."""
    params = _np_tree(0)
    jr = J.init_compress_state(_jax(params, "float32"))
    tr = O.init_compress_state(_torch(params, "float32"))
    applied = tree_map(lambda a: torch.zeros(np.shape(a), dtype=torch.float64),
                       params)
    true = tree_map(lambda a: torch.zeros(np.shape(a), dtype=torch.float64),
                    params)
    for step in range(5):
        grads = _np_tree(20 + step, scale=1e-2)
        jq, jr = J.compress_grads(_jax(grads, "float32"), jr)
        tq, tr = O.compress_grads(_torch(grads, "float32"), tr)
        for g, w in _pairs(tq, jq):
            assert g.dtype == torch.bfloat16
            assert torch.equal(g.float(), torch.from_numpy(
                np.array(jnp.asarray(w, jnp.float32))))
        for g, w in _pairs(tr, jr):
            assert g.dtype == torch.float32
            assert torch.equal(g, torch.from_numpy(np.array(w)))
        applied = tree_map(lambda a, q: a + q.double(), applied, tq)
        true = tree_map(lambda a, g: a + torch.from_numpy(
            np.asarray(g, np.float32)).double(), true, grads)
    for (name, a), r, t in zip(named_leaves(applied), leaves(tr),
                               leaves(true)):
        err = float((a + r.double() - t).abs().max())
        assert err <= 1e-8, name  # f32 residual arithmetic, exact to ~1e-9
        # without feedback the error would be bf16's ~4e-3 relative
        assert float((a - t).abs().max()) > err


def test_adamw_leaves_params_without_grad_history():
    """The update returns new tensors and keeps the inputs as they were."""
    cfg = O.AdamWConfig(lr=1.0)
    p = _torch(_np_tree(1), "float32")
    before = [x.clone() for x in leaves(p)]
    s = O.adamw_init(cfg, p)
    new_p, _, _ = O.adamw_update(cfg, p, _torch(_np_tree(2), "float32"), s)
    for x, y, z in zip(leaves(p), before, leaves(new_p)):
        assert torch.equal(x, y) and not torch.equal(x, z)
        assert not z.requires_grad


def test_compressed_allreduce_matches_reference_expectations():
    """``check_compressed_allreduce`` on a (4,) data mesh of ranks: every
    rank's synced gradient is the mean of the bf16 payloads, and each
    rank's residual is its quantization error exactly."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import Shards

    mesh = make_mesh((4,), ("data",), "cpu")
    g = (np.random.default_rng(0).standard_normal((4, 64)) * 1e-2).astype(
        np.float32)
    gt = torch.from_numpy(g)
    synced, resid = O.compressed_allreduce(
        mesh, {"w": Shards(gt[i] for i in range(4))},
        {"w": Shards(torch.zeros(64) for _ in range(4))}, axis="data")
    want = np.asarray(jnp.mean(jnp.asarray(g).astype(jnp.bfloat16)
                               .astype(jnp.float32), 0))
    q = np.asarray(jnp.asarray(g).astype(jnp.bfloat16), np.float32)
    for i in range(4):
        assert synced["w"][i].dtype == torch.float32
        np.testing.assert_allclose(synced["w"][i].numpy(), want, rtol=2e-2,
                                   atol=1e-4)
        np.testing.assert_allclose(resid["w"][i].numpy(), g[i] - q[i],
                                   atol=1e-7)


def test_sharded_global_norm_counts_each_shard_once():
    """A leaf split over data and replicated over model, and one
    replicated everywhere: the norm is the full tree's."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import P, shard

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rng = np.random.default_rng(3)
    full = {"w": torch.from_numpy(rng.standard_normal((8, 6))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(6).astype(np.float32))}
    specs = {"w": P("data", None), "b": P(None)}
    sharded = {k: shard(mesh, v, specs[k]) for k, v in full.items()}
    got = O.sharded_global_norm(mesh, sharded, specs)
    want = O.global_norm(full)
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)
