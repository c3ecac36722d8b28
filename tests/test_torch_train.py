"""Parity of the port's training loss and gradients
(``models.layers.chunked_cross_entropy``, ``models.transformer.loss_fn``,
``forward(remat=)``) with the reference's, on reduced models whose
parameters the reference draws and ``interop.params_from_jax`` carries
across.

Tolerances (f32 throughout): the loss within 1e-5 (the same arithmetic,
other summation orders) and gradients within 1e-4 against ``jax.grad`` of
the reference's ``loss_fn``, relative to each leaf's largest magnitude.
The three remat policies run the same operations, so their losses and
gradients agree to 1e-6.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCH_IDS
from repro.configs import get_arch as jget_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.tree import leaves, tree_map

B, S, CHUNK = 2, 16, 8  # S a multiple of the reduced recurrent chunk (8)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tests run beside others under xdist."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(arch):
    jcfg, cfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    jp = JT.init_params(jcfg, jax.random.key(0))
    p = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    return jcfg, jp, cfg, p


def _batch(cfg, seed=0):
    """numpy tokens / targets (B, S), with whisper's frames and pixtral's
    patches where the arch has them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.encoder is not None:
        batch["frame_embeds"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
            if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def _leaf_close(got, want, tol):
    """Within tol relative to the leaf's largest magnitude (None: a leaf
    the loss does not reach, whose gradient is zero)."""
    want = np.asarray(want, np.float32)
    if got is None:
        got = torch.zeros(want.shape)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol,
                               atol=atol)


def _port_grads(cfg, p, batch, **kw):
    live = _requires_grad(p)
    loss, metrics = T.loss_fn(cfg, live, _torch(batch), loss_chunk=CHUNK,
                              **kw)
    flat = leaves(live)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss, metrics, flat, grads


def _requires_grad(tree):
    return tree_map(lambda t: t.detach().clone().requires_grad_(), tree)


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma2-27b"])
def test_chunked_cross_entropy_matches_reference(arch):
    """Tied (olmo) and untied table with the final softcap (gemma2), three
    chunks; the value and the gradients of the hidden states and table."""
    jcfg, jp, cfg, p = _models(arch)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 3 * CHUNK, cfg.d_model)).astype(np.float32)
    t = rng.integers(0, cfg.vocab, (B, 3 * CHUNK)).astype(np.int32)

    def jloss(xx, emb):
        return JL.chunked_cross_entropy(jcfg, emb, xx, jnp.asarray(t),
                                        chunk=CHUNK)

    want, (jgx, jge) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jp["embed"])
    tx = torch.from_numpy(x).requires_grad_()
    emb = {k: v.detach().clone().requires_grad_()
           for k, v in p["embed"].items()}
    got = L.chunked_cross_entropy(cfg, emb, tx, torch.from_numpy(t).long(),
                                  chunk=CHUNK)
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(want)) <= LOSS_TOL * abs(float(want))
    _leaf_close(tx.grad, jgx, GRAD_TOL)
    for name in emb:
        _leaf_close(emb[name].grad, jge[name], GRAD_TOL)
    with pytest.raises(AssertionError):  # the reference's divisibility
        L.chunked_cross_entropy(cfg, emb, tx[:, :-1],
                                torch.from_numpy(t[:, :-1]).long(),
                                chunk=CHUNK)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_fn_matches_reference(arch):
    """Every architecture, reduced: the loss, ce and MoE aux of
    ``loss_fn`` (whisper with frames, pixtral with patches; MoE archs
    under their configured dispatch)."""
    jcfg, jp, cfg, p = _models(arch)
    batch = _batch(cfg)
    jl, jm = JT.loss_fn(jcfg, jp, _jax(batch), loss_chunk=CHUNK)
    with torch.no_grad():
        tl, tm = T.loss_fn(cfg, p, _torch(batch), loss_chunk=CHUNK)
    assert tl.dtype == torch.float32 and tl.dim() == 0
    for got, want in ((tl, jl), (tm["ce"], jm["ce"]),
                      (tm["moe_aux"], jm["moe_aux"])):
        assert abs(float(got) - float(want)) <= LOSS_TOL * max(
            1.0, abs(float(want))), (arch, float(got), float(want))


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen1.5-4b", "gemma2-27b",
                                  "rwkv6-7b", "whisper-large-v3",
                                  "pixtral-12b"])
def test_gradients_match_jax_grad(arch):
    """Every parameter's gradient against ``jax.grad`` of the reference's
    loss: olmo (tied table, non-parametric norms), qwen1.5 (qkv bias),
    gemma2 (sliding window, attention and final softcaps, post-norms),
    rwkv6 (the wkv chunk op's reverse recurrence, two chunks), whisper
    (the encoder and cross-attention, from frames) and pixtral (the patch
    prefix): the one-device base the sharded steps are held to."""
    jcfg, jp, cfg, p = _models(arch)
    batch = _batch(cfg, seed=2)
    (jl, _), jg = jax.value_and_grad(
        lambda pp: JT.loss_fn(jcfg, pp, _jax(batch), loss_chunk=CHUNK),
        has_aux=True)(jp)
    want = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jg),
                                   device="cpu")
    loss, _, flat, grads = _port_grads(cfg, p, batch)
    loss = loss.detach()
    assert abs(float(loss) - float(jl)) <= LOSS_TOL * float(jl)
    wflat = leaves(want)
    assert len(wflat) == len(grads)
    for g, w in zip(grads, wflat):
        _leaf_close(g, w.numpy(), GRAD_TOL)


class _CountMM(TorchDispatchMode):
    """Counts 2-D matmuls (mm / addmm) dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma2-27b"])
def test_remat_policies_agree(arch):
    """none, full and dots: equal losses and gradients.  The backward of
    ``full`` recomputes every layer's 2-D matmuls; ``dots`` saved them, so
    its backward runs as many as ``none``'s (the recomputed rest — norms,
    rope, the attention loop's batched products — is no mm)."""
    _, _, cfg, p = _models(arch)
    batch = _batch(cfg, seed=3)
    out, mms = {}, {}
    for remat in ("none", "full", "dots"):
        live = _requires_grad(p)
        loss, _ = T.loss_fn(cfg, live, _torch(batch), loss_chunk=CHUNK,
                            remat=remat)
        with _CountMM() as count:
            grads = torch.autograd.grad(loss, leaves(live))
        out[remat] = (loss.detach(), grads)
        mms[remat] = count.n
    base_loss, base = out["none"]
    for remat in ("full", "dots"):
        loss, grads = out[remat]
        assert abs(float(loss) - float(base_loss)) <= 1e-6
        for g, w in zip(grads, base):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    # q, k, v, o and the gated MLP's three per layer; the recompute stops
    # once every tensor the backward needs is back, so without a post-norm
    # after it w_out's product is not redone
    per_layer = 7 if cfg.post_norm else 6
    assert mms["dots"] == mms["none"]
    assert mms["full"] == mms["none"] + per_layer * cfg.n_layers


def test_unknown_remat_raises():
    _, _, cfg, p = _models("olmo-1b")
    with pytest.raises(ValueError, match="remat"):
        T.forward(cfg, p, torch.zeros((1, 8), dtype=torch.long),
                  remat="some")
