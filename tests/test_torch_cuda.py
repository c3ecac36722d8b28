"""Checks that need the card: each CUDA kernel against its plain version
and oracle (block_spgemm at every group layout the tuner may pick), the
launch counters, and the slices on CUDA tensors (the distributed engines,
the sharded sweep and one measured tuner decision with every rank on the
card included; the reduced recurrent models, whisper with frames and
pixtral with patches against the CPU, and the memory of a full-width
mamba prefill).  Marked ``gpu``; each
test skips without a CUDA device.  On the card (no jax needed):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import bsm as B
from repro_torch.core import engine as E
from repro_torch.core import signiter as S
from repro_torch.core import transport as TR
from repro_torch.kernels import block_spgemm as K
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref, stacks
from repro_torch.launch.mesh import make_spgemm_mesh
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serving.engine import GenerationConfig, ServingEngine

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 in the oracles
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 4, 4), (23, 23, 23), (4, 16, 8),
                                   (64, 64, 64), (128, 128, 128)])
def test_kernel_matches_plain_and_oracle(cuda, shape, dtype):
    bs_r, bs_k, bs_c = shape
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((5, 6, bs_r, bs_k)) / np.sqrt(bs_k))
    b = torch.from_numpy(rng.standard_normal((6, 4, bs_k, bs_c)) / np.sqrt(bs_k))
    a, b = a.to(cuda, dtype), b.to(cuda, dtype)
    ok = torch.from_numpy(rng.random((5, 6, 4)) < 0.4).to(cuda)
    st = stacks.compact_pair_mask(
        ok, capacity=stacks.bucket_capacity(stacks.product_count(ok)))
    before = K.launches
    got = K.block_spgemm_stacks(a, b, st, ni=5, nj=4)
    assert K.launches == before + 1
    tol = TOL[dtype]
    for want in (K.block_spgemm_stacks_plain(a, b, st, ni=5, nj=4),
                 ref.block_spgemm_ref(a, b, ok)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(23, 23, 23), (4, 16, 8), (30, 7, 25),
                                   (128, 24, 100)])
def test_kernel_group_edges_and_partial_masks(cuda, shape, dtype):
    """9 x 7 output blocks against 4 x 4 (or 3 x 3, 1 x 1) groups: ragged
    group edges; blocks scaled by 10^U(-2, 0) so threshold 0.05 filters
    part of each group's products, and some blocks hold inf, which only
    filtered products may meet."""
    bs_r, bs_k, bs_c = shape
    ni, nk, nj = 9, 6, 7
    rng = np.random.default_rng(2)
    a = rng.standard_normal((ni, nk, bs_r, bs_k)) / np.sqrt(bs_k)
    b = rng.standard_normal((nk, nj, bs_k, bs_c)) / np.sqrt(bs_k)
    a *= 10.0 ** rng.uniform(-2, 0, (ni, nk, 1, 1))
    b *= 10.0 ** rng.uniform(-2, 0, (nk, nj, 1, 1))
    a, b = (torch.from_numpy(x).to(cuda, dtype) for x in (a, b))
    am = torch.from_numpy(rng.random((ni, nk)) < 0.6).to(cuda)
    bm = torch.from_numpy(rng.random((nk, nj)) < 0.6).to(cuda)
    ok = stacks.pair_cube(am, bm, B.block_norms(a), B.block_norms(b), 0.05)
    assert 0 < int(ok.sum()) < int((am[:, :, None] & bm[None]).sum())
    st = stacks.compact_pair_mask(
        ok, capacity=stacks.bucket_capacity(stacks.product_count(ok)))
    want = K.block_spgemm_stacks_plain(a, b, st, ni=ni, nj=nj)
    # a block none of whose products survives may hold anything
    dead_a = ~ok.any(2)
    a = a.masked_fill(dead_a[:, :, None, None], float("inf"))
    before = K.launches
    got = K.block_spgemm_stacks(a, b, st, ni=ni, nj=nj)
    assert K.launches == before + 1
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(23, 23, 23), (4, 16, 8), (30, 7, 25)])
def test_every_group_layout_matches_plain(cuda, shape, dtype):
    """The default layout, the default halved per edge and one block per
    CTA launch and agree with the plain version over ragged group edges
    and a threshold that filters part of a group."""
    bs_r, bs_k, bs_c = shape
    ni, nk, nj = 9, 6, 7
    rng = np.random.default_rng(5)
    a = rng.standard_normal((ni, nk, bs_r, bs_k)) / np.sqrt(bs_k)
    b = rng.standard_normal((nk, nj, bs_k, bs_c)) / np.sqrt(bs_k)
    a *= 10.0 ** rng.uniform(-2, 0, (ni, nk, 1, 1))
    a, b = (torch.from_numpy(x).to(cuda, dtype) for x in (a, b))
    am = torch.from_numpy(rng.random((ni, nk)) < 0.6).to(cuda)
    bm = torch.from_numpy(rng.random((nk, nj)) < 0.6).to(cuda)
    ok = stacks.pair_cube(am, bm, B.block_norms(a), B.block_norms(b), 0.05)
    st = stacks.compact_pair_mask(
        ok, capacity=stacks.bucket_capacity(stacks.product_count(ok)))
    want = K.block_spgemm_stacks_plain(a, b, st, ni=ni, nj=nj)
    d_r, d_c = K.kernel_tile(bs_r, bs_c)[:2]
    layouts = [None, (max(1, d_r // 2), max(1, d_c // 2)), (1, 1)]
    tol = TOL[dtype]
    for g in layouts:
        before = K.launches
        got = K.block_spgemm_stacks(a, b, st, ni=ni, nj=nj, group=g)
        assert K.launches == before + 1, g
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=str(g))


def test_measured_autotune_on_the_card(tmp_path):
    """One measured ``engine="auto"`` multiply on a 2 x 2 mesh of ranks on
    the card: CUDA candidates only, no trial error, the kernel launched by
    the cuda trials, C equal to the single-device oracle, a database
    record naming the card, and a warm hit with no trial."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import tuner
    from repro_torch.core import plan

    cuda = torch.device("cuda")
    h = B.random_bsm(0, nb=16, bs=23, occupancy=0.2, pattern="decay",
                     symmetric=True, device=cuda)
    mesh = make_spgemm_mesh(p=2, device=cuda)
    plan.clear_cache()
    tuner.set_default_db(str(tmp_path / "db.json"))
    before = K.launches
    c = E.multiply(h, h, mesh, engine="auto", threshold=1e-9)
    run = tuner.last_run()
    assert run.trials and all(not err for _, _, err in run.trials)
    assert all("/stacks" not in label for label, _, _ in run.trials)
    if any("/cuda" in label for label, _, _ in run.trials):
        assert K.launches > before
    want = E.multiply_reference(h, h, threshold=1e-9, backend="cuda")
    assert torch.equal(c.mask, want.mask)
    torch.testing.assert_close(c.blocks, want.blocks, rtol=1e-5, atol=1e-5)
    rec = next(iter(tuner.get_default_db().records.values()))
    assert rec["device"] == "cuda:" + torch.cuda.get_device_name(cuda)
    trials = plan.cache_stats()["tuner_trials"]
    E.multiply(h, h, mesh, engine="auto", threshold=1e-9)
    assert plan.cache_stats()["tuner_trials"] == trials
    plan.clear_cache()


def test_empty_list_launches_nothing(cuda):
    a = torch.ones(2, 3, 8, 8, device=cuda)
    ok = torch.zeros(2, 3, 2, dtype=torch.bool, device=cuda)
    before = K.launches
    c = K.block_spgemm(a, a.permute(1, 0, 2, 3).contiguous(), ok)
    assert K.launches == before and not bool(c.any())


def test_multiply_and_density_matrix_on_cuda(cuda):
    h = B.random_bsm(0, nb=16, bs=23, occupancy=0.2, pattern="decay",
                     symmetric=True, device=cuda)
    c = E.multiply(h, h, backend="cuda", threshold=1e-9)
    d = E.multiply(h, h, backend="stacks", threshold=1e-9)
    torch.testing.assert_close(c.blocks, d.blocks, rtol=1e-5, atol=1e-5)
    assert torch.equal(c.mask, d.mask)
    before = K.launches
    p, stats = S.density_matrix(h, 0.0, backend="cuda", max_iter=100,
                                tol=1e-6)
    assert stats.converged and K.launches - before == 2 * stats.iterations
    w = torch.linalg.eigvalsh(h.to_dense().double())
    assert abs(float(S.trace(p)) - int((w < 0).sum())) < 0.05


# (engine, mesh, l, c_layout): every engine body, every rank on the card
ENGINE_CASES = [
    ("cannon", dict(p=2), None, "2d"),
    ("onesided", dict(p_r=2, p_c=4), None, "2d"),
    ("gather", dict(p=2), None, "2d"),
    ("twofive", dict(p_r=2, p_c=4), None, "2d"),
    ("twofive", dict(p=4), 4, "2d"),
    ("twofive", dict(p=2, l=2), None, "2d"),
    ("twofive", dict(p=2, l=2), None, "scatter"),
    ("twofive", dict(p=2, l=4), None, "2d"),
]


@pytest.mark.parametrize("engine,mk,l,layout", ENGINE_CASES, ids=str)
def test_engines_match_the_single_device_kernel(cuda, engine, mk, l,
                                                layout):
    h = B.random_bsm(0, nb=32, bs=23, occupancy=0.1, pattern="decay",
                     symmetric=True, device=cuda)
    want = E.multiply_reference(h, h, threshold=1e-9, backend="cuda")
    mesh = make_spgemm_mesh(**mk, device=cuda)
    before = K.launches
    TR.reset_bytes()
    got = E.multiply(h, h, mesh, engine=engine, l=l, c_layout=layout,
                     backend="cuda", threshold=1e-9, filter_eps=0.0)
    assert K.launches > before and TR.bytes_moved() > 0
    assert got.device == want.device and torch.equal(got.mask, want.mask)
    torch.testing.assert_close(got.blocks, want.blocks, rtol=1e-5, atol=1e-5)


def test_sharded_density_matrix_on_cuda(cuda):
    h = B.random_bsm(0, nb=16, bs=23, occupancy=0.2, pattern="decay",
                     symmetric=True, device=cuda)
    kw = dict(backend="cuda", threshold=1e-9, filter_eps=1e-8, max_iter=100,
              tol=1e-6)
    want, st1 = S.density_matrix(h, 0.0, **kw)
    mesh = make_spgemm_mesh(p=2, l=2, device=cuda)
    before = K.launches
    got, st2 = S.density_matrix(B.shard_bsm(h, mesh), 0.0, **kw)
    assert isinstance(got, B.ShardedBSM) and K.launches > before
    assert st2.converged and abs(st2.iterations - st1.iterations) <= 1
    torch.testing.assert_close(got.unshard().blocks, want.blocks, rtol=1e-5,
                               atol=1e-5)
    assert abs(float(S.trace(got)) - float(S.trace(want))) < 1e-4


@pytest.mark.parametrize("capacity", [4, 64, 512])
def test_pack_panel_syncs_nothing_and_matches_cpu(cuda, capacity):
    """``pack_panel`` / ``unpack_panel`` on the card run without a host
    sync (CUDA sync debug mode raises on one) and equal the CPU's result
    element for element; a covering capacity decodes the panel exactly."""
    rng = np.random.default_rng(capacity)
    mask = torch.from_numpy(rng.random((16, 24)) < 0.3)
    blocks = torch.from_numpy(rng.standard_normal((16, 24, 23, 23),
                                                  dtype=np.float32))
    blocks = blocks * mask[:, :, None, None]
    want = TR.pack_panel(blocks, mask, capacity)
    bc, mc = blocks.to(cuda), mask.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed, idx1 = TR.pack_panel(bc, mc, capacity)
        db, dm = TR.unpack_panel(packed, idx1, 16, 24)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(packed.cpu(), want[0])
    assert torch.equal(idx1.cpu(), want[1])
    if capacity >= int(mask.sum()):
        assert torch.equal(db, bc) and torch.equal(dm, mc)


@pytest.mark.parametrize("engine,mk,l", [("twofive", dict(p=2, l=2), None),
                                         ("gather", dict(p=2), None)],
                         ids=str)
def test_compressed_equals_dense_on_cuda(cuda, engine, mk, l):
    """Compressed panels on the card: C equal to dense transport's bit for
    bit, the kernel launched, and the bytes of the resolved transport."""
    from repro_torch.core import commvolume as CV
    from repro_torch.core import plan as P

    h = B.random_bsm(0, nb=32, bs=23, occupancy=0.1, pattern="decay",
                     symmetric=True, device=cuda)
    mesh = make_spgemm_mesh(**mk, device=cuda)
    out = {}
    for mode in ("dense", "compressed"):
        before = K.launches
        TR.reset_bytes()
        out[mode] = E.multiply(h, h, mesh, engine=engine, l=l, backend="cuda",
                               threshold=1e-9, transport=mode)
        tr = P.resolve_transport(mode, h, h, mesh, engine, l)
        assert tr.compressed == (mode == "compressed")
        assert K.launches > before and TR.bytes_moved() == CV.plan_volume(
            P.plan_multiply(mesh, engine, l), 32, 23, itemsize=4,
            transport=tr).total
    assert torch.equal(out["dense"].mask, out["compressed"].mask)
    assert torch.equal(out["dense"].blocks, out["compressed"].blocks)


# kernel vs plain: f32 up to summation order; bf16 the kernel's rounding of
# p to bf16 before P.V (the TPU kernel's), which the plain loop skips —
# the reference's own bf16 tolerance (tests/test_kernels.py)
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# (b, h, hkv, sq, skv, d, causal, window, softcap)
FLASH_CASES = [
    (1, 1, 1, 128, 128, 64, True, None, None),
    (1, 1, 1, 128, 128, 64, False, None, None),
    (1, 2, 2, 256, 256, 64, True, 32, None),
    (1, 2, 2, 256, 256, 64, True, 128, None),
    (1, 1, 1, 128, 128, 64, True, None, 50.0),
    (2, 8, 2, 128, 128, 32, True, None, None),
    (2, 4, 4, 200, 200, 64, True, None, None),
    (1, 2, 1, 128, 256, 128, True, None, None),
    (1, 2, 1, 256, 128, 128, False, None, None),
    (2, 4, 2, 333, 333, 128, True, 100, 30.0),
    (2, 8, 2, 200, 200, 32, True, None, None),
    (1, 8, 2, 200, 328, 64, True, 64, None),
    (1, 8, 2, 333, 200, 128, False, None, 30.0),
    (2, 8, 2, 256, 256, 32, True, 16, 50.0),
    # whisper: the encoder's self-attention over 1,500 frames (a 92-key
    # tail past the last 128-key tile) and the decoder's cross-attention
    (2, 20, 20, 1500, 1500, 64, False, None, None),
    (2, 20, 20, 32, 1500, 64, False, None, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernel_matches_plain_and_oracle(cuda, case, dtype):
    b, h, hkv, sq, skv, d, causal, window, softcap = case
    rng = np.random.default_rng(1)
    scale_in = 4.0 if softcap else 1.0
    q = torch.from_numpy(rng.standard_normal((b, h, sq, d)) * scale_in)
    k = torch.from_numpy(rng.standard_normal((b, hkv, skv, d)) * scale_in)
    v = torch.from_numpy(rng.standard_normal((b, hkv, skv, d)))
    q, k, v = (t.to(cuda, dtype) for t in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = FA.launches
    got = FA.flash_attention(q, k, v, **kw)
    assert FA.launches == before + 1
    plain = FA.flash_attention_plain(q, k, v, **kw)
    rep = h // hkv
    oracle = ref.attention_ref(q, k.repeat_interleave(rep, 1),
                               v.repeat_interleave(rep, 1), **kw)
    tol = FLASH_TOL[dtype]
    for want in (plain, oracle):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("layout", ["transposed", "stride d+4", "offset"])
def test_flash_bf16_layouts(cuda, layout):
    """The projections' head-transposed views go to TMA as they are; a view
    whose strides TMA cannot take is copied once per tensor (``copies``);
    a query offset shifts the causal diagonal.  All against the plain
    version."""
    b, h, hkv, s, d = 2, 8, 2, 200, 128
    pad = 4 if layout == "stride d+4" else 0
    rng = np.random.default_rng(3)

    def make(heads):
        x = torch.from_numpy(rng.standard_normal((b, s, heads, d + pad)))
        x = x.to(cuda, torch.bfloat16).transpose(1, 2)
        return x[..., :d] if layout != "offset" else x.contiguous()

    q, k, v = make(h), make(hkv), make(hkv)
    kw = dict(causal=True, q_offset=56 if layout == "offset" else 0)
    before = FA.copies
    got = FA.flash_attention(q, k, v, **kw)
    assert FA.copies - before == (3 if pad else 0)
    want = FA.flash_attention_plain(q, k, v, **kw)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_reduced_model_cuda_matches_cpu(cuda):
    """The same parameters on the card and the CPU: prefill (one flash
    launch per layer) and decode steps with per-slot positions, logits
    within 1e-4 (f32)."""
    cfg = get_arch("olmo-1b").reduced()
    p_cpu = T.init_params(cfg, 0, device="cpu")
    p_dev = _to(p_cpu, cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 150)))
    c_cpu = T.init_cache(cfg, 3, 200, device="cpu")
    c_dev = T.init_cache(cfg, 3, 200, device=cuda)
    before = FA.launches
    l_dev, c_dev = T.prefill(cfg, p_dev, toks.to(cuda), c_dev)
    assert FA.launches - before == cfg.n_layers
    l_cpu, c_cpu = T.prefill(cfg, p_cpu, toks, c_cpu)
    torch.testing.assert_close(l_dev.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
    pos = torch.tensor([150, 140, 149])
    for _ in range(3):
        t = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1)))
        l_dev, c_dev = T.decode_step(cfg, p_dev, t.to(cuda), c_dev,
                                     pos.to(cuda))
        l_cpu, c_cpu = T.decode_step(cfg, p_cpu, t, c_cpu, pos)
        torch.testing.assert_close(l_dev.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
        pos = pos + 1


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-7b"])
def test_reduced_recurrent_model_cuda_matches_cpu(cuda, arch):
    """The reduced recurrent archs (f32), the same parameters on the card
    and the CPU: prefill (one flash launch per attention layer: 2 of
    jamba's 16, none of rwkv6's) and decode steps with per-slot
    positions, logits within 1e-4; every state leaf after the prefill
    too."""
    cfg = get_arch(arch).reduced()
    p_cpu = T.init_params(cfg, 0, device="cpu")
    p_dev = _to(p_cpu, cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 64)))
    c_cpu = T.init_cache(cfg, 3, 80, device="cpu")
    c_dev = T.init_cache(cfg, 3, 80, device=cuda)
    before = FA.launches
    l_dev, c_dev = T.prefill(cfg, p_dev, toks.to(cuda), c_dev)
    n_attn = sum(k["mixer"] == "attention" for k in T.layer_kinds(cfg))
    assert FA.launches - before == n_attn
    l_cpu, c_cpu = T.prefill(cfg, p_cpu, toks, c_cpu)
    torch.testing.assert_close(l_dev.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
    for got, want in zip(c_dev["blocks"], c_cpu["blocks"]):
        for name in want:
            torch.testing.assert_close(got[name].cpu(), want[name],
                                       rtol=1e-4, atol=1e-4)
    pos = torch.tensor([64, 60, 63])
    for _ in range(3):
        t = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1)))
        l_dev, c_dev = T.decode_step(cfg, p_dev, t.to(cuda), c_dev,
                                     pos.to(cuda))
        l_cpu, c_cpu = T.decode_step(cfg, p_cpu, t, c_cpu, pos)
        torch.testing.assert_close(l_dev.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
        pos = pos + 1


@pytest.mark.parametrize("arch", ["whisper-large-v3", "pixtral-12b"])
def test_reduced_encdec_and_fusion_cuda_matches_cpu(cuda, arch):
    """Reduced whisper with frames and pixtral with patches (f32), the same
    parameters and embeddings on the card and the CPU: prefill (flash
    launches: whisper's 2 encoder + 2 self + 2 cross layers, pixtral's 2;
    no input copied for TMA) and decode steps with per-slot positions,
    logits within 1e-4; whisper's cross cache too."""
    cfg = get_arch(arch).reduced()
    p_cpu = T.init_params(cfg, 0, device="cpu")
    p_dev = _to(p_cpu, cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 64)))
    if cfg.encoder is not None:
        n = cfg.encoder.n_frames
        name, launches = "frame_embeds", 3 * cfg.n_layers
    else:
        n, name, launches = cfg.n_patches, "patch_embeds", cfg.n_layers
    emb = torch.from_numpy(rng.standard_normal((3, n, cfg.d_model),
                                               dtype=np.float32))
    c_cpu = T.init_cache(cfg, 3, 80, device="cpu")
    c_dev = T.init_cache(cfg, 3, 80, device=cuda)
    before, copies = FA.launches, FA.copies
    l_dev, c_dev = T.prefill(cfg, p_dev, toks.to(cuda), c_dev,
                             **{name: emb.to(cuda)})
    assert FA.launches - before == launches and FA.copies == copies
    l_cpu, c_cpu = T.prefill(cfg, p_cpu, toks, c_cpu, **{name: emb})
    torch.testing.assert_close(l_dev.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
    for got, want in zip(c_dev["blocks"], c_cpu["blocks"]):
        for leaf in want:
            torch.testing.assert_close(got[leaf].cpu(), want[leaf],
                                       rtol=1e-4, atol=1e-4)
    pos = torch.tensor([64, 60, 63])
    for _ in range(3):
        t = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1)))
        l_dev, c_dev = T.decode_step(cfg, p_dev, t.to(cuda), c_dev,
                                     pos.to(cuda))
        l_cpu, c_cpu = T.decode_step(cfg, p_cpu, t, c_cpu, pos)
        torch.testing.assert_close(l_dev.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
        pos = pos + 1


def test_mamba_prefill_memory_stays_per_chunk(cuda):
    """One mamba layer at jamba's full width (d 4,096, d_inner 8,192,
    d_state 16, chunk 256), bf16, on 2 x 2,048 tokens: the peak above the
    inputs stays under one (B, S, d_inner, d_state) f32 tensor (2 GiB),
    where building the coefficients for the whole sequence would take
    three of them.  The regression guard for the chunked
    coefficients."""
    from repro_torch.models import mamba as M

    cfg = get_arch("jamba-v0.1-52b")
    di, n, _, _ = M.mamba_dims(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = M.init_mamba(cfg, gen, torch.bfloat16)
    b, s = 2, 2048
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=cuda).to(
        torch.bfloat16)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y, st = M.apply_mamba(cfg, p, x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - resident
    full = b * s * di * n * 4
    assert peak < full, (peak, full)
    assert bool(torch.isfinite(y).all() and torch.isfinite(st["ssm"]).all())


def test_serving_launches_flash_per_layer_per_prefill(cuda):
    cfg = get_arch("olmo-1b").reduced()
    eng = ServingEngine(cfg, T.init_params(cfg, 1, device=cuda), batch=2,
                        max_len=64, gen=GenerationConfig(max_new_tokens=4))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 20) for _ in range(5)]
    before = FA.launches
    outs = eng.serve(prompts)
    rounds = len(eng.last_serve_stats["prefills"])
    assert rounds == 3 and FA.launches - before == cfg.n_layers * rounds
    assert [len(o) for o in outs] == [4] * 5
    assert outs[4] == eng.generate([prompts[4]])[0]


# f8 storage: (mantissa bits, least normal exponent); kernel and plain
# version round f32 sums that differ in order only: one f8 ulp apart
F8 = {torch.float8_e4m3fn: (3, -6), torch.float8_e5m2: (2, -14)}


def _within_one_f8_ulp(got, want, dtype):
    mant, emin = F8[dtype]
    g, w = got.float(), want.float()
    top = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** emin)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - mant)
    assert bool(((g - w).abs() <= ulp).all())


@pytest.mark.parametrize("dtype", list(F8), ids=str)
@pytest.mark.parametrize("shape", [(4, 4, 4), (23, 23, 23), (4, 16, 8),
                                   (128, 24, 100)])
def test_f8_instances_match_plain_and_oracle(cuda, shape, dtype):
    bs_r, bs_k, bs_c = shape
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((5, 6, bs_r, bs_k)) / np.sqrt(bs_k))
    b = torch.from_numpy(rng.standard_normal((6, 4, bs_k, bs_c)) / np.sqrt(bs_k))
    a, b = a.float().to(cuda).to(dtype), b.float().to(cuda).to(dtype)
    ok = torch.from_numpy(rng.random((5, 6, 4)) < 0.5).to(cuda)
    st = stacks.compact_pair_mask(
        ok, capacity=stacks.bucket_capacity(stacks.product_count(ok)))
    before = K.launches
    got = K.block_spgemm_stacks(a, b, st, ni=5, nj=4)
    assert K.launches == before + 1 and got.dtype == dtype
    for want in (K.block_spgemm_stacks_plain(a, b, st, ni=5, nj=4),
                 ref.block_spgemm_ref(a, b, ok)):
        _within_one_f8_ulp(got, want, dtype)
    c = K.block_spgemm(a, b, ok)  # the masked wrapper, f8 zeroing included
    _within_one_f8_ulp(c, ref.block_spgemm_ref(a, b, ok), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_operands_read_in_place(cuda, dtype):
    """A stride-0 block-diagonal bank and a sliced A grid launch without a
    copy and match the plain version and their contiguous copies."""
    rng = np.random.default_rng(8)
    e, tb, d, de = 6, 4, 40, 30
    w = torch.from_numpy(rng.standard_normal((e, d, de)) / np.sqrt(d)).to(
        cuda, dtype)
    bank = w.unsqueeze(0).expand(e, e, d, de)
    a_full = torch.from_numpy(rng.standard_normal((9, e + 2, tb, d))).to(
        cuda, dtype)
    a = a_full[::2, 1:e + 1]  # strided grid, row-major blocks
    assert not a.is_contiguous() and K.rowmajor_blocks(a)
    ok = (torch.from_numpy(rng.random((5, e)) < 0.5).to(cuda)[:, :, None]
          & torch.eye(e, dtype=torch.bool, device=cuda)[None])
    st = stacks.compact_pair_mask(
        ok, capacity=stacks.bucket_capacity(stacks.product_count(ok)))
    got = K.block_spgemm_stacks(a, bank, st, ni=5, nj=e)
    tol = TOL[dtype]
    for want in (K.block_spgemm_stacks_plain(a, bank, st, ni=5, nj=e),
                 K.block_spgemm_stacks(a.contiguous(), bank.contiguous(), st,
                                       ni=5, nj=e)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_moe_shape_kernel_and_layer_on_cuda(cuda):
    """The kernel at deepseek-moe-16b's expert shape (4 x 2048 token
    blocks times the aliased 2048 x 1408 bank, 8 experts) against its plain
    version, and the spgemm MoE layer against the dense one."""
    import dataclasses

    from repro_torch.models import moe as M

    base = get_arch("deepseek-moe-16b")
    moe = dataclasses.replace(base.moe, n_experts=8, top_k=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cfgs = {impl: dataclasses.replace(base, moe=dataclasses.replace(
        moe, impl=impl)) for impl in ("dense", "spgemm")}
    p = M.init_moe(cfgs["dense"], gen, torch.bfloat16)
    x = torch.randn((2, 32, base.d_model), generator=gen, device=cuda).to(
        torch.bfloat16)
    before = K.launches
    ys, _, st = M.apply_moe(cfgs["spgemm"], p, x, collect_stats=True)
    assert K.launches - before == 3 and int(st["dropped"]) == 0
    yd, _ = M.apply_moe(cfgs["dense"], p, x)
    torch.testing.assert_close(ys.float(), yd.float(), rtol=3e-2, atol=3e-2)
    bank = M.diag_expert_bsm(p["w_in"])
    a = torch.randn((3, 8, 4, base.d_model), generator=gen,
                    device=cuda).to(torch.bfloat16)
    ok = torch.eye(8, dtype=torch.bool, device=cuda)[None].expand(3, 8, 8)
    st = stacks.compact_pair_mask(ok, capacity=32)
    got = K.block_spgemm_stacks(a, bank.blocks, st, ni=3, nj=8)
    want = K.block_spgemm_stacks_plain(a, bank.blocks, st, ni=3, nj=8)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# (b, h, hkv, sq, skv, d, causal, window, softcap, q_offset); the last
# three sit at the bf16 kernels' tile edges: 200 and 328 keys (a 128-key
# tile and a ragged one), a 129-row query tile
FLASH_BWD_CASES = [
    (1, 2, 2, 256, 256, 64, True, None, None, 0),
    (2, 8, 2, 200, 200, 32, True, None, None, 0),
    (1, 2, 1, 333, 333, 128, True, 100, 30.0, 0),
    (1, 4, 2, 128, 384, 128, True, None, None, 0),
    (1, 4, 2, 384, 128, 64, False, None, None, 0),
    (1, 2, 2, 300, 100, 64, True, 32, None, 0),  # rows that keep no key
    (1, 2, 2, 100, 228, 64, True, None, 50.0, 128),
    (1, 8, 2, 200, 200, 128, True, None, None, 0),
    (1, 8, 2, 264, 328, 128, True, None, None, 64),
    (2, 4, 2, 129, 129, 128, False, None, None, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=str)
def test_flash_backward_kernel_matches_plain(cuda, case, dtype):
    """The forward's lse against the plain one (+inf on the same rows),
    then the three backward kernels against the plain backward on the
    same out and lse: dq, dk and dv within ``chip_smoke.flash_bwd_ratio``'s
    limit (phase 22's: f32 1e-4 + 1e-4 |plain|; bf16 1e-2 / sqrt(kept
    pairs of the output's row or key) + 1e-2 |plain|); three launches; a
    second call on the same inputs gives the same bits."""
    import chip_smoke

    b, h, hkv, sq, skv, d, causal, window, softcap, q_offset = case
    rng = np.random.default_rng(2)
    amp = 4.0 if softcap else 1.0
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s) * a).to(cuda,
                                                                   dtype)
                   for s, a in (((b, h, sq, d), amp), ((b, hkv, skv, d), amp),
                                ((b, hkv, skv, d), 1.0), ((b, h, sq, d), 1.0)))
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    _, lse = FA.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    out, plse = FA.flash_attention_plain_lse(q, k, v, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(plse))
    fin = torch.isfinite(plse)
    torch.testing.assert_close(lse[fin], plse[fin], rtol=1e-5, atol=1e-4)
    before = FA.bwd_launches
    got = FA.flash_attention_backward_cuda(q, k, v, out, plse, do, **kw)
    assert FA.bwd_launches == before + FA.BWD_KERNELS
    want = FA.flash_attention_backward_plain(q, k, v, out, plse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
    kept = chip_smoke.flash_bwd_kept(torch, sq, skv, h // hkv, causal, window,
                                     q_offset, cuda)
    ratio, err = chip_smoke.flash_bwd_ratio(got, want, kept,
                                            str(dtype).split(".")[1])
    assert ratio <= 1.0, (ratio, err)
    again = FA.flash_attention_backward_cuda(q, k, v, out, plse, do, **kw)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_attention_gradient_on_cuda_goes_through_the_kernels(cuda):
    """``chunked_attention`` with inputs that require grad: one forward
    and BWD_KERNELS backward launches, gradients equal to the plain
    backward's on the kernel's own out and lse (f32)."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s)).to(cuda,
                                                                torch.float32)
                   for s in ((2, 4, 96, 64), (2, 2, 96, 64), (2, 2, 96, 64),
                             (2, 4, 96, 64)))
    live = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (FA.launches, FA.bwd_launches)
    out = A.chunked_attention(*live, causal=True, window=40)
    got = torch.autograd.grad(out, live, do)
    assert (FA.launches - before[0], FA.bwd_launches - before[1]) == (
        1, FA.BWD_KERNELS)
    o, lse = FA.flash_attention_cuda(q, k, v, causal=True, window=40,
                                     with_lse=True)
    want = FA.flash_attention_backward_cuda(q, k, v, o, lse, do, causal=True,
                                            window=40)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_block_spgemm_kernel_refuses_autograd(cuda):
    """The kernel has no backward: an operand that requires grad raises
    (under no_grad the same call launches)."""
    a = torch.randn(2, 2, 4, 4, device=cuda, requires_grad=True)
    b = torch.randn(2, 2, 4, 4, device=cuda)
    ok = torch.ones(2, 2, 2, dtype=torch.bool, device=cuda)
    with pytest.raises(NotImplementedError, match="15b"):
        K.block_spgemm(a, b, ok)
    before = K.launches
    with torch.no_grad():
        K.block_spgemm(a, b, ok)
    assert K.launches == before + 1


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_reduced_train_step_cuda_matches_cpu(cuda, remat):
    """One training step of reduced olmo-1b (f32) from the same parameters
    and batch on the card and the CPU: loss, grad norm and every leaf of
    params, mu and nu within 1e-4 (``chip_smoke.train_state_close``: an
    entry whose gradient is f32 rounding noise may move by up to 2 lr);
    flash launches per layer 1 (none) or 2 (full, dots: forward and
    recompute), backward launches BWD_KERNELS a layer."""
    import chip_smoke
    from repro_torch.config import ShapeConfig
    from repro_torch.data import DataConfig, SyntheticLMData, make_global_batch
    from repro_torch.launch import steps as ST
    from repro_torch.optim import AdamWConfig

    cfg = get_arch("olmo-1b").reduced()
    shape = ShapeConfig("train", 64, 4, "train")
    options = ST.StepOptions(remat=remat, loss_chunk=32)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=64,
                                      global_batch=4, seed=0))
    out = {}
    for dev in ("cpu", cuda):
        params = T.init_params(cfg, 0, device="cpu")
        params = _to(params, dev)
        opt = AdamWConfig(lr=3e-3)
        state = ST.init_opt_state(params, opt, options)
        step = ST.build_train_step(cfg, shape, opt=opt, options=options,
                                   device=dev)
        before = (FA.launches, FA.bwd_launches)
        p, s, m = step(params, state, make_global_batch(data, 0, dev))
        out[str(dev)] = (p, s, m, FA.launches - before[0],
                         FA.bwd_launches - before[1])
    pc, sc, mc, *_ = out["cpu"]
    pd, sd, md, fwd, bwd = out[str(cuda)]
    assert fwd == cfg.n_layers * (1 if remat == "none" else 2)
    assert bwd == cfg.n_layers * FA.BWD_KERNELS
    for name in ("loss", "grad_norm"):
        assert abs(float(md[name]) - float(mc[name])) <= 1e-4
    ok, worst = chip_smoke.train_state_close(torch, (pd, sd), (pc, sc),
                                             opt.lr, opt.b2)
    assert ok, worst
