"""The dry run's pieces (``repro_torch.roofline``, ``roofline/hlo_cost.py``,
``launch/dryrun.py``, ``config.shape_applicable`` / ``input_specs``,
``sharding.input_specs_sharded``, ``mesh.make_production_mesh``) against
the reference's, and the tracer against the steps it traces.

Pure functions are compared with the reference's on every arch x shape
(exact).  ``repro.launch.dryrun`` is imported only in a subprocess: its
import forces 512 host devices on jax, which would change the device count
of every other test on this worker.  Token ids are int64 in the port
(int32 in the reference; ``config.input_specs``).

The tracer: on reduced olmo-1b and gemma2-27b over (2, 2) and (2, 1, 2)
CPU meshes a fake-tensor trace of the sharded training step counts the
FLOPs and HBM bytes that the same counters count around the real step,
exactly, and ``FlopCounterMode`` agrees; its wire bytes are
``steps.step_bytes`` and the real step's ``bytes_moved``.  On ``meta``
ranks (the dry run's) traces of one and two layer-pattern periods
extended linearly give a direct trace of four periods exactly (FLOPs, HBM
bytes, wire bytes, arguments), and the peak of live bytes within 5 %
(each phase's peak and its live bytes at its last allocation extended on
their own; on the reduced meshes exactly, at olmo-1b's full width on one
device 1 % below, where the optimizer's embedding temporaries hold the
shallow traces' peak).  On fake ``meta:r`` ranks every rank counts the same
FLOPs in every step, the same bytes in serving, and in training the same
bytes up to the clipping norm's sums, which only the ranks that hold a
distinct shard of a leaf compute (at most 18 bytes per local gradient
element).
"""
from __future__ import annotations

import ast
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro import config as JC
from repro import roofline as JRL
from repro.configs import ARCH_IDS
from repro.configs import get_arch as jget_arch
from repro.parallel import sharding as JSH
from repro.roofline import hlo_cost as JHC
from repro_torch import config as C
from repro_torch import roofline as RL
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_arch
from repro_torch.core import transport as TR
from repro_torch.data import DataConfig, SyntheticLMData, make_global_batch
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig
from repro_torch.optim.tree import leaves
from repro_torch.parallel import sharding as SH
from repro_torch.roofline import hlo_cost as HC

ROOT = Path(__file__).resolve().parents[1]
DENSE = ("olmo_1b", "gemma2_27b", "qwen1_5_4b", "qwen2_72b")
MESHES = [((2, 2), ("data", "model")), ((2, 1, 2), ("pod", "data", "model"))]
MESH_IDS = ["d2m2", "p2d1m2"]
PEAK_TOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jmesh(axes):
    return AbstractMesh(tuple(axes.values()), tuple(axes))


# ---------------------------------------------------------------------------
# pure functions against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape_id", list(C.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_shapes_and_inputs_equal_reference(arch, shape_id):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    shape, jshape = C.SHAPES[shape_id], JC.SHAPES[shape_id]
    assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
    assert RL.model_flops(cfg, shape) == JRL.model_flops(jcfg, jshape)
    assert C.shape_applicable(cfg, shape) == JC.shape_applicable(jcfg, jshape)
    got, want = C.input_specs(cfg, shape), JC.input_specs(jcfg, jshape)
    assert list(got) == list(want)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[name].shape)
        wdt = str(want[name].dtype)
        assert str(leaf.dtype) == "torch." + ("int64" if wdt == "int32"
                                              else wdt), name


@pytest.mark.parametrize("axes", [{"data": 16, "model": 16},
                                  {"pod": 2, "data": 16, "model": 16}],
                         ids=["single", "multi"])
def test_input_specs_sharded_equal_reference(axes):
    mesh = type("Mesh", (), {"shape": dict(axes),
                             "axis_names": tuple(axes)})()
    for arch in ARCH_IDS:
        for shape_id in C.SHAPES:
            got = SH.input_specs_sharded(get_arch(arch), C.SHAPES[shape_id],
                                         mesh)
            want = JSH.input_specs_sharded(jget_arch(arch),
                                           JC.SHAPES[shape_id],
                                           _jmesh(axes))
            assert {k: tuple(v) for k, v in got.items()} == {
                k: tuple(v) for k, v in want.items()}, (arch, shape_id)


def test_plain_formulas_equal_reference():
    for kind in ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
                 "collective-permute"):
        for payload, n in ((1 << 20, 16), (4096, 2), (12345, 512)):
            assert HC._collective_wire(kind, payload, n) == \
                JHC._collective_wire(kind, payload, n)
    for args in ((5, 6, 4, 23, 23, 23), (9, 7, 3, 4, 8, 16)):
        assert RL.spgemm_dense_flops(*args) == JRL.spgemm_dense_flops(*args)
    for args in ((64, 23, 23, 23), (1024, 4, 2048, 1408)):
        assert RL.spgemm_stacks_flops(*args) == JRL.spgemm_stacks_flops(*args)


_REF_DRYRUN = """\
import json
from repro.config import SHAPES
from repro.configs import get_arch
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
out = {"meshes": {}, "flash": {}, "cells": {}}
for kind in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    out["meshes"][kind] = [list(mesh.devices.shape), list(mesh.axis_names)]
    for arch in %r:
        for shape in SHAPES:
            key = dryrun.cell_id(arch, shape, kind, "t")
            out["flash"][key] = dryrun._flash_kernel_bytes(
                get_arch(arch), SHAPES[shape], mesh)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's production meshes and analytic flash bytes, from a
    subprocess (its dry run forces 512 host devices on import)."""
    proc = subprocess.run(
        [sys.executable, "-c", _REF_DRYRUN % (DENSE,)], capture_output=True,
        text=True, timeout=600,
        env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
             "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_production_mesh_and_flash_bytes_equal_reference(kind, ref_dryrun):
    mesh = M.make_production_mesh(multi_pod=kind == "multi", abstract=True)
    assert [list(mesh.sizes), list(mesh.axis_names)] == \
        ref_dryrun["meshes"][kind]
    assert mesh.abstract and mesh.n_devices == mesh.size
    assert all(d.type == "meta" for d in mesh.devices)
    for arch in DENSE:
        for shape in C.SHAPES:
            key = DR.cell_id(arch, shape, kind, "t")
            assert DR._flash_kernel_bytes(get_arch(arch), C.SHAPES[shape],
                                          mesh) == ref_dryrun["flash"][key]


def test_production_mesh_needs_a_card_unless_abstract():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_production_mesh()
    with pytest.raises(ValueError, match="names no device"):
        M.make_production_mesh(abstract=True, device="cpu")
    cpu = M.make_production_mesh(multi_pod=True, device="cpu")
    assert cpu.size == 512 and set(cpu.devices) == {torch.device("cpu")}


# ---------------------------------------------------------------------------
# the flash kernels as traceable ops
# ---------------------------------------------------------------------------


FLASH_OP_CASES = [  # b, h, hkv, sq, skv, d, causal, window, q_offset, dtype
    (2, 4, 4, 64, 64, 64, True, None, 0, torch.bfloat16),
    (1, 8, 2, 100, 100, 128, True, 32, 0, torch.bfloat16),
    (2, 4, 2, 48, 80, 32, False, None, 0, torch.float32),
    (1, 4, 1, 33, 97, 64, True, 16, 64, torch.float32),
]


def _brute_pairs(sq, skv, causal, window, q_offset):
    kept = 0
    for i in range(sq):
        p = q_offset + i
        for j in range(skv):
            ok = (not causal or j <= p) and (window is None or j > p - window)
            kept += ok
    return kept


@pytest.mark.parametrize("case", FLASH_OP_CASES, ids=str)
def test_flash_ops_under_fake_cuda(case):
    """Under a fake tensor mode, CUDA tensors take the ops' fake
    implementations: the plain version's shapes and dtypes, the kernel's
    heads-major strides, and FLOPs of the kept pairs only — 4 d a pair
    forward, 10 d backward (``FlopCounterMode``); no kernel launches."""
    b, h, hkv, sq, skv, d, causal, window, off, dt = case
    kw = dict(causal=causal, window=window, q_offset=off)
    pairs = _brute_pairs(sq, skv, causal, window, off)
    assert FA.kept_pairs(sq, skv, causal, window, off) == pairs
    plain, plse = FA.flash_attention_plain_lse(
        torch.zeros(b, h, sq, d, dtype=dt), torch.zeros(b, hkv, skv, d,
                                                        dtype=dt),
        torch.zeros(b, hkv, skv, d, dtype=dt), **kw)
    before = (FA.launches, FA.bwd_launches)
    with FakeTensorMode():
        q = torch.empty(b, h, sq, d, dtype=dt, device="cuda")
        k = torch.empty(b, hkv, skv, d, dtype=dt, device="cuda")
        v = torch.empty_like(k)
        with FlopCounterMode(display=False) as fwd:
            out, lse = FA.flash_attention_cuda(q, k, v, with_lse=True, **kw)
        with FlopCounterMode(display=False) as bwd:
            grads = FA.flash_attention_backward_cuda(q, k, v, out, lse, out,
                                                     **kw)
        served = FA.flash_attention(q, k, v, **kw)
    assert (FA.launches, FA.bwd_launches) == before
    assert out.shape == plain.shape and out.dtype == plain.dtype
    assert lse.shape == plse.shape and lse.dtype == plse.dtype
    assert out.stride() == (sq * h * d, d, h * d, 1)  # heads-major
    assert served.shape == plain.shape and str(served.device) == "cuda:0"
    for g, ref in zip(grads, (q, k, v)):
        assert g.shape == ref.shape and g.dtype == ref.dtype
    assert fwd.get_total_flops() == 4 * d * b * h * pairs
    assert bwd.get_total_flops() == 10 * d * b * h * pairs


def test_flash_ops_on_meta_tensors_and_refusals():
    """A ``meta`` tensor takes the op's fake implementation (the dry run's
    ranks); a CPU tensor is refused by the kernels' wrappers and runs the
    plain version through ``flash_attention``."""
    q = torch.empty(1, 2, 16, 32, device="meta")
    out = FA.flash_attention(q, q, q, causal=True)
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="CUDA tensors"):
        FA.flash_attention_cuda(torch.zeros(1, 1, 8, 32),
                                torch.zeros(1, 1, 8, 32),
                                torch.zeros(1, 1, 8, 32))
    with pytest.raises(NotImplementedError, match="head dim"):
        FA.flash_attention(*(torch.empty(1, 1, 8, 48, device="meta"),) * 3)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


def _fake(fm, tree):
    if isinstance(tree, dict):
        return {k: _fake(fm, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fake(fm, v) for v in tree]
    if isinstance(tree, SH.Shards):
        return SH.Shards(fm.from_tensor(t) for t in tree)
    return fm.from_tensor(tree) if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("dims,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ["olmo-1b", "gemma2-27b"])
def test_fake_trace_counts_the_real_cpu_step(arch, dims, names):
    cfg = get_arch(arch).reduced()
    mesh = M.make_mesh(dims, names, "cpu")
    shape = ShapeConfig("t", 32, 4, "train")
    opt = AdamWConfig(lr=3e-3)
    options = ST.StepOptions(remat="full", loss_chunk=16)
    params = T.init_params(cfg, 0, device="cpu")
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=4, seed=0))
    step = ST.build_train_step(cfg, shape, opt=opt, options=options,
                               device="cpu", mesh=mesh)
    batch = make_global_batch(data, 0, mesh)
    TR.reset_bytes()
    with FlopCounterMode(display=False) as fc:
        step(*ST.init_sharded(cfg, mesh, params, opt, options), batch)
    moved = TR.bytes_moved()
    _, real = HC.trace(step, *ST.init_sharded(cfg, mesh, params, opt,
                                              options), batch)
    p, s = ST.init_sharded(cfg, mesh, params, opt, options)
    with FakeTensorMode() as fm:
        _, fake = HC.trace(step, _fake(fm, p), _fake(fm, s), _fake(fm, batch))
    count = ST.step_bytes(cfg, mesh, shape, options, opt)
    assert fake.flops == real.flops == fc.get_total_flops() > 0
    assert fake.hbm_bytes == real.hbm_bytes > 0
    assert fake.collective_wire_bytes == real.collective_wire_bytes == \
        moved == count
    assert fake.by_kind_bytes == real.by_kind_bytes
    assert sum(fake.by_kind_bytes.values()) == count
    assert fake.n_ops == real.n_ops


def _family_cfg(name):
    """Reduced MoE and hybrid configs: deepseek under tp or ep, llama4, and
    jamba cut to its first two layers (attention + MLP, then mamba +
    MoE)."""
    from repro_torch.launch.train import cut_depth

    if name == "jamba":
        return cut_depth(get_arch("jamba-v0.1-52b").reduced(), 2)
    if name == "llama4":
        return get_arch("llama4-maverick-400b-a17b").reduced()
    cfg = get_arch("deepseek-moe-16b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl=name.split("-")[1]))


@pytest.mark.parametrize("dims,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", ["deepseek-tp", "deepseek-ep", "llama4",
                                  "jamba"])
def test_moe_and_hybrid_traces_count_the_real_cpu_step(name, dims, names):
    """The MoE and hybrid families' sharded training step: the fake trace
    counts what the real one counts (FLOPs, HBM bytes, ops, wire bytes),
    its FLOPs are ``FlopCounterMode``'s over the real step — mamba's chunk
    ops counted through their eager bodies (``hlo_cost.BODIES``) and
    their FLOP formulas — and its wire bytes ``step_bytes``."""
    cfg = _family_cfg(name)
    mesh = M.make_mesh(dims, names, "cpu")
    shape = ShapeConfig("t", 32, 4, "train")
    opt = AdamWConfig(lr=3e-3)
    options = ST.StepOptions(remat="full", loss_chunk=16)
    params = T.init_params(cfg, 0, device="cpu")
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=4, seed=0))
    step = ST.build_train_step(cfg, shape, opt=opt, options=options,
                               device="cpu", mesh=mesh)
    batch = make_global_batch(data, 0, mesh)
    TR.reset_bytes()
    with FlopCounterMode(display=False) as fc:
        step(*ST.init_sharded(cfg, mesh, params, opt, options), batch)
    moved = TR.bytes_moved()
    _, real = HC.trace(step, *ST.init_sharded(cfg, mesh, params, opt,
                                              options), batch)
    p, s = ST.init_sharded(cfg, mesh, params, opt, options)
    with FakeTensorMode() as fm:
        _, fake = HC.trace(step, _fake(fm, p), _fake(fm, s), _fake(fm, batch))
    count = ST.step_bytes(cfg, mesh, shape, options, opt)
    assert fake.flops == real.flops == fc.get_total_flops() > 0
    assert fake.hbm_bytes == real.hbm_bytes > 0
    assert fake.n_ops == real.n_ops
    assert fake.collective_wire_bytes == real.collective_wire_bytes == \
        moved == count


@pytest.mark.parametrize("dims,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ["whisper-large-v3", "pixtral-12b"])
def test_audio_and_vlm_traces_count_the_real_cpu_step(arch, dims, names):
    """whisper's sharded training step with its frames through the encoder
    and pixtral's with its patches: the fake trace counts what the real
    one counts, its FLOPs are ``FlopCounterMode``'s over the real step and
    its wire bytes ``step_bytes`` (the encoder's and the cross-attention's
    collectives included)."""
    cfg = get_arch(arch).reduced()
    mesh = M.make_mesh(dims, names, "cpu")
    shape = ShapeConfig("t", 32, 4, "train")
    opt = AdamWConfig(lr=3e-3)
    options = ST.StepOptions(remat="full", loss_chunk=16)
    params = T.init_params(cfg, 0, device="cpu")
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=4, seed=0))
    n, name = ((cfg.encoder.n_frames, "frame_embeds") if cfg.encoder
               else (cfg.n_patches, "patch_embeds"))
    rng = np.random.default_rng(0)
    embeds = torch.from_numpy(rng.standard_normal(
        (4, n, cfg.d_model)).astype(np.float32))
    step = ST.build_train_step(cfg, shape, opt=opt, options=options,
                               device="cpu", mesh=mesh)
    batch = dict(make_global_batch(data, 0, mesh), **{
        name: SH.shard(mesh, embeds, SH.batch_spec(mesh, *embeds.shape))})
    TR.reset_bytes()
    with FlopCounterMode(display=False) as fc:
        step(*ST.init_sharded(cfg, mesh, params, opt, options), batch)
    moved = TR.bytes_moved()
    _, real = HC.trace(step, *ST.init_sharded(cfg, mesh, params, opt,
                                              options), batch)
    p, s = ST.init_sharded(cfg, mesh, params, opt, options)
    with FakeTensorMode() as fm:
        _, fake = HC.trace(step, _fake(fm, p), _fake(fm, s), _fake(fm, batch))
    count = ST.step_bytes(cfg, mesh, shape, options, opt)
    assert fake.flops == real.flops == fc.get_total_flops() > 0
    assert fake.hbm_bytes == real.hbm_bytes > 0
    assert fake.n_ops == real.n_ops
    assert fake.collective_wire_bytes == real.collective_wire_bytes == \
        moved == count


def test_mamba_chunk_op_counts_its_body():
    """A traced mamba chunk counts its eager body's ops, FLOPs and bytes
    (traced once per shape): the same as the body traced op by op."""
    from repro_torch.models import mamba as MB

    gen = torch.Generator().manual_seed(0)
    t, b, di, n = 8, 2, 16, 4
    args = [torch.randn(sh, generator=gen) for sh in (
        (t, b, di), (t, b, n), (t, b, n), (t, b, di), (di, n), (di,),
        (b, di, n))]
    args[0] = args[0].abs()
    _, via_op = HC.trace(lambda *a: MB._chunk_op(*a), *args)
    _, body = HC.trace(lambda *a: MB._chunk_body(*a), *args)
    assert via_op.flops == body.flops > 0
    assert via_op.hbm_bytes == body.hbm_bytes > 0
    assert via_op.n_ops == body.n_ops
    with FlopCounterMode(display=False) as fc:
        MB._chunk_op(*args)
    assert fc.get_total_flops() == body.flops


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_rwkv_chunk_op_counts_its_body(backward):
    """A traced rwkv6 wkv chunk (and its backward) counts its eager body's
    ops, FLOPs and bytes: the same as the body traced op by op."""
    from repro_torch.models import rwkv6 as RW

    gen = torch.Generator().manual_seed(0)
    t, b, h, hd = 8, 2, 3, 4
    shapes = [(t, b, h, hd)] * 4 + [(h, hd), (b, h, hd, hd)]
    if backward:
        shapes += [(t, b, h, hd), (b, h, hd, hd)]
    args = [torch.randn(sh, generator=gen) for sh in shapes]
    op, body = ((RW._wkv_chunk_back_op, RW._wkv_chunk_back_body) if backward
                else (RW._wkv_chunk_op, RW._wkv_chunk_body))
    _, via_op = HC.trace(lambda *a: op(*a), *args)
    _, eager = HC.trace(lambda *a: body(*a), *args)
    # the forward's matmul reshapes its (B, h, 1, hd) product by
    # ``_unsafe_view``: priced as a copy op by op, a view inside the op
    views = sum(v for k, v in eager.top_memory.items()
                if "_unsafe_view" in k)
    assert via_op.flops == eager.flops > 0
    assert via_op.hbm_bytes == eager.hbm_bytes - views > 0
    assert via_op.n_ops == eager.n_ops
    with FlopCounterMode(display=False) as fc:
        op(*args)
    assert fc.get_total_flops() == eager.flops


@pytest.mark.parametrize("shape", [
    ShapeConfig("t", 64, 4, "train"), ShapeConfig("p", 64, 4, "prefill"),
    ShapeConfig("d", 64, 4, "decode")], ids=lambda s: s.kind)
@pytest.mark.parametrize("name", ["deepseek-ep", "llama4", "jamba"])
def test_moe_and_hybrid_extrapolation_equals_a_direct_trace(name, shape):
    """On abstract ranks the depth extension holds for the new families:
    traces of one and two layer patterns extended to four equal a direct
    four-pattern trace (counts exactly, the peak within PEAK_TOL)."""
    cfg = _family_cfg(name)
    mesh = M.Mesh(*MESHES[0][::-1], (torch.device("meta"),) * 4,
                  abstract=True)
    options = ST.StepOptions(remat="full", loss_chunk=32)
    p = cfg.layer_pattern_period
    one, two, four = (DR.trace_step(cfg, shape, mesh, options, k * p)
                      for k in (1, 2, 4))
    got = HC.extrapolate(one, two, p, 2 * p, 4 * p)
    for attr in ("flops", "hbm_bytes", "collective_wire_bytes",
                 "argument_bytes", "n_ops"):
        assert getattr(got, attr) == getattr(four, attr), attr
    assert got.flops > 0
    assert abs(got.peak_bytes - four.peak_bytes) <= PEAK_TOL * four.peak_bytes


def _meta_mesh(dims, names, distinct=True):
    n = math.prod(dims)
    return M.Mesh(names, dims, tuple(torch.device("meta", r if distinct
                                                  else 0) for r in range(n)))


KINDS = [ShapeConfig("t", 64, 4, "train"), ShapeConfig("p", 64, 4, "prefill"),
         ShapeConfig("d", 64, 4, "decode")]


@pytest.mark.parametrize("shape", KINDS, ids=lambda s: s.kind)
@pytest.mark.parametrize("dims,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ["olmo-1b", "gemma2-27b"])
def test_extrapolation_equals_a_direct_trace(arch, dims, names, shape):
    cfg = get_arch(arch).reduced()
    mesh = _meta_mesh(dims, names)
    options = ST.StepOptions(remat="full", loss_chunk=32)
    p = cfg.layer_pattern_period
    one, two, four = (DR.trace_step(cfg, shape, mesh, options, k * p)
                      for k in (1, 2, 4))
    got = HC.extrapolate(one, two, p, 2 * p, 4 * p)
    for name in ("flops", "hbm_bytes", "collective_wire_bytes",
                 "argument_bytes", "flash_bytes", "n_ops"):
        assert getattr(got, name) == getattr(four, name), name
    assert got.by_kind_bytes == four.by_kind_bytes
    assert got.flops > 0 and got.hbm_bytes > 0
    assert abs(got.peak_bytes - four.peak_bytes) <= PEAK_TOL * four.peak_bytes


def test_extrapolation_at_full_width_on_one_device():
    """olmo-1b at full width, one device, remat full (phase 24's step on
    ``meta``): the peak extended from one and two layers lies within
    PEAK_TOL of a direct four-layer trace, above what the shallow traces'
    largest phase peak extends to (the optimizer's phase outgrows it);
    the counts are exact."""
    shape = ShapeConfig("t", 2048, 8, "train")
    options = ST.StepOptions(remat="full", loss_chunk=512)
    one, two, four = (DR.trace_step(get_arch("olmo-1b"), shape, None,
                                    options, n) for n in (1, 2, 4))
    got = HC.extrapolate(one, two, 1, 2, 4)
    assert got.flops == four.flops and got.hbm_bytes == four.hbm_bytes
    assert abs(got.peak_bytes - four.peak_bytes) <= PEAK_TOL * four.peak_bytes
    naive = {k: one.phase_peaks[k] + 3 * (two.phase_peaks[k]
                                          - one.phase_peaks[k])
             for k in one.phase_peaks}
    assert got.peak_bytes > got.argument_bytes + max(naive.values())


@pytest.mark.parametrize("shape", KINDS, ids=lambda s: s.kind)
def test_meta_cache_changes_no_count(shape, monkeypatch):
    """The tracer's outputs remade from the metadata of an op seen before
    count exactly what running every meta kernel counts."""
    cfg = get_arch("gemma2-27b").reduced()
    dims, names = MESHES[0]
    options = ST.StepOptions(remat="full", loss_chunk=32)
    mesh = M.Mesh(names, dims, (torch.device("meta"),) * 4, abstract=True)
    got = DR.trace_step(cfg, shape, mesh, options)
    monkeypatch.setattr(HC, "_meta_key", lambda *a: None)
    want = DR.trace_step(cfg, shape, mesh, options)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.flops > 0 and got.n_ops > 0


@pytest.mark.parametrize("dims,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ["olmo-1b", "gemma2-27b"])
def test_per_rank_counts_are_equal(arch, dims, names):
    cfg = get_arch(arch).reduced()
    mesh = _meta_mesh(dims, names)
    options = ST.StepOptions(loss_chunk=32)
    ranks = [str(d) for d in mesh.devices]
    for shape in KINDS:
        with FakeTensorMode():
            rep = DR.trace_step(cfg, shape, mesh, options)
        flops = [rep.flops_by_device[r] for r in ranks]
        nbytes = [rep.bytes_by_device[r] for r in ranks]
        assert len(set(flops)) == 1 and flops[0] > 0, shape.kind
        if shape.kind != "train":
            assert len(set(nbytes)) == 1, shape.kind
            continue
        _, _, p_spec, _ = ST.abstract_state(cfg, mesh, None, options)
        local = sum(math.prod(SH.local_shape(x.shape, sp, mesh)) for x, sp in
                    zip(leaves(SH.param_shapes(cfg)), leaves(p_spec)))
        assert max(nbytes) - min(nbytes) <= 18 * local, shape.kind


@pytest.mark.parametrize("shape", KINDS, ids=lambda s: s.kind)
def test_abstract_ranks_trace_as_distinct_devices(shape):
    """The dry run's abstract mesh (every rank on plain ``meta``, marked
    as its own device) counts what a mesh of distinct ``meta:r`` devices
    counts, and shares no tensor between ranks."""
    cfg = get_arch("gemma2-27b").reduced()
    dims, names = MESHES[0]
    options = ST.StepOptions(loss_chunk=32)
    abstract = M.Mesh(names, dims, (torch.device("meta"),) * 4,
                      abstract=True)
    assert abstract.n_devices == 4
    zeros = SH.zeros(abstract, (8, 8), SH.P(None, None), torch.float32)
    assert len({id(t) for t in zeros}) == 4
    got = DR.trace_step(cfg, shape, abstract, options)
    want = DR.trace_step(cfg, shape, _meta_mesh(dims, names), options)
    for name in ("flops", "hbm_bytes", "collective_wire_bytes",
                 "argument_bytes", "n_ops"):
        assert getattr(got, name) == getattr(want, name), name
    # a plain meta tensor has no index, so on meta:r ranks a collective
    # copies its result to every rank, the group's first too, and holds
    # one more buffer for a moment than the abstract mesh (where, as on
    # distinct cards, the first rank keeps the sum): the peak moves by
    # about 1 % at these reduced sizes
    assert abs(got.peak_bytes - want.peak_bytes) <= 2e-2 * want.peak_bytes


def test_one_device_and_shared_device_traces():
    """A mesh whose ranks share one device traces as the run on that
    device does (replicas shared, memory not divided); with no mesh the
    one-device step."""
    cfg = get_arch("olmo-1b").reduced()
    shape = KINDS[0]
    options = ST.StepOptions(loss_chunk=32)
    one = DR.trace_step(cfg, shape, None, options)
    shared = DR.trace_step(cfg, shape, _meta_mesh((2, 2), ("data", "model"),
                                                  distinct=False), options)
    assert one.flops > 0 and one.collective_wire_bytes == 0
    assert shared.collective_wire_bytes > 0
    assert shared.argument_bytes >= one.argument_bytes > 0
    assert one.peak_bytes > one.argument_bytes


# ---------------------------------------------------------------------------
# run_cell and the CLI
# ---------------------------------------------------------------------------


def _ref_record_keys() -> set:
    """The keys the reference's ``run_cell`` writes for a traced cell (from
    its source: the record literal and ``record.update``'s arguments)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_cell")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.AnnAssign) and isinstance(node.value,
                                                          ast.Dict):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "update"):
            keys |= {kw.arg for kw in node.keywords}
    return keys


def test_run_cell_record_keys_and_skips():
    cfg = get_arch("olmo-1b").reduced()
    mesh = _meta_mesh((2, 2), ("data", "model"))
    options = DR.parse_options(["remat=full", "loss_chunk=1024"])
    assert options == ST.StepOptions(remat="full", loss_chunk=1024)
    rec = DR.run_cell("olmo_1b", "prefill_32k", "single", options, cfg=cfg,
                      mesh=mesh, verbose=False)
    want = _ref_record_keys() - {"lower_s", "compile_s", "skipped",
                                 "skip_reason"} | {"trace_s"}
    flash = {"flash_kernel_bytes", "flash_traced_bytes"}
    assert set(rec) == want | flash and rec["ok"] and rec["trace_s"] >= 0
    assert rec["flash_kernel_bytes"] > 0 and rec["flash_traced_bytes"] > 0
    jrep = JRL.RooflineReport(0.0, 0.0, 0.0, 1.0, 0.0, 0.0, "compute", 0.0,
                              0.0, JRL.CollectiveStats(), {})
    assert list(rec["roofline"]) == list(jrep.to_json())
    fields = {f.name for f in dataclasses.fields(RL.RooflineReport)}
    assert fields == {f.name for f in dataclasses.fields(JRL.RooflineReport)}
    assert set(rec["roofline"]["memory"]) == {
        "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
        "peak_bytes"}
    assert rec["mesh_shape"] == [2, 2] and rec["n_chips"] == 4
    assert rec["roofline"]["memory_s_kernel"] == rec["roofline"]["memory_s"]
    skip = DR.run_cell("olmo_1b", "long_500k", "single", options, cfg=cfg,
                       mesh=mesh, verbose=False)
    assert skip["skipped"] and skip["ok"]
    assert skip["skip_reason"] == JC.shape_applicable(
        jget_arch("olmo_1b"), JC.SHAPES["long_500k"])[1]


@pytest.mark.parametrize("arch,shape_id", [
    ("deepseek_moe_16b", "train_4k"), ("deepseek_moe_16b", "decode_32k"),
    ("llama4_maverick_400b_a17b", "prefill_32k"),
    ("jamba_v0_1_52b", "train_4k"), ("jamba_v0_1_52b", "long_500k")])
def test_moe_and_hybrid_cells_are_ok(arch, shape_id):
    """``run_cell`` records the MoE and hybrid cells ``ok`` (reduced, on a
    2 x 2 mesh of abstract ranks): the three terms, the memory, the
    active-parameter MODEL_FLOPS; jamba is sub-quadratic, so its
    long_500k cell runs; deepseek's cells under ``--moe-impl ep`` too.
    Reduced jamba scans in chunks of 4,096 tokens here (8 would trace 512
    chunks a layer for train_4k's sequence)."""
    cfg = get_arch(arch).reduced()
    if cfg.mamba is not None:
        cfg = dataclasses.replace(cfg, mamba=dataclasses.replace(
            cfg.mamba, chunk=4096))
    mesh = M.Mesh(("data", "model"), (2, 2), (torch.device("meta"),) * 4,
                  abstract=True)
    for impl in (None, "ep") if arch.startswith("deepseek") else (None,):
        rec = DR.run_cell(arch, shape_id, "single",
                          ST.StepOptions(loss_chunk=1024), cfg=cfg, mesh=mesh,
                          verbose=False, moe_impl=impl)
        assert rec["ok"] and not rec.get("skipped"), rec
        rl = rec["roofline"]
        assert rl["flops_per_device"] > 0 and rl["memory"]["peak_bytes"] > 0
        assert rec["params_active"] < rec["params_total"]
        assert rl["model_flops_total"] == RL.model_flops(
            cfg, C.SHAPES[shape_id])


def test_unported_families_fail_naming_their_item(tmp_path, capsys):
    """MoE's spgemm impl on a mesh fails naming its item; the ssm, audio
    and vlm families trace ``ok`` (reduced, on a 2 x 2 mesh of abstract
    ranks; rwkv6 in one chunk of 256 tokens, whisper with its frames
    through the encoder), rwkv6 its long_500k cell too, and the entry
    point records whisper's long_500k cell skipped and exits 0."""
    mesh = M.Mesh(("data", "model"), (2, 2), (torch.device("meta"),) * 4,
                  abstract=True)
    with pytest.raises(NotImplementedError, match="15c.2"):
        DR.run_cell("deepseek_moe_16b", "decode_32k", "single",
                    ST.StepOptions(), cfg=get_arch("deepseek-moe-16b")
                    .reduced(), mesh=_meta_mesh((2, 2), ("data", "model")),
                    verbose=False, moe_impl="spgemm")
    cells = [("rwkv6_7b", "train_4k"), ("rwkv6_7b", "long_500k"),
             ("whisper_large_v3", "prefill_32k"),
             ("pixtral_12b", "decode_32k")]
    for arch, shape_id in cells:
        cfg = get_arch(arch).reduced()
        if cfg.rwkv is not None:
            cfg = dataclasses.replace(cfg, rwkv=dataclasses.replace(
                cfg.rwkv, chunk=256))
        rec = DR.run_cell(arch, shape_id, "single",
                          ST.StepOptions(loss_chunk=1024), cfg=cfg,
                          mesh=mesh, verbose=False)
        assert rec["ok"] and not rec.get("skipped"), (arch, shape_id, rec)
        assert rec["roofline"]["flops_per_device"] > 0
    argv = sys.argv
    sys.argv = ["dryrun", "--arch", "whisper-large-v3", "--shape",
                "long_500k", "--mesh", "single", "--out", str(tmp_path)]
    try:
        with pytest.raises(SystemExit) as exit_:
            DR.main()
    finally:
        sys.argv = argv
    assert exit_.value.code == 0
    rec = json.loads((tmp_path / "whisper_large_v3__long_500k__single.json")
                     .read_text())
    assert rec["ok"] and rec["skipped"]
