"""The audio family on a mesh of ranks (``parallel/runtime.py``):
whisper-large-v3 reduced (f32, d 128, four heads, two encoder and two
decoder layers, 16 frames) on meshes 2 x 2, 1 x 2 and 2 x 1 x 2, and a
three-head variant whose heads do not divide two model ranks (attention
and cross-attention whole on every model rank, weights gathered: the
full width's 20 heads on 16).

The encoder runs on each rank's rows of frames under the dense rules;
its output enters every decoder layer's cross K/V through one cut, so
its gradient, partial per model rank where the heads split, is summed
over ``model`` once.  Training: three sharded steps against the port's
one-device step with the same frames (``_run_case``; bytes per rank
equal to ``step_bytes``), under ``seq_parallel`` too (16 frames over two
model ranks; a frame count that does not divide ``model`` raises), and
without frames (decoder only, as ``launch.train`` trains it).  Serving:
a prefill with frames and three decode steps against the one-device
steps within 1e-4, with the self and the cross K/V each in the
``heads``, ``seq`` and ``whole`` layouts on some mesh, each as
``cache_specs`` lays it out.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import test_torch_serve_step as SV
import test_torch_sharded_step as SS
import torch

from repro_torch.config import SHAPES, ShapeConfig
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as ST
from repro_torch.optim.tree import named_leaves
from repro_torch.parallel import runtime as RT
from repro_torch.parallel import sharding as SH

FRAMES = {"frame_embeds": 16}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(heads=4, frames=16):
    cfg = get_arch("whisper-large-v3").reduced()
    return dataclasses.replace(
        cfg, n_heads=heads, n_kv_heads=heads, head_dim=32,
        encoder=dataclasses.replace(cfg.encoder, n_frames=frames))


CASES = [
    ("whisper", (2, 2), dict(remat="full"), FRAMES),
    ("whisper", (1, 2), dict(remat="none"), FRAMES),
    ("whisper", (2, 1, 2), dict(remat="dots"), FRAMES),
    ("whisper", (2, 2), dict(remat="full", seq_parallel=True), FRAMES),
    ("whisper-3-heads", (1, 2), dict(remat="full"), FRAMES),
    ("whisper-no-frames", (2, 2), dict(remat="none"), None),
]


@pytest.mark.parametrize("name,dims,opts,embeds", CASES,
                         ids=[SS._id(c[:3]) for c in CASES])
def test_sharded_step_matches_one_device(name, dims, opts, embeds,
                                         monkeypatch):
    cfg = _cfg(3) if "3-heads" in name else _cfg()
    SS._run_case(cfg, dims, opts, monkeypatch, embeds=embeds)


def test_frames_that_do_not_divide_model_raise():
    cfg = _cfg(frames=15)
    mesh = M.make_mesh((1, 2), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="15 frames over model 2"):
        ST.build_train_step(cfg, ShapeConfig("t", 32, 8, "train"),
                            options=ST.StepOptions(seq_parallel=True),
                            device="cpu", mesh=mesh)


# (heads, frames, cache depth, mesh) -> the self and cross K/V layouts
LAYOUTS = [
    (4, 16, 24, (2, 2), ("heads", "heads")),
    (3, 16, 24, (1, 2), ("seq", "seq")),
    (3, 15, 25, (1, 2), ("whole", "whole")),
    (3, 15, 24, (1, 2), ("seq", "whole")),
]


@pytest.mark.parametrize("heads,frames,depth,dims,want", LAYOUTS,
                         ids=["-".join(c[-1]) for c in LAYOUTS])
def test_sharded_serving_matches_one_device(heads, frames, depth, dims,
                                            want):
    cfg = _cfg(heads, frames)
    mesh = M.make_mesh(dims, ("data", "model"), "cpu")
    rt = RT.DecoderRuntime(
        cfg, mesh, ST.abstract_state(cfg, mesh, None, ST.StepOptions())[2],
        SH.activation_rules(cfg, mesh, batch=SV.BATCH), max_len=depth)
    assert (rt.layout, rt.x_layout) == want
    c_spec = SV._sharded_vs_one_device(cfg, dims, ("data", "model"),
                                       depth=depth,
                                       embeds={"frame_embeds": frames})
    specs = dict(named_leaves(c_spec))
    spec = {"heads": ("model", None), "seq": (None, "model"),
            "whole": (None, None)}
    assert tuple(specs["blocks__0__k"])[1:3] == spec[want[0]]
    assert tuple(specs["blocks__0__xk"])[1:3] == spec[want[1]]


def test_serving_without_frames_attends_a_zero_cross_cache():
    """No frames at prefill: the cross cache stays zero and decode
    attends to it (adding zero), as on one device."""
    SV._sharded_vs_one_device(_cfg(), (2, 2), ("data", "model"))


@pytest.mark.parametrize("axes", [(16, 16), (2, 16, 16)],
                         ids=["single", "multi"])
def test_runtime_layouts_are_cache_specs(axes):
    """At full width on the production meshes: the self cache (20 kv
    heads, 32,768 positions) splits its sequence over 16 model ranks, the
    cross cache (1,500 frames) stays whole; each as ``cache_specs``."""
    cfg = get_arch("whisper-large-v3")
    names = ("pod", "data", "model")[-len(axes):]
    mesh = M.Mesh(names, axes, (torch.device("meta"),) * int(np.prod(axes)),
                  abstract=True)
    for shape in ("prefill_32k", "decode_32k"):
        sh = SHAPES[shape]
        _, _, p_spec, _ = ST.abstract_state(cfg, mesh, None, ST.StepOptions())
        rt = RT.DecoderRuntime(
            cfg, mesh, p_spec, SH.activation_rules(cfg, mesh,
                                                   batch=sh.global_batch),
            max_len=sh.seq_len)
        specs = dict(named_leaves(SH.cache_specs(cfg, SH.cache_shapes(
            cfg, sh.global_batch, sh.seq_len), mesh,
            batch=sh.global_batch)))
        got = {"k": rt.layout, "xk": rt.x_layout}
        for name, layout in got.items():
            want = {("model", None): "heads", (None, "model"): "seq",
                    (None, None): "whole"}[tuple(specs[f"blocks__0__{name}"])
                                           [1:3]]
            assert layout == want, (shape, name)
        assert (rt.layout, rt.x_layout) == ("seq", "whole")
