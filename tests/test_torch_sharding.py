"""The port's sharding rules (``repro_torch.parallel.sharding``) against
the reference's ``repro.parallel.sharding``, leaf by leaf, on every
architecture at its full width (shapes from ``jax.eval_shape`` and the
port's fake-tensor ``param_shapes``: nothing is allocated, and
divisibility only shows at production sizes).

The rules are pure functions of (path, shape, axis sizes).  ``leaf_spec``
is compared on every leaf of the reference's tree as the reference calls
it; ``param_specs`` over the port's tree (one dict per layer) through the
path map ``ref_path``, which also has to reach every reference leaf with
its shape.  ``batch_spec``, ``activation_rules`` and ``cache_specs`` want a
mesh: the reference gets a ``jax.sharding.AbstractMesh`` of the axis sizes
(no devices), the port the axis dict or a duck-typed mesh; the reference's
``activation_rules`` wraps its specs in ``NamedSharding``, compared by
their ``.spec``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_IDS
from repro.configs import get_arch as jget_arch
from repro.models import transformer as JT
from repro.parallel import sharding as JS
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as S

AXES = [
    {"data": 2, "model": 2},
    {"data": 16, "model": 16},
    {"pod": 2, "data": 16, "model": 16},
]
AXES_IDS = ["d2m2", "d16m16", "p2d16m16"]
OPTIONS = [
    dict(fsdp_axis="data"),
    dict(fsdp_axis=("pod", "data")),
    dict(fsdp_axis=None),
    dict(fsdp_axis="data", head_2p5d=True),
    dict(fsdp_axis=("pod", "data"), head_2p5d=True),
    dict(fsdp_axis="data", moe_impl="ep"),
    dict(fsdp_axis=None, moe_impl="ep", head_2p5d=True),
]
OPTION_IDS = ["data", "pod_data", "nofsdp", "2p5d", "2p5d_pod_data", "ep",
              "ep_nofsdp_2p5d"]


class _Mesh:
    """What the port's batch rules read of a mesh."""

    def __init__(self, axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def _jmesh(axes):
    return AbstractMesh(tuple(axes.values()), tuple(axes))


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch):
    """The reference's leaves as (path string, stacked shape)."""
    shapes = jax.eval_shape(functools.partial(JT.init_params,
                                              jget_arch(arch)),
                            jax.random.key(0))
    return [(JS._path_str(p), tuple(x.shape))
            for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]]


def _cfgs(arch, moe_impl):
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    if moe_impl != "tp":
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, impl=moe_impl))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl=moe_impl))
    return jcfg, cfg


@pytest.mark.parametrize("opts", OPTIONS, ids=OPTION_IDS)
@pytest.mark.parametrize("axes", AXES, ids=AXES_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaf_spec_equals_reference(arch, axes, opts):
    for path, shape in _ref_leaves(arch):
        want = JS.leaf_spec(path, shape, axes, **opts)
        got = S.leaf_spec(path, shape, axes, **opts)
        assert isinstance(got, S.P)
        assert tuple(got) == tuple(want), (path, shape)


# moe_impl "ep" only where the arch has MoE layers to place
_SPEC_CASES = [pytest.param(arch, opts, id=f"{arch}-{oid}")
               for arch in ARCH_IDS
               for opts, oid in zip(OPTIONS, OPTION_IDS)
               if get_arch(arch).moe is not None or "moe_impl" not in opts]


@pytest.mark.parametrize("axes", AXES, ids=AXES_IDS)
@pytest.mark.parametrize("arch,opts", _SPEC_CASES)
def test_param_specs_equal_reference_through_the_path_map(arch, axes, opts):
    opts = dict(opts)
    jcfg, cfg = _cfgs(arch, opts.pop("moe_impl", "tp"))
    shapes = jax.eval_shape(functools.partial(JT.init_params, jcfg),
                            jax.random.key(0))
    want = {JS._path_str(p): (tuple(s), tuple(x.shape))
            for (p, s), (_, x) in zip(
                jax.tree_util.tree_flatten_with_path(
                    JS.param_specs(jcfg, shapes, _jmesh(axes), **opts),
                    is_leaf=lambda v: isinstance(v, jax.sharding.PartitionSpec)
                )[0],
                jax.tree_util.tree_flatten_with_path(shapes)[0])}
    got = S.param_specs(cfg, S.param_shapes(cfg), axes, **opts)
    reached = set()
    for (path, spec), (_, leaf) in zip(S._walk(got),
                                       S._walk(S.param_shapes(cfg))):
        rp, reps = S.ref_path(cfg, path)
        w_spec, w_shape = want[rp]
        reached.add(rp)
        if reps is None:
            assert tuple(spec) == w_spec and tuple(leaf.shape) == w_shape
        else:
            assert w_spec[0] is None and w_shape[0] == reps, rp
            assert tuple(spec) == w_spec[1:], (path, rp)
            assert tuple(leaf.shape) == w_shape[1:], (path, rp)
    assert reached == set(want)


@pytest.mark.parametrize("axes", AXES, ids=AXES_IDS)
@pytest.mark.parametrize("batch", [1, 8, 32, 256])
def test_batch_spec_equals_reference(axes, batch):
    for extra in ((), (4096,), (4096, 7)):
        want = JS.batch_spec(_jmesh(axes), batch, *extra)
        got = S.batch_spec(_Mesh(axes), batch, *extra)
        assert tuple(got) == tuple(want)
    assert S.batch_axes(_Mesh(axes)) == JS.batch_axes(_jmesh(axes))


@pytest.mark.parametrize("flags", [
    dict(), dict(seq_parallel=True), dict(head_2p5d=True),
    dict(seq_parallel=True, head_2p5d=True)],
    ids=["plain", "sp", "2p5d", "sp_2p5d"])
@pytest.mark.parametrize("axes", AXES, ids=AXES_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_activation_rules_equal_reference(arch, axes, flags):
    for batch in (1, 32, 256):
        want = JS.activation_rules(jget_arch(arch), _jmesh(axes),
                                   batch=batch, **flags)
        got = S.activation_rules(get_arch(arch), _Mesh(axes), batch=batch,
                                 reduce_dtype=torch.bfloat16, **flags)
        assert sorted(got.table) == sorted(want.table)
        for name, spec in got.table.items():
            assert tuple(spec) == tuple(want.table[name].spec), name
        assert got.reduce_dtype is torch.bfloat16


@pytest.mark.parametrize("axes", AXES, ids=AXES_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, axes):
    """The decode cache at decode_32k's (128, 32,768) and long_500k's
    (1, 524,288): every per-layer leaf's spec is the reference's at its
    pattern position without the repetitions entry."""
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    for batch, seq in ((128, 32768), (1, 524288)):
        jshape = jax.eval_shape(lambda: JT.init_cache(jcfg, batch, seq))
        want = {JS._path_str(p): tuple(s) for p, s in
                jax.tree_util.tree_flatten_with_path(
                    JS.cache_specs(jcfg, jshape, _jmesh(axes), batch=batch),
                    is_leaf=lambda v: isinstance(
                        v, jax.sharding.PartitionSpec))[0]}
        with FakeTensorMode():
            shape = T.init_cache(cfg, batch, seq, device="cpu")
        got = S.cache_specs(cfg, shape, _Mesh(axes), batch=batch)
        period = cfg.layer_pattern_period
        reached = set()
        for path, spec in S._walk(got):
            rp = "/".join(["blocks", str(int(path[1]) % period), path[2]])
            assert want[rp][0] is None
            assert tuple(spec) == want[rp][1:], (path, rp)
            reached.add(rp)
        assert reached == set(want)
