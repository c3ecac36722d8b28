"""The port's occupancy-compressed panel wire against the reference's: the
packing format element for element (truncation under capacity and
all-zero states included), the capacity functions on the reference's own
plans (built on a duck-typed mesh), and ``plan_volume``'s compressed
branch.  Then, on meshes of ranks on the CPU: every engine under
compressed transport gives the masks and the values of dense transport bit
for bit, a reduced wire equals dense transport of the rounded operands,
and the byte counter equals ``plan_volume`` of the resolved transport.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import commvolume as RC
from repro.core import plan as RP
from repro.core import transport as RT
from repro_torch.core import bsm as B
from repro_torch.core import commvolume as PC
from repro_torch.core import engine as E
from repro_torch.core import plan as PP
from repro_torch.core import transport as T
from repro_torch.launch.mesh import make_mesh

from test_torch_plan_schedule import PLANS, DuckMesh, _mesh


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small operations per rank: with several test workers on the
    machine, torch's intra-op threads would only spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _panel(seed: int, nr: int, nc: int, occ: float, bs=(3, 2)):
    rng = np.random.default_rng(seed)
    mask = rng.random((nr, nc)) < occ
    blocks = rng.standard_normal((nr, nc) + bs).astype(np.float32)
    return blocks * mask[:, :, None, None], mask


@pytest.mark.parametrize("occ", [0.0, 0.2, 0.6, 1.0])
@pytest.mark.parametrize("capacity", [1, 5, 8, 30])
@pytest.mark.parametrize("shape", [(4, 6), (1, 7), (5, 5)], ids=str)
def test_pack_unpack_match_reference(shape, capacity, occ):
    """(packed, idx1) and the decoded (blocks, mask) equal the reference's
    element for element, also when the capacity truncates."""
    nr, nc = shape
    blocks, mask = _panel(sum(shape) + capacity, nr, nc, occ)
    want_p, want_i = RT.pack_panel(jnp.asarray(blocks), jnp.asarray(mask),
                                   capacity)
    got_p, got_i = T.pack_panel(torch.from_numpy(blocks),
                                torch.from_numpy(mask), capacity)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    want_b, want_m = RT.unpack_panel(want_p, want_i, nr, nc)
    got_b, got_m = T.unpack_panel(got_p, got_i, nr, nc)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    if capacity >= mask.sum():  # a covering capacity: the panel, exactly
        assert torch.equal(got_b, torch.from_numpy(blocks))
        assert torch.equal(got_m, torch.from_numpy(mask))


def test_zeros_decode_as_an_empty_panel():
    """What an unaddressed rank receives (``transport.zeros``) decodes as
    an empty panel, as the reference's all-zero state does."""
    packed = T.zeros((8, 3, 2), torch.float32, "cpu")
    idx1 = T.zeros((8,), torch.int32, "cpu")
    b, m = T.unpack_panel(packed, idx1, 4, 6)
    assert not m.any() and not b.any() and b.shape == (4, 6, 3, 2)
    rb, rm = RT.unpack_panel(jnp.zeros((8, 3, 2)), jnp.zeros(8, jnp.int32),
                             4, 6)
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))


@pytest.mark.parametrize("engine,sizes,l", PLANS, ids=str)
def test_capacities_match_reference(engine, sizes, l):
    """``plan_panel_parts``, ``panel_nnz_bound``, ``capacities_for``,
    ``resolve_mode`` and the compressed ``plan_volume`` on the port's plan
    equal the reference's on its own plan of the same mesh."""
    nb = 12 if sizes == (3, 3) else 16
    mine = PP.plan_multiply(make_mesh(sizes, _mesh(sizes), device="cpu"),
                            engine, l)
    ref = RP.plan_multiply(DuckMesh(sizes, _mesh(sizes)), engine, l)
    assert T.plan_panel_parts(mine) == RT.plan_panel_parts(ref)
    rng = np.random.default_rng(len(sizes) + nb)
    for occ in (0.05, 0.2, 0.5):
        am = rng.random((nb, nb)) < occ
        bm = rng.random((nb, nb)) < occ
        (ar, ac), (br, bc) = T.plan_panel_parts(mine)
        assert T.panel_nnz_bound(am, ar, ac) == RT.panel_nnz_bound(am, ar,
                                                                   ac)
        caps = T.capacities_for(am, bm, mine)
        assert caps == RT.capacities_for(am, bm, ref)
        for mode in ("auto", "dense", "compressed"):
            assert T.resolve_mode(mode, *caps) == RT.resolve_mode(mode, *caps)
        for wire in T.WIRES:
            tr = T.PanelTransport("compressed", caps[0], caps[1], wire)
            rtr = RT.PanelTransport("compressed", caps[0], caps[1], wire)
            for layout in ("2d", "scatter"):
                got = PC.plan_volume(mine, nb, 3, itemsize=4, transport=tr,
                                     c_layout=layout)
                want = RC.plan_volume(ref, nb, 3, itemsize=4, transport=rtr,
                                      c_layout=layout)
                assert vars(got) == vars(want)
    for n in (0, 1, 8, 9, 100):
        assert T.bucket(n) == RT.bucket(n)


def _operand(nb: int, occ: float, seed: int = 3):
    return B.random_bsm(seed, nb=nb, bs=3, occupancy=occ, pattern="decay",
                        device="cpu")


@pytest.mark.parametrize("threshold", [0.0, 0.35])
@pytest.mark.parametrize("engine,sizes,l", PLANS, ids=str)
def test_compressed_equals_dense_bitwise(engine, sizes, l, threshold):
    """Every engine under compressed transport: C's mask and values equal
    dense transport's bit for bit, and each multiply's bytes equal
    ``plan_volume`` of its resolved transport exactly."""
    nb = 12 if sizes == (3, 3) else 16
    mesh = make_mesh(sizes, _mesh(sizes), device="cpu")
    a, b = _operand(nb, 0.15), _operand(nb, 0.15, seed=4)
    plan = PP.plan_multiply(mesh, engine, l)
    out = {}
    for mode in ("dense", "compressed", "auto"):
        T.reset_bytes()
        c = E.multiply(a, b, mesh, engine=engine, l=l, threshold=threshold,
                       filter_eps=0.0, backend="stacks", transport=mode)
        tr = PP.resolve_transport(mode, a, b, mesh, engine, l)
        assert tr.compressed == (mode == "compressed"
                                 or (mode == "auto" and tr.compressed))
        vol = PC.plan_volume(plan, nb, 3, itemsize=4, transport=tr)
        assert T.bytes_moved() == vol.total
        out[mode] = c
    for mode in ("compressed", "auto"):
        assert torch.equal(out[mode].mask, out["dense"].mask)
        assert torch.equal(out[mode].blocks, out["dense"].blocks)


@pytest.mark.parametrize("wire", ["bfloat16", "float8_e4m3fn"])
@pytest.mark.parametrize("mode", ["dense", "compressed"])
@pytest.mark.parametrize("engine,sizes,l", [
    ("cannon", (2, 2), None), ("gather", (2, 4), None),
    ("twofive", (2, 4), None), ("twofive", (2, 2, 2), None)], ids=str)
def test_reduced_wire_rounds_the_panels(engine, sizes, l, mode, wire):
    """A reduced wire ships every A / B panel rounded to its element type:
    C equals dense transport of the rounded operands bit for bit, and the
    bytes equal ``plan_volume`` at the wire's width."""
    mesh = make_mesh(sizes, _mesh(sizes), device="cpu")
    a = _operand(16, 0.15)
    wd = getattr(torch, wire)
    rounded = B.make_bsm(a.blocks.to(wd).float(), a.mask)
    tr = PP.resolve_transport(mode, a, a, mesh, engine, l)
    tr = T.PanelTransport(tr.mode, tr.cap_a, tr.cap_b, wire)
    T.reset_bytes()
    got = E.multiply(a, a, mesh, engine=engine, l=l, backend="stacks",
                     transport=tr)
    vol = PC.plan_volume(PP.plan_multiply(mesh, engine, l), 16, 3,
                         itemsize=4, transport=tr)
    assert T.bytes_moved() == vol.total
    want = E.multiply(rounded, rounded, mesh, engine=engine, l=l,
                      backend="stacks", transport="dense")
    assert torch.equal(got.mask, want.mask)
    assert torch.equal(got.blocks, want.blocks)


def test_sharded_operands_under_compressed_transport():
    """ShardedBSM operands take compressed transport too (capacities from
    the shards' host masks), bit-exact against dense; an explicit
    under-capacity transport raises instead of dropping blocks."""
    a = _operand(16, 0.15)
    mesh = make_mesh((2, 2, 2), ("l", "r", "c"), device="cpu")
    sa = B.shard_bsm(a, mesh)
    dense = E.multiply(sa, sa, backend="stacks", transport="dense")
    comp = E.multiply(sa, sa, backend="stacks", transport="compressed")
    for x, y in zip(dense.blocks + dense.mask, comp.blocks + comp.mask):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="under-cover"):
        E.multiply(sa, sa, backend="stacks",
                   transport=T.PanelTransport("compressed", 1, 1))
    before = PP.cache_stats()["transport_hits"]
    E.multiply(sa, sa, backend="stacks", transport="compressed")
    assert PP.cache_stats()["transport_hits"] == before + 1
