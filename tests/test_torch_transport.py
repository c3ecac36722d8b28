"""The port's panel transport over rank lists: ``permute`` follows
``lax.ppermute`` (axis-local and flattened, zero-fill, no aliasing), the
all-gather and the sums over ``l``, and the byte counter equals
``commvolume.plan_volume`` — the port's copy and the reference's — for
every plan the engines run."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import commvolume as RC
from repro.core import plan as RP
from repro_torch.core import bsm as B
from repro_torch.core import commvolume as PC
from repro_torch.core import engine as E
from repro_torch.core import plan as PP
from repro_torch.core import transport as T
from repro_torch.launch.mesh import make_mesh, make_spgemm_mesh

from test_torch_plan_schedule import PLANS, DuckMesh, _mesh


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small operations per rank: with several test workers on the
    machine, torch's intra-op threads would only spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(mesh, seed=0, shape=(2, 3, 4, 4)):
    """(blocks, mask) lists with distinct values per rank."""
    g = torch.Generator().manual_seed(seed)
    blocks = [torch.randn(shape, generator=g) for _ in range(mesh.size)]
    mask = [torch.rand(shape[:2], generator=g) < 0.5 for _ in range(mesh.size)]
    return blocks, mask


def test_mesh_ranks_and_groups():
    mesh = make_mesh((2, 3, 4), ("l", "r", "c"), device="cpu")
    assert mesh.size == 24 and list(mesh.shape.items()) == [
        ("l", 2), ("r", 3), ("c", 4)]
    for r in range(mesh.size):
        assert mesh.rank(mesh.coords(r)) == r
    assert mesh.coords(23) == (1, 2, 3)
    # a row of one layer, a column, the flattened domain
    assert mesh.groups("c")[5] == [mesh.rank((1, 2, c)) for c in range(4)]
    assert mesh.groups("r")[0] == [mesh.rank((0, r, 0)) for r in range(3)]
    assert mesh.groups(("l", "r", "c")) == [list(range(24))]
    assert mesh.groups("l")[0] == [0, 12]
    assert mesh.home_ranks() == list(range(12))
    assert hash(mesh) == hash(make_mesh((2, 3, 4), ("l", "r", "c"),
                                        device="cpu"))
    with pytest.raises(ValueError, match="stacked"):
        make_spgemm_mesh(p_r=2, p_c=4, l=2, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        make_mesh((2, 2), ("r", "c"), device=["cpu", "cpu"])


@pytest.mark.parametrize("axes,pairs", [
    ("c", ((0, 1), (2, 3))),  # inside every row, partial
    ("r", ((1, 0),)),  # inside every column
    (("r", "c"), ((0, 7), (5, 2), (3, 3))),  # flattened, with a self-pair
])
def test_permute_zero_fills_and_copies(axes, pairs):
    mesh = make_spgemm_mesh(p_r=2, p_c=4, device="cpu")
    state = _state(mesh)
    T.reset_bytes()
    got = T.permute(mesh, state, axes, pairs)
    payload = sum(x[0].numel() * x[0].element_size() for x in state)
    assert T.bytes_moved() == payload  # full payload per hop
    for g in mesh.groups(axes):
        dst_of = {d: s for s, d in pairs}
        for pos, rank in enumerate(g):
            for xs, ys in zip(state, got):
                if pos in dst_of:
                    src = xs[g[dst_of[pos]]]
                    assert torch.equal(ys[rank], src)
                    assert ys[rank].data_ptr() != src.data_ptr()
                else:
                    assert not ys[rank].any()  # zeros, not the old buffer
                    assert ys[rank].dtype == xs[rank].dtype
    # a received tensor is the receiver's own: writing it leaves the source
    before = state[0][g[pairs[0][0]]].clone()
    got[0][g[pairs[0][1]]].add_(1.0)
    assert torch.equal(state[0][g[pairs[0][0]]], before)


def test_permute_on_a_stacked_mesh_stays_in_each_row():
    mesh = make_spgemm_mesh(p=2, l=2, device="cpu")
    blocks, mask = _state(mesh)
    (got,) = T.permute(mesh, (blocks,), "c", ((0, 1), (1, 0)))
    for r in range(mesh.size):
        l, i, j = mesh.coords(r)
        assert torch.equal(got[r], blocks[mesh.rank((l, i, 1 - j))])
    with pytest.raises(ValueError, match="partial permutation"):
        T.permute(mesh, (blocks,), "c", ((0, 1), (1, 1)))


def test_all_gather_and_sums():
    mesh = make_spgemm_mesh(p=2, l=2, device="cpu")
    blocks, mask = _state(mesh)
    T.reset_bytes()
    gb, gm = T.all_gather_panels(mesh, T.DENSE, 0, blocks, mask, "c", axis=1)
    for r in range(mesh.size):
        l, i, _ = mesh.coords(r)
        row = [mesh.rank((l, i, j)) for j in range(2)]
        assert torch.equal(gb[r], torch.cat([blocks[q] for q in row], 1))
        assert torch.equal(gm[r], torch.cat([mask[q] for q in row], 1))
    out = gb[0].numel() * 4 + gm[0].numel()
    assert T.bytes_moved() == out / 2  # (n - 1) / n of the output
    T.reset_bytes()
    s = T.psum(mesh, blocks, "l")
    assert T.bytes_moved() == 2 * 0.5 * blocks[0].numel() * 4
    for r in range(mesh.size):
        _, i, j = mesh.coords(r)
        want = blocks[mesh.rank((0, i, j))] + blocks[mesh.rank((1, i, j))]
        assert torch.equal(s[r], want)
    T.reset_bytes()
    sc = T.psum_scatter(mesh, blocks, "l", dim=0)
    assert T.bytes_moved() == sc[0].numel() * 4  # (n - 1) x output
    for r in range(mesh.size):
        l, i, j = mesh.coords(r)
        assert torch.equal(sc[r], s[r].chunk(2, dim=0)[l])


def test_transport_modes(monkeypatch):
    """A ``PanelTransport`` validates like the reference's; specs resolve
    to one (None through ``REPRO_TRANSPORT``), an under-capacity explicit
    compressed transport raises."""
    ct = T.PanelTransport(mode="compressed", cap_a=8, cap_b=16)
    assert ct.compressed and not T.DENSE.compressed
    assert ct.key == ("compressed", 8, 16) and T.DENSE.key == ("dense", 0, 0)
    bf = T.PanelTransport(wire="bfloat16")
    assert bf.wire_dtype == torch.bfloat16 and bf.wire_itemsize(4) == 2
    assert bf.key == ("dense", 0, 0, "bfloat16") and T.DENSE.wire_itemsize(4) == 4
    for kw, match in ((dict(mode="compressed"), "positive"),
                      (dict(mode="zip"), "unknown transport"),
                      (dict(wire="f16"), "unknown wire")):
        with pytest.raises(ValueError, match=match):
            T.PanelTransport(**kw)
    mesh = make_spgemm_mesh(p=2, device="cpu")
    a = B.random_bsm(1, nb=16, bs=2, occupancy=0.05, pattern="decay",
                     device="cpu")
    assert PP.resolve_transport("dense", a, a, mesh, "cannon") is T.DENSE
    want = PP.resolve_transport("compressed", a, a, mesh, "cannon")
    assert want.compressed
    monkeypatch.setenv("REPRO_TRANSPORT", "dense")
    assert PP.resolve_transport(None, a, a, mesh, "cannon") is T.DENSE
    monkeypatch.setenv("REPRO_TRANSPORT", "compressed")
    assert PP.resolve_transport(None, a, a, mesh, "cannon") == want
    monkeypatch.delenv("REPRO_TRANSPORT")
    assert PP.resolve_transport(None, a, a, mesh, "cannon") == \
        PP.resolve_transport("auto", a, a, mesh, "cannon")
    with pytest.raises(ValueError, match="unknown transport"):
        PP.resolve_transport("zip", a, a, mesh, "cannon")
    with pytest.raises(ValueError, match="under-cover"):
        PP.resolve_transport(T.PanelTransport("compressed", 1, 1), a, a,
                             mesh, "cannon")


@pytest.mark.parametrize(
    "engine,sizes,l,c_layout",
    [(*p, "2d") for p in PLANS]
    + [(e, s, l, "scatter") for e, s, l in PLANS if len(s) == 3], ids=str)
def test_bytes_equal_plan_volume(engine, sizes, l, c_layout):
    """One multiply's counted bytes per rank == ``plan_volume`` of the
    transport the multiply resolved (``transport=None``: the configured
    "auto"), from the port's plan and from the reference's."""
    nb, bs = (12, 3) if sizes == (3, 3) else (16, 3)
    mesh = make_mesh(sizes, _mesh(sizes), device="cpu")
    a = B.random_bsm(3, nb=nb, bs=bs, occupancy=0.3, pattern="decay",
                     device="cpu")
    T.reset_bytes()
    E.multiply(a, a, mesh, engine=engine, l=l, c_layout=c_layout,
               backend="stacks")
    moved = T.bytes_moved()
    tr = PP.resolve_transport(None, a, a, mesh, engine, l)
    mine = PC.plan_volume(PP.plan_multiply(mesh, engine, l), nb, bs,
                          itemsize=4, c_layout=c_layout, transport=tr)
    ref = RC.plan_volume(RP.plan_multiply(DuckMesh(sizes, _mesh(sizes)),
                                          engine, l), nb, bs, itemsize=4,
                         c_layout=c_layout, transport=tr)
    assert moved == mine.total == ref.total
    assert np.isclose(mine.ab_volume + mine.c_volume, moved)
