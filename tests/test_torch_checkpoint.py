"""The port's checkpoint store against the reference's guarantees and
on-disk format: the reference's eight checkpoint cases mirrored
(round trip, atomicity, a corrupt manifest, keep-k GC, shape and
missing-leaf errors, the manager's auto-resume, the mesh in the
manifest), bf16 leaves, and a checkpoint the reference wrote (f32 and
bf16 leaves, raw 2-byte records) read by the port."""
from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jsave
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.tree import leaves


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 8), generator=g),
                   "b": torch.zeros(8),
                   "blocks": [{"h": torch.randn(4, generator=g)
                               .to(torch.bfloat16)} for _ in range(2)]},
        "opt": {"mu": torch.ones((8, 8)),
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def _assert_tree_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t)
    assert latest_step(str(tmp_path)) == 3
    _assert_tree_equal(t, restore_checkpoint(str(tmp_path), 3, _tree(5)))


def test_atomicity_tmp_dirs_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_000000002.tmp")
    os.makedirs(tmp_path / "step_000000005")
    with open(tmp_path / "step_000000005" / "manifest.json", "w") as f:
        json.dump({"step": 5, "complete": False}, f)
    assert latest_step(str(tmp_path)) == 1


def test_corrupt_manifest_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_000000009")
    with open(tmp_path / "step_000000009" / "manifest.json", "w") as f:
        f.write("{not json")
    assert latest_step(str(tmp_path)) == 1


def test_keep_k_gc(tmp_path):
    for s in range(6):
        save_checkpoint(str(tmp_path), s, _tree(), keep=3)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4, 5]


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((4, 4))})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros((8, 8))})


def test_missing_leaf_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((4, 4))})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros((4, 4)),
                                              "extra": torch.zeros(2)})


def test_manager_auto_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.restore_latest(_tree()) is None
    mgr.save(10, _tree(1))
    mgr.save(20, _tree(2))
    step, tree = mgr.restore_latest(_tree())
    assert step == 20
    _assert_tree_equal(tree, _tree(2))
    assert latest_step(str(tmp_path)) == 20


def test_manifest_carries_mesh_and_names(tmp_path):
    mesh = Mesh(("data",), (1,), (torch.device("cpu"),))
    save_checkpoint(str(tmp_path), 1, _tree(), mesh=mesh)
    with open(tmp_path / "step_000000001" / "manifest.json") as f:
        m = json.load(f)
    assert m["mesh"] == {"shape": [1], "axes": ["data"]}
    assert m["complete"] is True and m["step"] == 1
    entry = m["leaves"]["params__blocks__1__h"]
    assert entry == {"file": "params__blocks__1__h.npy", "shape": [4],
                     "dtype": "bfloat16"}
    assert m["leaves"]["opt__step"]["dtype"] == "int32"
    # bf16 leaves are raw 2-byte records, as numpy saves ml_dtypes arrays
    raw = np.load(tmp_path / "step_000000001" / "params__blocks__1__h.npy")
    assert raw.dtype.kind == "V" and raw.dtype.itemsize == 2


def test_reads_a_checkpoint_the_reference_wrote(tmp_path):
    """The reference's ``save_checkpoint`` on f32, bf16 and int32 leaves;
    the port restores each bit for bit into its own tree of tensors."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    h = rng.standard_normal(7).astype(np.float32)
    jtree = {"params": {"w": jnp.asarray(w),
                        "h": jnp.asarray(h, jnp.bfloat16)},
             "opt": {"step": jnp.asarray(3, jnp.int32)}}
    jsave(str(tmp_path), 4, jtree)
    like = {"params": {"w": torch.zeros(6, 5),
                       "h": torch.zeros(7, dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(0, dtype=torch.int32)}}
    got = restore_checkpoint(str(tmp_path), latest_step(str(tmp_path)),
                             like)
    assert torch.equal(got["params"]["w"], torch.from_numpy(w))
    want_h = np.array(jnp.asarray(h, jnp.bfloat16).astype(jnp.float32))
    assert got["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["h"].float(), torch.from_numpy(want_h))
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 3 and got["opt"]["step"].dim() == 0
    # and the file the port writes for a bf16 leaf is the reference's
    save_checkpoint(str(tmp_path / "port"), 4, got)
    for name in ("params__h.npy", "params__w.npy"):
        with open(tmp_path / "step_000000004" / name, "rb") as f:
            theirs = f.read()
        with open(tmp_path / "port" / "step_000000004" / name, "rb") as f:
            assert f.read() == theirs, name


def test_sharded_save_restores_onto_other_meshes(tmp_path):
    """``check_checkpoint_cross_mesh``'s elastic path: a tree sharded on a
    (data 2, model 2) mesh of ranks is saved gathered, then restored onto
    (1, 1) as plain tensors and onto (4, 1) re-sharded to that mesh's
    specs: the trees are equal."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import (
        P,
        Shards,
        shard_tree,
        unshard_tree,
    )

    full = {"w": torch.arange(64.0).reshape(8, 8),
            "h": torch.arange(16.0).to(torch.bfloat16).reshape(4, 4),
            "step": torch.tensor(3, dtype=torch.int32)}
    mesh_a = make_mesh((2, 2), ("data", "model"), "cpu")
    specs_a = {"w": P("data", "model"), "h": P(None, "model"), "step": P()}
    save_checkpoint(str(tmp_path), 1, shard_tree(mesh_a, full, specs_a),
                    mesh=mesh_a, specs=specs_a)
    with open(tmp_path / "step_000000001" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["mesh"] == {"shape": [2, 2], "axes": ["data", "model"]}
    assert manifest["leaves"]["w"]["shape"] == [8, 8]
    _assert_tree_equal(restore_checkpoint(str(tmp_path), 1, full), full)
    mesh_b = make_mesh((4, 1), ("data", "model"), "cpu")
    specs_b = {"w": P("data", None), "h": P("data", "model"), "step": P()}
    like = shard_tree(mesh_b, {k: torch.zeros_like(v) for k, v in
                               full.items()}, specs_b)
    got = restore_checkpoint(str(tmp_path), 1, like, mesh=mesh_b,
                             specs=specs_b)
    assert isinstance(got["w"], Shards) and tuple(got["w"][0].shape) == (2, 8)
    _assert_tree_equal(unshard_tree(mesh_b, got, specs_b), full)
    with pytest.raises(ValueError, match="does not shard"):
        restore_checkpoint(str(tmp_path), 1, shard_tree(
            mesh_b, {"w": torch.zeros(8, 4), "h": full["h"],
                     "step": full["step"]}, specs_b), mesh=mesh_b,
            specs=specs_b)


def test_per_rank_state_restores_exactly_onto_its_own_mesh(tmp_path):
    """A leaf whose replicas hold different values (each data rank's
    compression residual) is saved rank by rank and restored exactly onto
    the mesh that saved it; onto another mesh it raises.  A leaf whose
    replicas agree is saved gathered, as before."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import P, Shards, shard, zeros

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    specs = {"r": P(None, "model"), "w": P(None, "model")}
    g = torch.Generator().manual_seed(0)
    own = Shards(torch.randn((4, 2), generator=g) for _ in range(4))
    tree = {"r": own, "w": shard(mesh, torch.arange(16.0).reshape(4, 4),
                                 specs["w"])}
    save_checkpoint(str(tmp_path), 1, tree, mesh=mesh, specs=specs)
    with open(tmp_path / "step_000000001" / "manifest.json") as f:
        index = json.load(f)["leaves"]
    assert index["r"]["per_rank"] and len(index["r"]["files"]) == 4
    assert "per_rank" not in index["w"] and index["w"]["shape"] == [4, 4]
    like = {"r": zeros(mesh, (4, 4), specs["r"], torch.float32,
                       per_rank=True),
            "w": zeros(mesh, (4, 4), specs["w"], torch.float32)}
    got = restore_checkpoint(str(tmp_path), 1, like, mesh=mesh, specs=specs)
    for a, b in zip(got["r"], own):
        assert torch.equal(a, b)
    _assert_tree_equal(list(got["w"]), list(tree["w"]))
    other = make_mesh((4, 1), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="per-rank state"):
        restore_checkpoint(str(tmp_path), 1, {
            "r": zeros(other, (4, 4), specs["r"], torch.float32,
                       per_rank=True),
            "w": zeros(other, (4, 4), specs["w"], torch.float32)},
            mesh=other, specs=specs)
