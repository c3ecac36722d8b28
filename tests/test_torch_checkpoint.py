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
