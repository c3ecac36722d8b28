"""Checkpoint store: atomic, step-tagged, keep-k — the twin of
``repro/checkpoint/store.py``, in its on-disk format.

Layout:

    <dir>/step_000000123/
        manifest.json     — step, mesh shape / axes, leaf index, status
        <leaf_id>.npy     — one file per leaf (host numpy)

Guarantees (the reference's):

* **Atomicity** — written to ``step_N.tmp`` and renamed; the manifest
  with ``"complete": true`` is written last, so a crash mid-save leaves
  either a previous valid step or an ignorable tmp dir.  ``latest_step``
  returns complete checkpoints only.
* **Keep-k GC** — older complete steps beyond ``keep`` are removed after
  a successful save (never before).
* **Checked restore** — a leaf missing from the checkpoint raises
  ``KeyError``, a shape that differs from the tree it restores into
  raises ``ValueError``.

Sharded trees (``parallel.sharding.Shards`` leaves, a mesh of ranks) are
saved gathered — the on-disk format does not change — with the mesh in
the manifest, and restored onto any mesh by re-sharding each leaf to the
specs given for the current one (the reference's elastic restart).  A
leaf whose replicas hold differing values (the per-rank compression
residual: each data rank's own) is saved rank by rank instead,
``<leaf_id>.rank<r>.npy`` with ``"per_rank": true`` in its index entry,
and restores only onto the mesh that saved it; onto another mesh it
raises ``ValueError``, as no re-sharding of per-rank state is exact.

Leaf ids are the paths of dict keys and list indices joined with ``__``
in the port's own tree (one dict per layer, where the reference stacks a
pattern position's layers).  bf16 leaves: numpy has no bfloat16, and the
reference's ``np.save`` of an ``ml_dtypes`` array writes raw 2-byte
records (descr ``<V2``) with ``"bfloat16"`` in the manifest.  The port
writes them the same way, from the tensor's bits viewed as int16, and
reads them back by viewing the records as int16 and then bfloat16, guided
by the manifest; neither side needs ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.optim.tree import named_leaves, tree_map

# the header numpy writes for an ml_dtypes bfloat16 array: 2-byte raw
# records, little-endian (numpy's own V2 dtype would say "|V2")
_BF16_DESCR = "<V2"
_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16, "float16": torch.float16,
          "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _save(path: str, t: torch.Tensor) -> None:
    """One leaf as ``.npy``; bf16 as the reference writes it, byte for
    byte (its bits, under the ``<V2`` header)."""
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        np.save(path, t.numpy())
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": tuple(t.shape)})
        f.write(t.view(torch.int16).numpy().tobytes())


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        raw = np.array(a).view(np.int16)  # a 0-d array stays 0-d
        return torch.from_numpy(raw).view(torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(_TORCH[dtype])


def _mesh_meta(mesh) -> dict:
    if mesh is None:
        return {"shape": None, "axes": None}
    return {"shape": [int(n) for n in mesh.sizes],
            "axes": list(mesh.axis_names)}


def _replicas_differ(mesh, xs, spec) -> bool:
    """Whether two ranks that ``spec`` gives the same chunk hold
    different values."""
    from repro_torch.parallel.sharding import chunk_index

    first = {}
    for r, t in enumerate(xs):
        key = chunk_index(mesh, spec, r)
        if key not in first:
            first[key] = t
        elif t is not first[key] and not torch.equal(
                t.to(first[key].device), first[key]):
            return True
    return False


def _gathered(tree: Any, mesh, specs) -> list[tuple[str, Any]]:
    """(name, full tensor) of every leaf, ``Shards`` gathered by their
    spec in ``specs`` onto the CPU; (name, list of every rank's tensor)
    for a ``Shards`` leaf whose replicas differ."""
    from repro_torch.parallel.sharding import Shards, unshard

    spec_of = dict(named_leaves(specs)) if specs is not None else {}
    out = []
    for name, leaf in named_leaves(tree):
        if isinstance(leaf, Shards):
            if _replicas_differ(mesh, leaf, spec_of[name]):
                out.append((name, [t.cpu() for t in leaf]))
                continue
            leaf = unshard(mesh, leaf, spec_of[name], device="cpu")
        out.append((name, torch.as_tensor(leaf)))
    return out


def save_checkpoint(directory: str, step: int, tree: Any, *, mesh=None,
                    keep: int = 3, specs: Any = None) -> str:
    """Atomically save ``tree`` (nested dicts / lists of tensors) as step
    ``step``; ``mesh`` (a ``launch.mesh.Mesh``) goes into the manifest.
    ``Shards`` leaves are gathered by their spec in ``specs`` (a tree of
    the same structure).  Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    index = {}
    for name, leaf in _gathered(tree, mesh, specs):
        if isinstance(leaf, list):  # per-rank state, rank by rank
            files = [f"{name}.rank{r}.npy" for r in range(len(leaf))]
            for fname, t in zip(files, leaf):
                _save(os.path.join(tmp, fname), t)
            index[name] = {"files": files, "shape": list(leaf[0].shape),
                           "dtype": _dtype_name(leaf[0]), "per_rank": True}
            continue
        fname = f"{name}.npy"
        _save(os.path.join(tmp, fname), leaf)
        index[name] = {"file": fname, "shape": list(leaf.shape),
                       "dtype": _dtype_name(leaf)}
    manifest = {"step": step, "complete": True, "leaves": index,
                "mesh": _mesh_meta(mesh)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if not m:
            continue
        try:
            with open(os.path.join(directory, name, "manifest.json")) as f:
                if json.load(f).get("complete"):
                    steps.append(int(m.group(1)))
        except (OSError, json.JSONDecodeError):
            continue
    return sorted(steps)


def _gc(directory: str, keep: int) -> None:
    for s in _steps(directory)[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int, tree_like: Any, *,
                       mesh=None, specs: Any = None) -> Any:
    """Restore into the structure of ``tree_like`` (tensors, or anything
    with a ``shape``), each leaf in the checkpoint's dtype on the device of
    its ``tree_like`` leaf (the CPU for a leaf that is not a tensor).  A
    ``Shards`` leaf is restored whole and re-sharded onto ``mesh`` by its
    spec in ``specs``, whatever mesh saved it; a leaf saved rank by rank
    only onto the mesh that saved it."""
    from repro_torch.parallel.sharding import Shards, local_shape, shard

    spec_of = dict(named_leaves(specs)) if specs is not None else {}
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    index = manifest["leaves"]
    restored = {}
    for name, like in named_leaves(tree_like):
        if name not in index:
            raise KeyError(f"checkpoint {path} missing leaf {name}")
        entry = index[name]
        if entry.get("per_rank"):
            restored[name] = _restore_per_rank(path, name, entry, like,
                                               manifest["mesh"], mesh)
            continue
        arr = np.load(os.path.join(path, entry["file"]))
        if isinstance(like, Shards):
            spec = spec_of[name]
            if local_shape(arr.shape, spec, mesh) != tuple(like[0].shape):
                raise ValueError(f"{name}: checkpoint shape {arr.shape} "
                                 f"does not shard as {tuple(like[0].shape)}"
                                 f" under {spec}")
            restored[name] = shard(mesh, _from_numpy(arr, entry["dtype"]),
                                   spec)
            continue
        expected = tuple(getattr(like, "shape", arr.shape))
        if tuple(arr.shape) != expected:
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                             f"{expected}")
        dev = like.device if isinstance(like, torch.Tensor) else "cpu"
        restored[name] = _from_numpy(arr, entry["dtype"]).to(dev)
    names = iter(name for name, _ in named_leaves(tree_like))
    return tree_map(lambda _: restored[next(names)], tree_like)


def _restore_per_rank(path, name, entry, like, saved, mesh):
    """A leaf saved rank by rank, onto the mesh that saved it."""
    from repro_torch.parallel.sharding import Shards

    if not isinstance(like, Shards) or _mesh_meta(mesh) != saved:
        raise ValueError(
            f"{name}: per-rank state saved on mesh {saved['shape']} "
            f"{saved['axes']} restores only onto that mesh, not "
            f"{_mesh_meta(mesh)['shape']}")
    out = []
    for fname, t in zip(entry["files"], like):
        x = _from_numpy(np.load(os.path.join(path, fname)), entry["dtype"])
        if tuple(x.shape) != tuple(t.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(x.shape)} "
                             f"!= {tuple(t.shape)}")
        out.append(x.to(t.device))
    return Shards(out)


class CheckpointManager:
    """Keep-k manager + auto-resume used by ``launch/train.py``."""

    def __init__(self, directory: str, *, keep: int = 3, mesh=None,
                 specs: Any = None):
        self.directory = directory
        self.keep = keep
        self.mesh = mesh
        self.specs = specs  # for sharded trees: their spec tree

    def save(self, step: int, tree: Any) -> str:
        return save_checkpoint(self.directory, step, tree, mesh=self.mesh,
                               keep=self.keep, specs=self.specs)

    def latest(self) -> int | None:
        return latest_step(self.directory)

    def restore_latest(self, tree_like: Any) -> tuple[int, Any] | None:
        step = self.latest()
        if step is None:
            return None
        return step, restore_checkpoint(self.directory, step, tree_like,
                                        mesh=self.mesh, specs=self.specs)
