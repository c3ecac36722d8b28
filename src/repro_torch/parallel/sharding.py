"""Parameter / activation / cache sharding rules for the LM stack — the
twin of ``repro/parallel/sharding.py`` — and the placement of trees onto a
mesh of ranks.

Strategy (the reference's):

* ``model`` axis — tensor parallel: d_ff of every MLP and expert, attention
  heads (where the head count divides), vocab dim of embedding & LM head.
* ``data`` axis — batch data-parallel, *and* FSDP for the non-TP dim of
  every large parameter (ZeRO-3: gathered per layer).
* ``pod`` axis (multi-pod mesh) — pure DP for the baseline; the 2.5D LM
  matmul (``parallel/matmul_2p5d.py``) claims it under ``head_2p5d``.

Divisibility is checked per leaf: a dim is only sharded when the axis size
divides it (qwen1.5-4b's 20 heads stay unsharded on a 16-way model axis
while its 6912 d_ff shards cleanly).  All rules are pure functions of
(path, shape, axis sizes); ``mesh`` arguments need only ``shape`` (axis
name -> size) and, for the batch rules, ``axis_names``.

A spec is a ``P``: one entry per dimension, an axis name, a tuple of axis
names (the dimension split over their product, the first name slowest) or
``None``.  The reference stacks each pattern position's layers under
``blocks/<position>`` with a leading repetitions dim, which ``leaf_spec``
strips; the port keeps one dict per layer, so ``param_specs`` maps each of
its paths to the reference's (``ref_path``) and drops that leading entry.

``input_specs_sharded`` gives the dry run's model inputs their specs.
The reference's ``to_named`` (a spec tree to jax ``NamedSharding``s) has
no counterpart: the port places a tree on its ranks with ``shard_tree``
(or, with nothing allocated, ``zeros`` on ``meta`` ranks), as ROADMAP.md
says of ``compat.py``.

On a mesh of ranks a sharded leaf is a ``Shards``: one tensor per rank,
indexed by the flattened rank, each the rank's chunk of the full tensor
under its spec (ranks holding the same chunk share one tensor).  ``shard``
/ ``unshard`` and their tree forms place a full tree and gather it back;
they move host-side data, not collective traffic, and count no bytes.
"""
from __future__ import annotations

import math
import re
from collections import namedtuple
from typing import Any

import torch

from repro_torch.parallel.ctx import ShardingRules


class P(tuple):
    """A partition spec (``jax.sharding.PartitionSpec``'s entries)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


class Shards(tuple):
    """One tensor per rank of a mesh, by flattened rank.  A tuple, so the
    tree functions of ``optim.tree`` take it as one leaf."""


Leaf = namedtuple("Leaf", "shape dtype")

# parameter-name -> (row rule, col rule) for 2D weight leaves;
# "fsdp" shards over data, "tp" over model, None replicates.
_MATMUL_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    # embeddings: vocab over model (vocab-parallel logits), d over data
    (r"embed/(tok|out)$", ("tp", "fsdp")),
    # attention
    (r"attn/wq$", ("fsdp", "tp")),
    (r"attn/wk$", ("fsdp", "tp")),
    (r"attn/wv$", ("fsdp", "tp")),
    (r"attn/wo$", ("tp", "fsdp")),
    (r"xattn/wq$", ("fsdp", "tp")),
    (r"xattn/wk$", ("fsdp", "tp")),
    (r"xattn/wv$", ("fsdp", "tp")),
    (r"xattn/wo$", ("tp", "fsdp")),
    (r"attn/b[qkv]$", ("tp",)),
    # dense MLP
    (r"mlp/w_in$", ("fsdp", "tp")),
    (r"mlp/w_gate$", ("fsdp", "tp")),
    (r"mlp/w_out$", ("tp", "fsdp")),
    # MoE — tp impl: experts over data (FSDP), d_expert over model
    (r"moe/router$", ("fsdp", None)),
    (r"moe/w_in$", ("fsdp", None, "tp")),
    (r"moe/w_gate$", ("fsdp", None, "tp")),
    (r"moe/w_out$", ("fsdp", "tp", None)),
    (r"moe/shared_in$", ("fsdp", "tp")),
    (r"moe/shared_gate$", ("fsdp", "tp")),
    (r"moe/shared_out$", ("tp", "fsdp")),
    # mamba
    (r"mamba/in_proj$", ("fsdp", "tp")),
    (r"mamba/conv_w$", (None, "tp")),
    (r"mamba/conv_b$", ("tp",)),
    (r"mamba/x_proj$", ("tp", None)),
    (r"mamba/dt_proj$", (None, "tp")),
    (r"mamba/dt_bias$", ("tp",)),
    (r"mamba/a_log$", ("tp", None)),
    (r"mamba/d_skip$", ("tp",)),
    (r"mamba/out_proj$", ("tp", "fsdp")),
    # rwkv6
    (r"rwkv/w[rkvg]$", ("fsdp", "tp")),
    (r"rwkv/wo$", ("tp", "fsdp")),
    (r"rwkv/decay_w1$", ("fsdp", None)),
    (r"rwkv/decay_w2$", (None, "tp")),
    (r"rwkv/ck$", ("fsdp", "tp")),
    (r"rwkv/cv$", ("tp", "fsdp")),
    (r"rwkv/cr$", ("fsdp", "tp")),
]

_EP_OVERRIDES: list[tuple[str, tuple[str | None, ...]]] = [
    # ep impl: experts over model, FSDP on d_model
    (r"moe/router$", ("fsdp", None)),
    (r"moe/w_in$", ("tp", "fsdp", None)),
    (r"moe/w_gate$", ("tp", "fsdp", None)),
    (r"moe/w_out$", ("tp", None, "fsdp")),
]


def _axes(mesh) -> dict[str, int]:
    """Axis name -> size of a mesh (anything with ``shape``) or a dict."""
    return dict(mesh) if isinstance(mesh, dict) else dict(mesh.shape)


def _axis_ok(dim: int, axis: str | None, axes: dict[str, int]) -> bool:
    return axis is not None and axis in axes and dim % axes[axis] == 0


def leaf_spec(
    path_s: str,
    shape: tuple[int, ...],
    axes: dict[str, int],
    *,
    fsdp_axis: str | tuple[str, ...] | None = "data",
    moe_impl: str = "tp",
    head_2p5d: bool = False,
) -> P:
    """Spec of one parameter leaf at the reference's path (a leaf under
    ``blocks`` carries the leading repetitions dim)."""
    stacked = "blocks" in path_s  # scanned layers carry a leading reps dim
    core = shape[1:] if stacked else shape

    if head_2p5d and "pod" in axes and re.search(r"embed/out$", path_s):
        # the paper's 2.5D schedule on the LM head: vocab over TP, the
        # d_model contraction dim over the pod axis (depth L)
        v, d = core
        if v % axes.get("model", 1) == 0 and d % axes["pod"] == 0:
            parts = ["model", "pod"]
            return P(*([None] + parts)) if stacked else P(*parts)

    rules = _MATMUL_RULES
    if moe_impl == "ep":
        overridden = {pat for pat, _ in _EP_OVERRIDES}
        rules = _EP_OVERRIDES + [r for r in rules if r[0] not in overridden]

    entry: tuple[str | None, ...] | None = None
    for pat, spec in rules:
        if re.search(pat, path_s):
            entry = spec
            break
    if entry is None or len(entry) != len(core):
        return P(*([None] * len(shape)))  # norms, scalars, unmatched leaves

    def resolve(dim: int, role: str | None):
        if role == "tp":
            return "model" if _axis_ok(dim, "model", axes) else None
        if role == "fsdp":
            if fsdp_axis is None:
                return None
            fa = fsdp_axis if isinstance(fsdp_axis, tuple) else (fsdp_axis,)
            total = 1
            for a in fa:
                total *= axes.get(a, 1)
            if dim % total == 0:
                return fsdp_axis
            if dim % axes.get("data", 1) == 0:
                return "data"
            return None
        return None

    parts = [resolve(d, r) for d, r in zip(core, entry)]
    if stacked:
        parts = [None] + parts
    return P(*parts)


# ---------------------------------------------------------------------------
# the port's tree <-> the reference's paths
# ---------------------------------------------------------------------------


def _walk(tree, path=()):
    """(path tuple, leaf) pairs of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def _build(tree, fn, path=()):
    """``tree`` rebuilt with ``fn(path, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: _build(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_build(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def ref_path(cfg, path) -> tuple[str, int | None]:
    """(the reference's path string, repetitions or None) of a port leaf.

    The port's layer ``l`` of ``blocks`` is the reference's pattern
    position ``l % period``, stacked over ``n_layers // period``
    repetitions; whisper's encoder blocks are one position stacked over
    the encoder's layers."""
    parts = list(path.split("/") if isinstance(path, str) else path)
    if parts[:2] == ["encoder", "blocks"]:
        return "/".join(["encoder", "blocks", "0"] + parts[3:]), \
            cfg.encoder.n_layers
    if parts[0] == "blocks":
        period = cfg.layer_pattern_period
        pos = int(parts[1]) % period
        return "/".join(["blocks", str(pos)] + parts[2:]), \
            cfg.n_layers // period
    return "/".join(parts), None


def param_specs(cfg, params_shape: Any, mesh, *, fsdp_axis="data",
                head_2p5d: bool = False) -> Any:
    """Spec tree matching the port's params tree (leaves: anything with a
    ``shape``), each the reference's ``leaf_spec`` at the leaf's reference
    path (``ref_path``) without the repetitions entry."""
    axes = _axes(mesh)
    moe_impl = cfg.moe.impl if cfg.moe else "tp"

    def rule(path, leaf):
        rp, reps = ref_path(cfg, path)
        shape = tuple(leaf.shape)
        if reps is not None:
            shape = (reps,) + shape
        spec = leaf_spec(rp, shape, axes, fsdp_axis=fsdp_axis,
                         moe_impl=moe_impl, head_2p5d=head_2p5d)
        return P(*spec[1:]) if reps is not None else spec

    return _build(params_shape, rule)


def param_shapes(cfg) -> Any:
    """The params tree of ``cfg`` as ``Leaf(shape, dtype)``, drawn under
    a fake tensor mode: no memory, any width."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import transformer as T

    with FakeTensorMode():
        fake = T.init_params(cfg, 0, device="cpu")
    return _build(fake, lambda _, t: Leaf(tuple(t.shape), t.dtype))


def cache_shapes(cfg, batch: int, max_len: int) -> Any:
    """The decode cache tree of ``cfg`` (``transformer.init_cache``) as
    ``Leaf(shape, dtype)``, under a fake tensor mode like
    ``param_shapes``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import transformer as T

    with FakeTensorMode():
        fake = T.init_cache(cfg, batch, max_len, device="cpu")
    return _build(fake, lambda _, t: Leaf(tuple(t.shape), t.dtype))


# ---------------------------------------------------------------------------
# batch / activations / cache
# ---------------------------------------------------------------------------


def batch_axes(mesh) -> tuple[str, ...] | str:
    names = mesh.axis_names
    return ("pod", "data") if "pod" in names else "data"


def entry_axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _size(axes: dict[str, int], entry) -> int:
    return math.prod(axes.get(a, 1) for a in entry_axes(entry))


def batch_spec(mesh, batch: int, *extra_dims: int) -> P:
    ba = batch_axes(mesh)
    lead = ba if batch % _size(_axes(mesh), ba) == 0 else None
    return P(lead, *([None] * len(extra_dims)))


def activation_rules(
    cfg, mesh, *, batch: int, seq_parallel: bool = False,
    head_2p5d: bool = False, reduce_dtype=None,
) -> ShardingRules:
    """The reference's activation table (``btd``, ``btd_full``, ``bhsd``,
    ``bksd``, ``logits``; ``moe_*`` under ep; ``ce_in`` under head_2p5d)
    as ``P`` specs; the sharded runtime (``parallel/runtime.py``) reads
    it at the reference's cut points."""
    axes = _axes(mesh)
    ba = batch_axes(mesh)
    b = ba if batch % _size(axes, ba) == 0 else None
    m = axes.get("model", 1)
    h_ok = cfg.n_heads % m == 0
    kv_ok = cfg.n_kv_heads % m == 0
    table = {
        # residual stream: seq-sharded over `model` under sequence
        # parallelism (Megatron-SP)
        "btd": P(b, "model", None) if seq_parallel else P(b, None, None),
        # matmul inputs: always full-seq
        "btd_full": P(b, None, None),
        "bhsd": P(b, "model" if h_ok else None, None, None),
        "bksd": P(b, "model" if kv_ok else None, None, None),
        "logits": P(b, None, "model"),
    }
    if cfg.moe is not None and cfg.moe.impl == "ep":
        table["moe_dispatch"] = P(b, "model", None, None)
        table["moe_combine"] = P(b, None, None, None)
    if head_2p5d and "pod" in axes and cfg.d_model % axes["pod"] == 0:
        # CE-chunk input x (B, chunk, d): d split over the pod axis so the
        # LM-head contraction runs as per-pod partial products (2.5D depth)
        bb = "data" if b is not None else None
        table["ce_in"] = P(bb, None, "pod")
    return ShardingRules(table=table, reduce_dtype=reduce_dtype)


def cache_specs(cfg, cache_shape: Any, mesh, *, batch: int) -> Any:
    """Spec tree for the port's per-layer decode cache (KV + recurrent
    states), the reference's rules without its repetitions entry.

    KV: batch over (pod, data) when divisible; kv-heads over model when
    divisible, else the *sequence* dim over model (flash-decoding layout).
    """
    axes = _axes(mesh)
    ba = batch_axes(mesh)
    b = ba if batch % _size(axes, ba) == 0 else None
    m = axes.get("model", 1)

    def rule(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        if name in ("k", "v", "xk", "xv"):  # (B, hkv, S, hd)
            _, hkv, s, _ = shape
            if hkv % m == 0:
                return P(b, "model", None, None)
            if s % m == 0:
                return P(b, None, "model", None)
            return P(b, None, None, None)
        if name.endswith("ssm"):  # (B, di, n)
            return P(b, "model" if shape[1] % m == 0 else None, None)
        if name.endswith("conv"):  # (B, dc-1, di)
            return P(b, None, "model" if shape[2] % m == 0 else None)
        if name.endswith("wkv"):  # (B, h, hd, hd)
            return P(b, "model" if shape[1] % m == 0 else None, None, None)
        if "shift" in name:  # (B, d)
            return P(b, None)
        return P(*([None] * len(shape)))

    return _build(cache_shape, rule)


def input_specs_sharded(cfg, shape, mesh) -> dict[str, P]:
    """Specs of the dry run's model inputs (``config.input_specs``): the
    batch dim over the batch axes when it divides, a scalar replicated."""
    from repro_torch.config import input_specs

    out = {}
    for name, leaf in input_specs(cfg, shape).items():
        if len(leaf.shape) == 0:
            out[name] = P()
        else:
            out[name] = batch_spec(mesh, leaf.shape[0], *leaf.shape[1:])
    return out


# ---------------------------------------------------------------------------
# placement on a mesh of ranks
# ---------------------------------------------------------------------------


def chunk_index(mesh, spec, rank: int) -> tuple[tuple[int, int], ...]:
    """(chunk index, chunk count) of every dim of ``rank``'s shard."""
    pos = dict(zip(mesh.axis_names, mesh.coords(rank)))
    sizes = dict(mesh.shape)
    out = []
    for entry in spec:
        idx, n = 0, 1
        for a in entry_axes(entry):
            idx, n = idx * sizes[a] + pos[a], n * sizes[a]
        out.append((idx, n))
    return tuple(out)


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    axes = _axes(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        n = _size(axes, entry)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {entry}")
        out.append(dim // n)
    return tuple(out)


def take(x: torch.Tensor, index) -> torch.Tensor:
    """The chunk of ``x`` that ``index`` (``chunk_index``) names (a
    view)."""
    for dim, (i, n) in enumerate(index):
        if n > 1:
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split into {n}")
            w = x.shape[dim] // n
            x = x.narrow(dim, i * w, w)
    return x


def shard(mesh, x: torch.Tensor, spec) -> Shards:
    """``x`` placed on the ranks by ``spec``: each rank's chunk, contiguous
    on its device; ranks with the same chunk share one tensor."""
    spec = P(*spec) if len(spec) else P(*([None] * x.dim()))
    out, seen = [], {}
    for r in range(mesh.size):
        key = (chunk_index(mesh, spec, r), mesh.home(r))
        if key not in seen:
            seen[key] = take(x, key[0]).to(mesh.devices[r],
                                           copy=True).contiguous()
        out.append(seen[key])
    return Shards(out)


def unshard(mesh, xs, spec, device=None) -> torch.Tensor:
    """The full tensor from its shards (the inverse of ``shard``), on
    ``device`` (rank 0's by default)."""
    dev = mesh.devices[0] if device is None else device
    pieces = {}
    for r in range(mesh.size):
        pieces.setdefault(chunk_index(mesh, spec, r), xs[r])

    def join(dim, prefix):
        if dim == len(spec):
            return pieces[prefix].to(dev)
        n = _size(dict(mesh.shape), spec[dim])
        parts = [join(dim + 1, prefix + ((i, n),)) for i in range(n)]
        return parts[0] if n == 1 else torch.cat(parts, dim=dim)

    if not len(spec):
        return xs[0].to(dev)
    return join(0, ())


def zeros(mesh, shape, spec, dtype, *, per_rank: bool = False) -> Shards:
    """Zero shards of a ``shape`` tensor laid out by ``spec``: one tensor
    per distinct chunk (shared by its replicas), or with ``per_rank`` one
    per rank (state a rank updates on its own)."""
    loc = local_shape(shape, spec, mesh)
    out, seen = [], {}
    for r in range(mesh.size):
        key = r if per_rank else (chunk_index(mesh, spec, r),
                                  mesh.home(r))
        if key not in seen:
            seen[key] = torch.zeros(loc, dtype=dtype,
                                    device=mesh.devices[r])
        out.append(seen[key])
    return Shards(out)


def shard_tree(mesh, tree: Any, specs: Any) -> Any:
    """Every leaf of ``tree`` placed by its spec in ``specs``; a 0-d
    leaf (the optimizer's step) stays one tensor."""
    flat = dict(_walk(specs))
    return _build(tree, lambda path, x: x if x.dim() == 0
                  else shard(mesh, x, flat[path]))


def unshard_tree(mesh, tree: Any, specs: Any, device=None) -> Any:
    """The full tree from a sharded one (``Shards`` leaves gathered)."""
    flat = dict(_walk(specs))
    return _build(tree, lambda path, x: unshard(mesh, x, flat[path], device)
                  if isinstance(x, Shards) else x)
