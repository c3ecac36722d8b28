"""Cost of one traced step — the counterpart of ``repro/roofline/hlo_cost.py``.

The reference re-derives per-device cost from XLA's optimized HLO text
(computations, while-loop trip counts, fusions).  PyTorch runs eagerly and
has no HLO: this module traces the aten ops one call of a step dispatches
(``CostTracer``, a ``TorchDispatchMode``), usually on ``meta`` tensors (the
dry run's abstract ranks, ``launch/mesh.py``) or under a fake tensor mode,
so nothing is computed and nothing is allocated.  Over one call it counts:

* FLOPs, by ``torch.utils.flop_counter``'s registry (the ops that
  ``FlopCounterMode`` counts, decomposed as it decomposes them), the flash
  kernels' ops included (``kernels/flash_attention.py``: kept pairs only);
* HBM bytes: the inputs plus the outputs of every op that is not a view
  or a metadata op (the counterpart of the reference's ``_NO_MEM_OPS``).
  Eager PyTorch does not fuse, so each op is one kernel and each is "top
  level"; an in-place op reads and writes its target;
* collective wire bytes: the change of ``core/transport.bytes_moved()``
  (bytes per destination rank, ``parallel/collectives.py``'s conventions),
  by kind.  The copies and sums that move data between the ranks' tensors
  while a collective runs (``transport.in_collective``) are the wire's
  work: they add no FLOPs or HBM bytes;
* the top ops by FLOPs and by bytes (op and output shape);
* the ops of an eager body: a custom op whose implementation is PyTorch
  code, not a kernel (mamba's chunk of the selective scan,
  ``models/mamba.py``, and rwkv6's chunk of the wkv recurrence,
  ``models/rwkv6.py``, each one op so that a trace of thousands of chunks on
  hundreds of ranks stays quick), counts the ops of its body — traced
  once per input shape in a nested tracer, its FLOPs, bytes and op count
  added at every call, its temporaries added to the live bytes for the
  call's length — as if the body had run op by op;
* the peak of live bytes per device: the call's arguments, plus every
  buffer an op allocates, alive while a tensor the trace saw still views
  it or autograd's graph holds it for the backward (a saved-tensors
  hook).  Kernels' own workspaces and the allocator's caching are not
  seen.  The peak is kept per phase — before the backward, inside it
  (autograd's graph task), after it (the optimizer) — since each phase's
  peak grows with the depth at its own rate, with the live bytes at the
  phase's last allocation (``phase_ends``).

An op belongs to the device of its first output (or input), which splits
the counts by rank where each rank has its own device (a fake tensor mode
keeps ``meta:r``; a plain ``meta`` tensor drops the index, and the dry
run's abstract ranks, ``launch/mesh.py``, trace as plain ``meta`` tensors
for speed).  The ranks of a mesh do equal work, so the cost
per device is the total over the ranks divided by the mesh's size
(``roofline.analyze``), and the memory per device the total live bytes
over the number of devices the ranks sit on (``trace(devices=)``): exact
on one device, and an even share of the ranks' symmetric live sets on the
dry run's meshes.

Trip counts: the reference reads a while loop's trip count from the HLO.
A step here runs its layers in a Python loop, so ``extrapolate`` takes two
traces, of ``layer_pattern_period`` layers and of twice that, and extends
every count linearly to ``n_layers`` (``launch/dryrun.py``).  A phase's
peak can sit at a layer-independent place in a shallow trace (the
embedding's optimizer temporaries, say) and at the last layer's in a
deep one, so the extended peak of a phase is the larger of its extended
peak and its extended live bytes at its last allocation (whose place
does not move); the step's is the largest phase's.

``_collective_wire``, ``spgemm_dense_flops`` and ``spgemm_stacks_flops``
port as they are.  The reference's HLO parsers (``parse_module``,
``analyze_hlo``, ``shape_elems_bytes``, ``xla_cost_analysis``) have no
counterpart.
"""
from __future__ import annotations

import functools
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core import transport as TR
from repro_torch.models import mamba as _MB
from repro_torch.models import rwkv6 as _RW

aten = torch.ops.aten

# custom ops whose implementation is an eager body (mamba's and rwkv6's
# chunk of the recurrence): the tracer counts the body's ops
BODIES = {
    torch.ops.repro_torch.mamba_chunk.default: _MB._chunk_body,
    torch.ops.repro_torch.mamba_chunk_bwd.default: _MB._chunk_back_body,
    torch.ops.repro_torch.rwkv_wkv_chunk.default: _RW._wkv_chunk_body,
    torch.ops.repro_torch.rwkv_wkv_chunk_bwd.default:
        _RW._wkv_chunk_back_body,
}

# queries of a tensor's metadata: no kernel, no bytes
_QUERIES = {
    torch.ops.prim.device.default, torch.ops.prim.layout.default,
    aten.size.default, aten.sym_size.default, aten.sym_size.int,
    aten.stride.default, aten.sym_stride.default,
    aten.sym_stride.int, aten.storage_offset.default,
    aten.sym_storage_offset.default, aten.numel.default,
    aten.sym_numel.default, aten.dim.default, aten.is_contiguous.default,
    aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
    aten.is_non_overlapping_and_dense.default, aten.sym_is_contiguous.default,
}

# ops that allocate or read metadata without moving data: no HBM bytes
_NO_MEM_OPS = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.lift_fresh.default,
    aten._local_scalar_dense.default, aten.set_.source_Storage,
    aten.set_.source_Storage_storage_offset, aten.resize_.default,
}


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    """An op whose every result aliases an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


@functools.lru_cache(maxsize=None)
def _fresh(func) -> bool:
    """An op whose results are new buffers (no result aliases an input)."""
    return all(r.alias_info is None for r in func._schema.returns)


@functools.lru_cache(maxsize=None)
def _decomposes(func) -> bool:
    """Whether ``func.decompose`` has a decomposition to run (the test it
    makes itself, once per op)."""
    dk = torch._C.DispatchKey.CompositeImplicitAutograd
    return (func is not torch.ops.prim.device.default
            and (dk in func.py_kernels
                 or torch._C._dispatch_has_kernel_for_dispatch_key(
                     func.name(), dk)))


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)
_UNKEYED = object()


@functools.lru_cache(maxsize=None)
def _keyable(func) -> bool:
    """An op whose outputs are new tensors made from its inputs' metadata
    alone: mutates nothing, aliases nothing, returns only tensors."""
    sch = func._schema
    return (not sch.is_mutable and bool(sch.returns) and _fresh(func)
            and all(str(r.type) in ("Tensor", "Tensor?", "Tensor[]")
                    for r in sch.returns))


def _key_of(x):
    if type(x) is torch.Tensor:
        if not x.is_meta:
            return _UNKEYED
        return (x.shape, x.stride(), x.storage_offset(), x.dtype)
    if isinstance(x, (list, tuple)):
        items = tuple(_key_of(v) for v in x)
        return _UNKEYED if any(v is _UNKEYED for v in items) else items
    if isinstance(x, _SCALARS):
        return (type(x), x)
    return _UNKEYED


def _meta_key(func, args, kwargs):
    """The op and its arguments' metadata, or None where its outputs may
    depend on more (a tensor off ``meta``, a fake tensor, an argument of
    another kind) or the op writes or aliases."""
    if not _keyable(func):
        return None
    key = _key_of((args, tuple(sorted(kwargs.items()))))
    return None if key is _UNKEYED else (func, key)


def _out_spec(out):
    """The metadata ``_rebuild`` remakes ``out`` from, or False where a new
    buffer of that metadata would differ (off ``meta``, a storage larger
    than the strides need, outputs sharing one)."""
    seen = set()

    def spec(t):
        if t is None:
            return None
        if type(t) is not torch.Tensor or not t.is_meta:
            raise ValueError
        st = t.untyped_storage()
        new = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                  device=t.device)
        if (t.storage_offset() or st._cdata in seen
                or st.nbytes() != new.untyped_storage().nbytes()):
            raise ValueError
        seen.add(st._cdata)
        return (tuple(t.shape), t.stride(), t.dtype, t.device)

    try:
        if isinstance(out, (list, tuple)):
            return (type(out), tuple(spec(t) for t in out))
        return (None, spec(out))
    except ValueError:
        return False


def _rebuild(spec):
    def make(s):
        return None if s is None else torch.empty_strided(
            s[0], s[1], dtype=s[2], device=s[3])

    kind, items = spec
    if kind is None:
        return make(items)
    return kind(tuple(make(s) for s in items))


def _tensors(tree, out=None) -> list[torch.Tensor]:
    """The tensors in a tree of dicts, lists and tuples (``Shards`` too)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class CostReport:
    """One traced call: totals over every rank (FLOPs, HBM bytes) and per
    rank (wire bytes, memory)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_wire_bytes: float = 0.0  # per rank
    by_kind_bytes: dict[str, float] = field(default_factory=dict)
    by_kind_count: dict[str, float] = field(default_factory=dict)
    flops_by_device: dict[str, float] = field(default_factory=dict)
    bytes_by_device: dict[str, float] = field(default_factory=dict)
    flash_bytes: float = 0.0  # HBM bytes of the flash kernels' ops
    argument_bytes: float = 0.0  # per device
    output_bytes: float = 0.0  # per device: new buffers the call returns
    alias_bytes: float = 0.0  # per device: arguments the call returns
    peak_bytes: float = 0.0  # per device, arguments included
    phase_peaks: dict[str, float] = field(default_factory=dict)  # above
    phase_ends: dict[str, float] = field(default_factory=dict)  # the args
    n_ops: float = 0.0
    top_flops: dict[str, float] = field(default_factory=dict)
    top_memory: dict[str, float] = field(default_factory=dict)

    def top(self, which: str, k: int = 8) -> list[list]:
        """The ``k`` largest entries of ``top_flops`` / ``top_memory`` as
        [value, op] (ties by op)."""
        table = getattr(self, which)
        order = sorted(table.items(), key=lambda kv: (-kv[1], kv[0]))
        return [[v, d] for d, v in order[:k]]


class _Saved:
    """A tensor autograd saved, held by the graph until its backward."""

    __slots__ = ("t", "__weakref__")

    def __init__(self, t):
        self.t = t


class CostTracer(TorchDispatchMode):
    """Counts FLOPs, HBM bytes and live bytes of the ops dispatched inside
    it (see the module docstring); ``report()`` after the call."""

    def __init__(self):
        super().__init__()
        self.rep = CostReport()
        self._flops = defaultdict(float)
        self._bytes = defaultdict(float)
        self._top_f = defaultdict(float)
        self._top_m = defaultdict(float)
        self._live = 0.0  # bytes the trace allocated, alive now
        self._peaks = defaultdict(float)  # phase -> the largest _live
        self._ends = {}  # phase -> _live at its last allocation
        self._backward_seen = False
        self._held = {}  # storage id -> [holders, bytes]
        self._metas = {}  # _meta_key -> the outputs' metadata, or False
        self._bodies = {}  # an eager body's input metadata -> its counts

    def _run(self, func, args, kwargs):
        """``func`` on its arguments.  On ``meta`` tensors an op seen before
        on the same metadata gets new buffers of its outputs' metadata
        without its meta kernel running again: the kernels (Python
        references, most of them) are most of a trace's host time, and the
        ranks repeat each other's ops."""
        key = _meta_key(func, args, kwargs)
        if key is None:
            return func(*args, **kwargs)
        spec = self._metas.get(key)
        if spec:
            return _rebuild(spec)
        out = func(*args, **kwargs)
        if spec is None:
            self._metas[key] = _out_spec(out)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return func(*args, **kwargs)
        # FlopCounterMode's rule: an op with a decomposition is counted
        # through it
        if _decomposes(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        body = None if TR.in_collective() else self._body(func, args, kwargs)
        if body is not None:
            self._peaks[self._phase()] = max(self._peaks[self._phase()],
                                             self._live + body.peak_bytes)
        out = self._run(func, args, kwargs)
        self._hold(func, out)
        if TR.in_collective():
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        first = (outs or ins or [None])[0]
        dev = "none" if first is None else str(first.device)
        name = f"{func} {tuple(first.shape) if first is not None else ()}"
        if body is not None:
            self.rep.n_ops += body.n_ops
            self._flops[dev] += body.flops
            self._top_f[name] += body.flops
            self._bytes[dev] += body.hbm_bytes
            self._top_m[name] += body.hbm_bytes
            return out
        self.rep.n_ops += 1
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            # a ``.dtype`` overload's out_dtype is no shape (``bmm_flop``
            # would take it for its out_shape)
            fa = args[:2] if func._overloadname == "dtype" else args
            fl = float(fn(*fa, **kwargs, out_val=out))
            self._flops[dev] += fl
            self._top_f[name] += fl
        if _is_view(func) or func in _NO_MEM_OPS:
            return out
        nb = float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                      for t in outs))
        self._bytes[dev] += nb
        self._top_m[name] += nb
        if "flash_attention" in func.name():
            self.rep.flash_bytes += nb
        return out

    def _body(self, func, args, kwargs) -> CostReport | None:
        """The counts of ``func``'s eager body on inputs of these shapes
        (``BODIES``; traced the first time, with ``peak_bytes`` its live
        bytes above its inputs), or None for any other op."""
        fn = BODIES.get(func)
        if fn is None:
            return None
        key = (func, tuple((tuple(t.shape), t.dtype, t.device.type)
                           for t in _tensors((args, kwargs))))
        hit = self._bodies.get(key)
        if hit is None:
            sub = CostTracer()
            with torch.no_grad(), sub:
                fn(*args, **kwargs)
            hit = self._bodies[key] = sub.report()
            hit.peak_bytes = max(sub._peaks.values(), default=0.0)
        return hit

    def _hold(self, func, out) -> None:
        """Track the buffers an op allocates (and every tensor that views
        one) for the live-bytes peak."""
        fresh = _fresh(func)
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            held = self._held.get(key)
            if held is None:
                if not fresh:
                    continue  # a view of memory the trace did not allocate
                held = self._held[key] = [0, float(st.nbytes())]
                self._live += held[1]
                phase = self._phase()
                self._peaks[phase] = max(self._peaks[phase], self._live)
                self._ends[phase] = self._live
            held[0] += 1
            weakref.finalize(t, self._release, key)

    def _phase(self) -> str:
        if torch._C._current_graph_task_id() != -1:
            self._backward_seen = True
            return "backward"
        return "after" if self._backward_seen else "forward"

    def _pack(self, t):
        """Autograd saves ``t`` for the backward: the graph holds its
        buffer (a tensor object the trace saw may die first)."""
        box = _Saved(t)
        held = self._held.get(t.untyped_storage()._cdata)
        if held is not None:
            held[0] += 1
            weakref.finalize(box, self._release,
                             t.untyped_storage()._cdata)
        return box

    @staticmethod
    def _unpack(box):
        return box.t

    def _release(self, key) -> None:
        held = self._held.get(key)
        if held is None:
            return
        held[0] -= 1
        if held[0] == 0:
            self._live -= held[1]
            del self._held[key]

    def report(self) -> CostReport:
        rep = self.rep
        rep.flops_by_device = dict(self._flops)
        rep.bytes_by_device = dict(self._bytes)
        rep.flops = sum(self._flops.values())
        rep.hbm_bytes = sum(self._bytes.values())
        rep.top_flops, rep.top_memory = dict(self._top_f), dict(self._top_m)
        return rep


def _storage_bytes(tree) -> dict:
    """storage id -> bytes of every tensor in ``tree``."""
    return {t.untyped_storage()._cdata: float(t.untyped_storage().nbytes())
            for t in _tensors(tree)}


def trace(fn, *args, devices: int = 1):
    """(``fn(*args)``, its ``CostReport``): one call under a
    ``CostTracer``, with the collectives' wire bytes it moved and the
    memory per device of ``devices`` that hold the ranks' tensors alike.
    Arguments may be trees of dicts, lists and ``Shards``."""
    held = _storage_bytes(args)
    before = TR.bytes_moved()
    kinds = TR.bytes_by_kind()
    tracer = CostTracer()
    with tracer, torch.autograd.graph.saved_tensors_hooks(tracer._pack,
                                                          tracer._unpack):
        out = fn(*args)
    rep = tracer.report()
    rep.argument_bytes = sum(held.values()) / devices
    rep.phase_peaks = {k: v / devices for k, v in tracer._peaks.items()}
    rep.phase_ends = {k: v / devices for k, v in tracer._ends.items()}
    rep.peak_bytes = rep.argument_bytes + max(rep.phase_peaks.values(),
                                              default=0.0)
    rep.collective_wire_bytes = TR.bytes_moved() - before
    for kind, (nb, calls) in TR.bytes_by_kind().items():
        nb0, calls0 = kinds.get(kind, (0.0, 0))
        if calls > calls0:
            rep.by_kind_bytes[kind] = nb - nb0
            rep.by_kind_count[kind] = float(calls - calls0)
    produced = _storage_bytes(out)
    rep.output_bytes = sum(v for k, v in produced.items()
                           if k not in held) / devices
    rep.alias_bytes = sum(v for k, v in produced.items()
                          if k in held) / devices
    return out, rep


_LINEAR = ("flops", "hbm_bytes", "collective_wire_bytes", "flash_bytes",
           "argument_bytes", "output_bytes", "alias_bytes", "n_ops")
_TABLES = ("by_kind_bytes", "by_kind_count", "flops_by_device",
           "bytes_by_device", "top_flops", "top_memory", "phase_peaks",
           "phase_ends")


def extrapolate(one: CostReport, two: CostReport, n1: int, n2: int,
                n: int) -> CostReport:
    """The counts of a step of ``n`` layers from traces of ``n1`` and
    ``n2`` layers: every count (and every entry of the tables) extended
    linearly, one + (two - one) (n - n1) / (n2 - n1); the peak the
    arguments plus the largest phase's (see the module docstring)."""
    f = (n - n1) / (n2 - n1)
    rep = CostReport()
    for name in _LINEAR:
        a, b = getattr(one, name), getattr(two, name)
        setattr(rep, name, a + (b - a) * f)
    for name in _TABLES:
        a, b = getattr(one, name), getattr(two, name)
        setattr(rep, name, {k: a.get(k, 0.0) + (b.get(k, 0.0)
                                                 - a.get(k, 0.0)) * f
                            for k in set(a) | set(b)})
    rep.phase_peaks = {k: max(v, rep.phase_ends.get(k, 0.0))
                       for k, v in rep.phase_peaks.items()}
    rep.peak_bytes = rep.argument_bytes + max(rep.phase_peaks.values(),
                                              default=0.0)
    return rep


# ---------------------------------------------------------------------------
# plain formulas, as the reference's
# ---------------------------------------------------------------------------


def _collective_wire(kind: str, payload: int, n: int) -> float:
    if kind == "all-gather":
        return payload * (n - 1) / n
    if kind == "reduce-scatter":
        return float(payload) * (n - 1)
    if kind == "all-reduce":
        return 2.0 * payload * (n - 1) / n
    if kind == "all-to-all":
        return payload * (n - 1) / n
    return float(payload)  # collective-permute


def spgemm_dense_flops(
    ni: int, nk: int, nj: int, bs_r: int, bs_k: int, bs_c: int
) -> float:
    """Local-stage FLOPs of the dense masked-einsum backend: the full (ni,
    nk, nj) cube regardless of the filter."""
    return 2.0 * ni * nk * nj * bs_r * bs_k * bs_c


def spgemm_stacks_flops(
    capacity: int, bs_r: int, bs_k: int, bs_c: int
) -> float:
    """Local-stage FLOPs of the compacted backends: one batched GEMM over
    the padded product list, so they scale with the surviving products
    (padded to the capacity bucket), not the cube."""
    return 2.0 * capacity * bs_r * bs_k * bs_c
