"""The program's own spans in the traced window: each device operation put
down to the innermost ``repro.*`` span that launched it, and each idle gap
of the device to the innermost span the host was in at its start.

The program opens its spans (``repro_torch.obs.span``) only while a
profiler runs, as ``torch.profiler.record_function`` ranges, so they sit on
the profiler's clock beside the device's kernels.  A kernel's launch is
found through the profiler's correlation ids: its ``linked_correlation_id``
is the ``correlation_id`` of the host op that was innermost at the launch
(a span itself, where the launch has no op of its own), and its own
``correlation_id`` is the CUDA runtime call's that launched it (both so on
the H100 under torch 2.11).  The innermost span holding that host event on
its thread is the kernel's.

``reduce_spans(events)`` gives, from the window's raw events:

* ``spans``: per span name, ``calls``, wall ``s``, host ``self_s`` (the
  wall less child spans and less the CUDA calls that wait for the device,
  as ``tracing`` matches them), device ``device_s`` and ``kernels`` of the
  operations put down to it (innermost only: a parent does not count its
  children's);
* ``outside_spans``: the device operations that no span launched;
* ``under_spans``: the share of device time put down to some span;
* ``idle_by_span``: the device's idle gaps (between busy intervals, as
  ``tracing``'s breakdown takes them) summed by the innermost span,
  ``outside_spans`` where the host was in none; ``idle_under_span`` the
  same gaps summed by every span open at their start (a decode step's
  gaps fall inside its model call's layers, and count for the step too).

A program that opens no span gives empty ``spans`` and every device
operation ``outside_spans``; the readers then return None.

The harness keeps the window out of the record it hands the metric
readers, so ``of(rec)`` finds the window in the harness's frame while
those readers run, reduces its events once, keeps the result in the
record's ``trace`` under the keys above and adds one note line: the span
table and the share of device time under a span.
"""
from __future__ import annotations

import bisect
import sys

import torch

from perfbench import tracing
from perfbench.readers import _device_seen

PREFIX = "repro."
OUTSIDE = "outside_spans"
_CUDA = torch.autograd.DeviceType.CUDA


class _Segments:
    """One thread's timeline cut where a span opens or closes, each piece
    labelled with the innermost span open over it (None for none), and
    each span's parent."""

    def __init__(self, spans: list[tuple[int, int, int]]):
        # spans: (start, end, index), properly nested on the thread
        self.starts: list[int] = []
        self.label: list[int | None] = []
        self.parent: dict[int, int | None] = {}
        stack: list[tuple[int, int]] = []  # (end, index)

        def emit(at, who):
            if self.starts and self.starts[-1] == at:
                self.label[-1] = who
            else:
                self.starts.append(at)
                self.label.append(who)

        for s, e, i in sorted(spans, key=lambda x: (x[0], -x[1])):
            while stack and stack[-1][0] <= s:
                t, _ = stack.pop()
                emit(t, stack[-1][1] if stack else None)
            self.parent[i] = stack[-1][1] if stack else None
            stack.append((e, i))
            emit(s, i)
        while stack:
            t, _ = stack.pop()
            emit(t, stack[-1][1] if stack else None)

    def at(self, t: int) -> int | None:
        """The innermost span open at ``t``."""
        j = bisect.bisect_right(self.starts, t) - 1
        return self.label[j] if j >= 0 else None

    def pieces(self, s: int, e: int):
        """(start, end, label) of the pieces covering [s, e)."""
        j = max(bisect.bisect_right(self.starts, s) - 1, 0)
        while j < len(self.starts) and self.starts[j] < e:
            lo = max(s, self.starts[j])
            hi = e if j + 1 == len(self.starts) else min(e,
                                                         self.starts[j + 1])
            if hi > lo:
                yield lo, hi, self.label[j]
            j += 1


def reduce_spans(events) -> dict:
    """The span keys of the traced window from the profiler's raw
    events."""
    spans: list[tuple[int, int, int, str]] = []  # (start, end, thread, name)
    ops: dict[int, tuple[int, int]] = {}  # host op correlation -> (t, thread)
    launches: dict[int, tuple[int, int]] = {}  # runtime call correlation
    waits: list[tuple[int, int, int]] = []
    dev: list[tuple[int, int, str, int, int]] = []
    for ev in events:
        name = ev.name()
        s = int(ev.start_ns())
        e = s + int(ev.duration_ns())
        if ev.device_type() == _CUDA:
            if ev.is_user_annotation() or name.startswith("bench."):
                continue
            dev.append((s, e, name, int(ev.linked_correlation_id()),
                        int(ev.correlation_id())))
            continue
        th = int(ev.start_thread_id())
        if name.startswith(PREFIX):
            spans.append((s, e, th, name))
        if name.startswith("cu"):  # a CUDA runtime or driver call
            launches[int(ev.correlation_id())] = (s, th)
            if tracing._WAITS.match(name):
                waits.append((s, e, th))
        else:
            # the profiler's own events inside an op (module loading) carry
            # the op's id; the op starts first
            corr = int(ev.correlation_id())
            if corr not in ops or s < ops[corr][0]:
                ops[corr] = (s, th)

    by_thread: dict[int, list[tuple[int, int, int]]] = {}
    for i, (s, e, th, _) in enumerate(spans):
        by_thread.setdefault(th, []).append((s, e, i))
    segs = {th: _Segments(v) for th, v in by_thread.items()}
    names = sorted({n for *_, n in spans})
    table = {n: {"calls": 0, "s": 0.0, "self_s": 0.0, "device_s": 0.0,
                 "kernels": 0} for n in names}
    for s, e, _, n in spans:
        table[n]["calls"] += 1
        table[n]["s"] += (e - s) * 1e-9
    for th, sg in segs.items():
        for lo, hi, who in sg.pieces(sg.starts[0], sg.starts[-1]):
            if who is not None:
                table[spans[who][3]]["self_s"] += (hi - lo) * 1e-9
    for s, e, th in waits:
        sg = segs.get(th)
        for lo, hi, who in (sg.pieces(s, e) if sg else ()):
            if who is not None:
                table[spans[who][3]]["self_s"] -= (hi - lo) * 1e-9

    outside = {"device_s": 0.0, "kernels": 0}
    total = 0.0
    for s, e, name, linked, corr in dev:
        host = ops.get(linked) if linked else None
        if host is None:
            host = launches.get(corr)
        who = None
        if host is not None and host[1] in segs:
            who = segs[host[1]].at(host[0])
        row = outside if who is None else table[spans[who][3]]
        row["device_s"] += (e - s) * 1e-9
        total += (e - s) * 1e-9
        if not name.startswith(("Memcpy", "Memset")):
            row["kernels"] += 1

    main = max(segs, key=lambda th: len(by_thread[th]), default=None)
    busy = tracing._union([(s, e) for s, e, *_ in dev])
    idle: dict[str, float] = {}
    under: dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        who = segs[main].at(e0) if main is not None else None
        key = OUTSIDE if who is None else spans[who][3]
        idle[key] = idle.get(key, 0.0) + (s1 - e0) * 1e-9
        held = {OUTSIDE} if who is None else set()
        while who is not None:
            held.add(spans[who][3])
            who = segs[main].parent[who]
        for key in held:
            under[key] = under.get(key, 0.0) + (s1 - e0) * 1e-9
    return {
        "spans": table,
        "outside_spans": outside,
        "under_spans": (1.0 - outside["device_s"] / total) if total else None,
        "idle_by_span": sorted(([k, v] for k, v in idle.items()),
                               key=lambda kv: -kv[1]),
        "idle_under_span": sorted(([k, v] for k, v in under.items()),
                                  key=lambda kv: -kv[1]),
    }


def _window():
    """The traced window whose record the harness is reading: a
    ``tracing.Window`` that profiled, held by a caller's frame."""
    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, tracing.Window) and v.prof is not None:
                return v
        f = f.f_back
    return None


def note(tr: dict) -> str:
    """One line: the span table and the share of device time under a
    span."""
    rows = sorted(tr["spans"].items(), key=lambda kv: -kv[1]["device_s"])
    if not rows:
        return f"spans: none in the trace ({tr['n_kernels']} kernels)"
    cells = "; ".join(
        f"{n} {r['calls']}, {1e3 * r['self_s']:.3f}, "
        f"{1e3 * r['device_s']:.3f}, {r['kernels']}" for n, r in rows)
    out = tr["outside_spans"]
    share = tr["under_spans"]
    idle = ", ".join(f"{k} {1e3 * v:.3f}" for k, v in tr["idle_by_span"])
    under = ", ".join(f"{k} {1e3 * v:.3f}" for k, v in tr["idle_under_span"])
    return (f"spans (calls, host self ms, device ms, kernels): {cells}; "
            f"{OUTSIDE} {1e3 * out['device_s']:.3f} ms, {out['kernels']} "
            f"kernels, of {tr['n_kernels']}; under a span: "
            + ("none" if share is None else f"{100 * share:.2f} %")
            + f" of device time; idle by span (ms): {idle}; idle under "
            f"span (ms): {under}")


def of(rec: dict) -> dict | None:
    """The record's ``trace`` with the span keys (None without a trace):
    read from the window once, then kept there."""
    tr = rec.get("trace")
    if tr is None:
        return None
    if "spans" not in tr:
        win = _window()
        if win is None:
            return None
        tr.update(reduce_spans(win.prof.profiler.kineto_results.events()))
        rec["note"] = "\n".join(x for x in (rec.get("note"), note(tr)) if x)
    return tr


def device_s(rec: dict, names: tuple[str, ...]) -> float | None:
    """Device seconds of the operations put down to the spans ``names``
    (None where the trace has none of them)."""
    tr = of(rec)
    if (tr is None or not _device_seen(rec)
            or not any(n in tr["spans"] for n in names)):
        return None
    return sum(tr["spans"][n]["device_s"] for n in names
               if n in tr["spans"])


def span_row(rec: dict, name: str) -> dict | None:
    """The span table's row of ``name`` (None where it never opened)."""
    tr = of(rec)
    return None if tr is None else tr["spans"].get(name)
