"""The traced window: ``torch.profiler`` over the device and the host, and
its reduction to what the per-layer metrics read.

Spans are the benchmark's own: ``STEP`` marks each step the window drives
(a ``record_function`` range around the call into the program).  From the
profiler's raw events this module takes

* ``busy_s``: the union of the device's kernels, copies and sets over the
  traced window (``window_s``, host clock, synchronised at both ends);
* ``kernel_s``: device seconds by kernel name, ``n_kernels``;
* ``steps`` and ``host_ms_per_step``: per ``STEP`` span, the host's own
  time in it: the span less the CUDA calls inside it that wait for the
  device (a synchronise, a copy: a copy from pageable host memory first
  waits for the stream), averaged over the spans;
* the breakdown: the device operations that took most time, and the idle
  gaps of the device summed by what the host was doing at their start.
"""
from __future__ import annotations

import bisect
import contextlib
import re
import time

import torch

STEP = "bench.step"
_WAITS = re.compile(r"^cu(da)?(Memcpy|StreamSynchronize|DeviceSynchronize|"
                    r"EventSynchronize|CtxSynchronize)")
_NAME = re.compile(r"[^A-Za-z0-9_.:-]+")


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """A profiler over part of a run: ``start()`` and ``stop()``
    synchronise the device; ``span()`` marks one step."""

    def __init__(self, device, on: bool):
        self.device = device
        self.on = on
        self.prof = None
        self.window_s = None
        self._t0 = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.window_s is None

    def start(self) -> None:
        if not self.on or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        _sync(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if not self.active:
            return
        _sync(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def span(self):
        from torch.profiler import record_function

        if self.active:
            return record_function(STEP)
        return contextlib.nullcontext()

    def reduce(self) -> dict | None:
        if self.prof is None:
            return None
        self.stop()
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             self.window_s)


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _clean(name: str) -> str:
    return _NAME.sub("_", name)[:64]


def reduce_events(events, window_s: float) -> dict:
    """The traced window's numbers from the profiler's raw events."""
    dev, cpu, steps, waits = [], [], [], []
    for ev in events:
        name = ev.name()
        s = _ns(ev, "start")
        e = s + int(ev.duration_ns()) if hasattr(ev, "duration_ns") else \
            _ns(ev, "end")
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if ev.is_user_annotation() or name.startswith("bench."):
                continue
            dev.append((s, e, name))
        elif name == STEP:
            steps.append((s, e))
        else:
            cpu.append((s, e, name))
            if _WAITS.match(name):
                waits.append((s, e))
    kernel_s: dict[str, float] = {}
    n_kernels = 0
    for s, e, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) * 1e-9
        if not name.startswith(("Memcpy", "Memset")):
            n_kernels += 1
    busy = _union([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    waits.sort()
    starts = [w[0] for w in waits]
    host_ms = []
    for s, e in sorted(steps):
        i = bisect.bisect_left(starts, s)
        blocked = 0
        while i < len(waits) and waits[i][0] < e:
            blocked += min(waits[i][1], e) - waits[i][0]
            i += 1
        host_ms.append((e - s - blocked) * 1e-6)
    gaps = _gaps_by_host(busy, cpu)
    ops = sorted(((k, v) for k, v in kernel_s.items()),
                 key=lambda kv: -kv[1])[:10]
    return {
        "window_s": window_s,
        "busy_s": busy_s,
        "kernel_s": kernel_s,
        "n_kernels": n_kernels,
        "steps": len(steps),
        "host_ms_per_step": (sum(host_ms) / len(host_ms)) if host_ms
        else None,
        "breakdown": {"device_ops": [[_clean(k), v] for k, v in ops],
                      "idle_gaps": gaps},
    }


def _gaps_by_host(busy, cpu) -> list:
    """The device's idle gaps between busy intervals, summed by the
    innermost host event running at each gap's start (``host_outside_any_
    op`` where none is)."""
    cpu = sorted(cpu)
    starts = [c[0] for c in cpu]
    by: dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        t = e0
        name = "host_outside_any_op"
        i = bisect.bisect_right(starts, t) - 1
        best = None
        for j in range(i, max(i - 200, -1), -1):
            if cpu[j][1] >= t:
                best = cpu[j]
                break
        if best is not None:
            name = best[2]
        by[name] = by.get(name, 0.0) + (s1 - e0) * 1e-9
    top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    return [[_clean(k), v] for k, v in top]
