"""The trace reduction on hand-made profiler events: the device's busy
union, kernel seconds by name, the host's own time per step (its waits
taken out) and the idle gaps by what the host was doing."""
from __future__ import annotations

import torch

from perfbench import tracing

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, start_us, end_us, device=CPU, annotation=False):
        self._n, self._s, self._e = name, start_us * 1000, end_us * 1000
        self._d, self._a = device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._a


def test_reduce_by_hand():
    events = [
        # two steps of 100 us on the host; the first waits 30 us on a copy
        Ev(tracing.STEP, 0, 100), Ev(tracing.STEP, 100, 200),
        Ev("cudaLaunchKernel", 10, 15), Ev("cudaMemcpyAsync", 40, 70),
        Ev("aten::mm", 120, 160), Ev("cudaLaunchKernel", 150, 155),
        Ev("aten::copy_", 78, 92),
        # the device: kernels overlapping once, a copy, an annotation
        Ev("group_kernel<float>", 20, 60, CUDA),
        Ev("group_kernel<float>", 50, 80, CUDA),
        Ev("Memcpy DtoH", 90, 95, CUDA),
        Ev("elementwise", 170, 180, CUDA),
        Ev(tracing.STEP, 0, 200, CUDA, annotation=True),
    ]
    r = tracing.reduce_events(events, window_s=200e-6)
    assert abs(r["busy_s"] - (60 + 5 + 10) * 1e-6) < 1e-12
    assert abs(r["kernel_s"]["group_kernel<float>"] - 70e-6) < 1e-12
    assert r["n_kernels"] == 3 and r["steps"] == 2
    assert abs(r["host_ms_per_step"] - (70 + 100) / 2 * 1e-3) < 1e-9
    # idle 80-90 starts inside aten::copy_, 95-170 inside no host op
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps.keys() == {"aten::copy_", "host_outside_any_op"}
    assert abs(gaps["aten::copy_"] - 10e-6) < 1e-12
    assert abs(gaps["host_outside_any_op"] - 75e-6) < 1e-12
    assert r["breakdown"]["device_ops"][0][0] == "group_kernel_float_"


def test_window_off_records_nothing():
    w = tracing.Window("cpu", on=False)
    w.start()
    with w.span():
        pass
    w.stop()
    assert w.reduce() is None and not w.active
