"""The program's spans in the traced window (``perfbench/spans.py``), on
hand-made profiler events with correlation ids: kernels put down to the
span that launched them, idle gaps to the span the host was in, the
readers of the four span metrics; then through the harness on the CPU,
with and without the program's spans."""
from __future__ import annotations

import types

import pytest
import torch

from perfbench import spans, tracing
from perfbench.tests import tiny

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    """A profiler event: host events carry their thread and correlation
    id, kernels the id of the host op that launched them (``linked``) and
    the runtime call's (``corr``)."""

    def __init__(self, name, start_us, end_us, device=CPU, annotation=False,
                 corr=0, linked=0, thread=1):
        self._n, self._s, self._e = name, start_us * 1000, end_us * 1000
        self._d, self._a = device, annotation
        self._c, self._l, self._t = corr, linked, thread

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

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def start_thread_id(self):
        return self._t


def _span(name, s, e, corr=0):
    return Ev(name, s, e, annotation=True, corr=corr)


def test_kernel_goes_to_the_span_that_launched_it():
    events = [
        _span("repro.outer", 0, 100, corr=1),
        _span("repro.inner", 10, 30, corr=2),
        Ev("aten::mm", 12, 14, corr=3),
        Ev("cudaLaunchKernel", 13, 14, corr=900),
        _span("repro.other", 40, 90, corr=4),
        # launched in repro.inner, run while repro.other is open
        Ev("gemm", 50, 60, CUDA, corr=900, linked=3),
        # launched by a runtime call only (no host op linked)
        Ev("cudaLaunchKernel", 45, 46, corr=901),
        Ev("fill", 61, 62, CUDA, corr=901),
        # launched directly in repro.outer's own range
        Ev("cudaLaunchKernel", 35, 36, corr=902),
        Ev("spgemm", 63, 70, CUDA, corr=902, linked=1),
    ]
    r = spans.reduce_spans(events)
    t = r["spans"]
    assert t["repro.inner"]["kernels"] == 1
    assert abs(t["repro.inner"]["device_s"] - 10e-6) < 1e-12
    assert t["repro.other"]["kernels"] == 1  # fill, by its runtime call
    assert t["repro.outer"]["kernels"] == 1  # spgemm, innermost is outer
    assert r["outside_spans"]["kernels"] == 0 and r["under_spans"] == 1.0
    assert [t[n]["calls"] for n in sorted(t)] == [1, 1, 1]
    assert abs(t["repro.outer"]["s"] - 100e-6) < 1e-12


def test_kernels_outside_every_span():
    events = [
        _span("repro.a", 0, 10, corr=1),
        Ev("aten::add", 2, 3, corr=2),
        Ev("aten::zeros", 20, 22, corr=3),
        Ev("k1", 30, 40, CUDA, linked=2),
        Ev("k2", 40, 70, CUDA, linked=3),
        Ev("k3", 70, 80, CUDA),  # no launch found
    ]
    r = spans.reduce_spans(events)
    assert r["spans"]["repro.a"]["kernels"] == 1
    assert r["outside_spans"]["kernels"] == 2
    assert abs(r["outside_spans"]["device_s"] - 40e-6) < 1e-12
    assert abs(r["under_spans"] - 0.2) < 1e-12


def test_device_annotations_are_not_work():
    base = [Ev(tracing.STEP, 0, 100),
            _span("repro.a", 5, 90, corr=1),
            Ev("aten::mm", 10, 12, corr=2),
            Ev("mm", 20, 40, CUDA, linked=2)]
    notes = [Ev("repro.a", 20, 60, CUDA, annotation=True),
             Ev(tracing.STEP, 0, 100, CUDA, annotation=True)]
    r0 = tracing.reduce_events(base, window_s=100e-6)
    r1 = tracing.reduce_events(base + notes, window_s=100e-6)
    for key in ("busy_s", "kernel_s", "n_kernels", "steps",
                "host_ms_per_step"):
        assert r0[key] == r1[key], key
    assert r1["n_kernels"] == 1 and abs(r1["busy_s"] - 20e-6) < 1e-12
    s = spans.reduce_spans(base + notes)
    assert s["spans"]["repro.a"]["kernels"] == 1
    assert abs(s["spans"]["repro.a"]["device_s"] - 20e-6) < 1e-12


def test_idle_gap_goes_to_a_span_opened_long_before():
    events = [_span("repro.serve.decode", 0, 10_000, corr=1)]
    # 300 short host ops inside the span, then a gap with no op running
    events += [Ev("aten::add", 10 + 10 * i, 15 + 10 * i, corr=10 + i)
               for i in range(300)]
    events += [Ev("k1", 100, 3_100, CUDA, linked=10),
               Ev("k2", 9_000, 9_500, CUDA, linked=309)]
    r = spans.reduce_spans(events)
    assert r["idle_by_span"] == [["repro.serve.decode",
                                  pytest.approx(5_900e-6)]]
    # the breakdown's look-back of 200 host events does not reach it
    gaps = tracing.reduce_events(events, 10e-3)["breakdown"]["idle_gaps"]
    assert gaps == [["host_outside_any_op", pytest.approx(5_900e-6)]]


def test_idle_outside_spans_and_host_self_time():
    events = [
        _span("repro.outer", 0, 100, corr=1),
        _span("repro.child", 20, 50, corr=2),
        Ev("cudaStreamSynchronize", 60, 80,
           corr=500),
        Ev("cudaMemcpyAsync", 30, 40, corr=501),
        Ev("aten::mm", 5, 6, corr=3),
        Ev("k1", 10, 20, CUDA, linked=3),
        Ev("k2", 150, 160, CUDA),
        Ev("k3", 170, 180, CUDA),
    ]
    r = spans.reduce_spans(events)
    t = r["spans"]
    # outer: 100 wall - 30 child - 20 sync; child: 30 - 10 copy
    assert abs(t["repro.outer"]["self_s"] - 50e-6) < 1e-12
    assert abs(t["repro.child"]["self_s"] - 20e-6) < 1e-12
    # the gap 20-150 starts in repro.child, 160-170 in no span
    assert dict(r["idle_by_span"]) == {
        "repro.child": pytest.approx(130e-6),
        "outside_spans": pytest.approx(10e-6)}
    assert dict(r["idle_under_span"]) == {
        "repro.outer": pytest.approx(130e-6),
        "repro.child": pytest.approx(130e-6),
        "outside_spans": pytest.approx(10e-6)}


def _rec(table, *, busy=1.0, window=2.0, steps=4):
    trace = {"busy_s": busy, "window_s": window, "steps": steps,
             "spans": {n: dict(calls=c, s=s, self_s=0.0, device_s=d,
                               kernels=1) for n, (c, s, d) in table.items()},
             "outside_spans": {"device_s": 0.0, "kernels": 0},
             "under_spans": 1.0, "idle_by_span": [], "idle_under_span": []}
    return {"trace": trace}


@pytest.mark.parametrize("metric,table,want", [
    ("list_build_ms_per_multiply.scf",
     {"repro.local_mm.list_build": (640, 0.1, 0.64),
      "repro.local_mm.multiply": (320, 40.0, 0.32)}, 2.0),
    ("decode_ms_per_round.prefill",
     {"repro.serve.decode": (4, 1.6, 1.2)}, 400.0),
    ("moe_dispatch_ms_per_step.decode",
     {"repro.moe.route": (112, 0.1, 0.02), "repro.moe.dispatch": (112, 1, .06),
      "repro.moe.combine": (112, 0.1, 0.04), "repro.moe.experts": (1, 1, 3)},
     30.0),
    ("attention_ms_per_step.decode",
     {"repro.attention": (112, 0.1, 0.036)}, 9.0),
])
def test_span_metric_readers(metric, table, want):
    from perfbench import harness

    read = harness.load_reader(harness.HERE, metric)
    assert read({"trace": None}) is None
    assert read({}) is None
    assert read(_rec({})) is None  # a program without spans
    assert read(_rec(table)) == pytest.approx(want)


@pytest.mark.parametrize("workload,metric", [
    ("h2o-dft-ls.scf", None),
    ("deepseek-moe-16b.prefill", "decode_ms_per_round.prefill"),
])
def test_spans_through_the_harness(workload, metric):
    """A traced run on the CPU: the span table is one more note line, and
    a metric of host time reads; the device metrics stay silent."""
    line, lines = tiny.run(workload, traced=True, seconds=0.4)
    assert line["correct"] is True
    note = [x for x in "\n".join(lines).splitlines()
            if x.startswith("spans (calls")]
    assert len(note) == 1 and "repro." in note[0]
    new = {"list_build_ms_per_multiply.scf", "decode_ms_per_round.prefill",
           "moe_dispatch_ms_per_step.decode", "attention_ms_per_step.decode"}
    assert set(line["metrics"]) & new == ({metric} if metric else set())
    if metric:
        assert line["metrics"][metric]["value"] > 0


def test_a_program_without_spans(monkeypatch):
    """The parent of the spans: a traced run reads no span metric and
    does not raise."""
    from repro_torch import obs

    off = types.SimpleNamespace(autograd=types.SimpleNamespace(
        _profiler_enabled=lambda: False))
    monkeypatch.setattr(obs, "torch", off)
    line, lines = tiny.run("deepseek-moe-16b.prefill", traced=True,
                           seconds=0.3)
    assert line["correct"] is True
    assert "decode_ms_per_round.prefill" not in line["metrics"]
    assert any(x.startswith("spans: none in the trace (")
               for x in "\n".join(lines).splitlines())
