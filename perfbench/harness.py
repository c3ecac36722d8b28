"""Runs one cell once: finds its configuration, traffic mix, driver and
metrics by name, drives the window, checks the outputs and builds the
result line.

The layout is data.  ``BENCHMARK.json`` at the root names each cell's
configuration (a file it lists) and traffic mix
(``perfbench/traffic/<traffic>.json``).  A configuration's ``kind`` names
its driver (``perfbench/drivers/<kind>.py``, with ``run(ctx) -> record``),
and every metric is a reader of its own (``perfbench/metrics/<name>.py``,
with ``read(record) -> number or None``).  A later cell or metric is new
files and entries; nothing here changes.

A driver's record holds what its window measured (``window_s`` and its
own keys), the compared numbers (``checks``, each held to the
configuration's ``limits``: a number passes when it is at most its
limit), ``attempted`` and ``failed``, the traced window's reduction
(``trace``) and the work counts (``work``).
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HERE = Path(__file__).resolve().parent


def load_bench(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> tuple[dict, dict]:
    """(the workload entry, its configuration entry)."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            for c in bench["configs"]:
                if c["name"] == w["config"]:
                    return w, c
            raise KeyError(f"configuration {w['config']!r} of {workload!r}")
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_config(root: Path, entry: dict) -> dict:
    return json.loads((Path(root) / entry["file"]).read_text())


def load_traffic(base: Path, name: str) -> dict:
    return json.loads((Path(base) / "traffic" / f"{name}.json").read_text())


def load_driver(base: Path, kind: str):
    return _module(Path(base) / "drivers" / f"{kind}.py",
                   f"perfbench_driver_{kind}")


def load_reader(base: Path, metric: str):
    mod = _module(Path(base) / "metrics" / f"{metric}.py",
                  "perfbench_metric_" + metric.replace(".", "_"))
    return mod.read


def cell_metrics(bench: dict, workload: str, traced: bool) -> list[dict]:
    """The metrics the cell reports: its end-to-end ones (those naming it
    under ``workloads``, or naming no workloads), or in a traced run its
    per-layer ones (naming it, or naming none and moving one of its
    end-to-end metrics)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules (or ``names``) whose top-level name, before the
    first dot, is one of ``FORBIDDEN``, compared whole."""
    return sorted({n for n in (sys.modules if names is None else names)
                   if n.split(".", 1)[0] in FORBIDDEN})


class Context:
    """What a driver gets: the configuration and mix, the seed, the
    window's length, the traced window and the device; ``open`` and
    ``closed`` mark the window for set-up time and peak memory."""

    def __init__(self, cfg, traffic, seed, seconds, window, device, t_start):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.seconds = seed, seconds
        self.window, self.device = window, device
        self.t_start = t_start
        self.setup_s = None
        self.memory_peak_bytes = 0
        self.control = False
        self.marks: list[tuple[str, float]] = []

    def mark(self, what: str) -> None:
        """Note the seconds since the process started at a phase's end."""
        self.marks.append((what, time.perf_counter() - self.t_start))

    def open(self, now: float) -> None:
        self.setup_s = now - self.t_start
        self.marks.append(("set-up", self.setup_s))

    def closed(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))
        self.mark("window")


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, *, device="cuda", t_start: float | None = None,
             cfg: dict | None = None, traffic: dict | None = None,
             base: Path = HERE, control: bool = False
             ) -> tuple[dict, list[str]]:
    """(result line, check lines) of one run of ``workload``.  ``cfg`` and
    ``traffic`` replace the files' contents (the tests' small sizes);
    ``control`` adds the control's readings under ``"control"``
    (``perfbench/control.py``; the benchmark's runs never compute it)."""
    import torch

    from perfbench import tracing as TRC

    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_bench(root)
    w, centry = cell(bench, workload)
    cfg = load_config(root, centry) if cfg is None else cfg
    traffic = load_traffic(base, w["traffic"]) if traffic is None else traffic
    dev = torch.device(device)
    win = TRC.Window(dev, traced)
    ctx = Context(cfg, traffic, seed, seconds, win, dev, t_start)
    ctx.control = control
    rec = load_driver(base, cfg["kind"]).run(ctx)
    ctx.mark("checked")
    rec["setup_s"] = ctx.setup_s
    rec["trace"] = win.reduce()
    ctx.mark("trace read")

    metrics = {}
    for m in cell_metrics(bench, workload, traced):
        value = load_reader(base, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    limits = cfg["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in rec["checks"].items()}
    correct = (rec["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else dev.type),
        "count": w["chips"],
        "memory_peak_bytes": ctx.memory_peak_bytes,
    }
    line = {"correct": bool(correct), "attempted": int(rec["attempted"]),
            "failed": int(rec["failed"]), "metrics": metrics,
            "device": device_info}
    if rec["trace"] is not None:
        device_info["busy_s"] = rec["trace"]["busy_s"]
        device_info["window_s"] = rec["trace"]["window_s"]
        line["breakdown"] = rec["trace"]["breakdown"]
    if control:
        line["control"] = rec["control"]
    line["checks"] = checks
    lines = ["phases (s since start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in ctx.marks)]
    if rec.get("note"):
        lines.append(rec["note"])
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
              for k, c in checks.items()]
    lines.append(f"check failed: {rec['failed']} of {rec['attempted']} "
                 "(limit 0)")
    return line, lines
