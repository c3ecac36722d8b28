"""A configuration, a traffic mix and a metric added as new files (and
entries in ``BENCHMARK.json``) are found by name: a copy of the layout
gains them, and a run of the new cell reports the new metric, with no
existing file edited."""
from __future__ import annotations

import hashlib
import json
import shutil

from perfbench import harness
from perfbench.tests import tiny


def _digests(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(tiny.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_bench(tiny.ROOT)
    before = _digests(root)

    base = root / "perfbench"
    cfg = tiny.h2o()
    cfg["block_rows"] = 12
    (base / "configs" / "h2o-small.json").write_text(json.dumps(cfg))
    (base / "traffic" / "scf-steep.json").write_text(json.dumps(
        {"mode": "scf", "scale_step": 5e-2, "warm_sweeps": 2}))
    (base / "metrics" / "occupancy_steps.scf2.py").write_text(
        '"""Purifications the window completed."""\n\n\n'
        "def read(rec):\n    return rec.get('purifications')\n")
    bench["configs"].append({
        "name": "h2o-small", "source": "arXiv:1705.10218",
        "file": "perfbench/configs/h2o-small.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "h2o-small.steep", "config": "h2o-small",
        "traffic": "scf-steep", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("h2o-small.steep")
    bench["per_layer"].append({
        "name": "occupancy_steps.scf2", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "sign iteration",
        "moves": "purify_s", "workloads": ["h2o-small.steep"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())  # nothing edited

    line, _ = harness.run_cell(root, "h2o-small.steep", 4, 0.2, True,
                               device="cpu", base=base)
    assert line["correct"] is True
    assert line["metrics"]["occupancy_steps.scf2"]["value"] >= 1
    line, _ = harness.run_cell(root, "h2o-small.steep", 4, 0.2, False,
                               device="cpu", base=base)
    assert set(line["metrics"]) == {"purify_s", "setup_s"}
