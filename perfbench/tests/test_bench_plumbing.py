"""The harness's plumbing on the CPU: inputs reproducible from the seed,
the result line's keys, and no result without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import gen, generator, harness
from perfbench.tests import tiny


@pytest.mark.parametrize("mix", ["chat-decode", "chat-prefill"])
def test_traffic_reproducible_from_the_seed(mix):
    t = harness.load_traffic(harness.HERE, mix)
    big = 2 ** 31 + 12345
    if t["mode"] == "decode":
        def draw(seed):
            return generator.session_prompts(t, seed, 102400)
    else:
        def draw(seed):
            return generator.round_prompts(t, seed, 102400, 3)
    a, b, c = draw(big), draw(big), draw(big + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    # every seed gets the same sizes
    if t["mode"] == "decode":
        want = [t["prompt_len"]] * len(a)
    else:
        want = [generator.round_length(t, big, 3)] * len(a)
        cycle = sorted(generator.round_length(t, seed, r)
                       for seed in (big, big + 1) for r in range(4, 8))
        assert cycle == sorted(generator.lengths(t["prompt_tokens"], 4) * 2)
    assert [len(x) for x in a] == want
    assert all(0 <= int(x.min()) and int(x.max()) < 102400 for x in a)


def test_lengths_are_quantile_midpoints():
    dist = {"mean": 161.31, "log_sd": 1.0}
    assert generator.lengths(dist, 4) == [31, 71, 135, 309]
    many = generator.lengths(dist, 4000)
    assert abs(sum(many) / len(many) - 161.31) < 2.0  # the mean holds


def test_rounds_do_not_depend_on_earlier_rounds():
    t = harness.load_traffic(harness.HERE, "chat-prefill")
    r5 = generator.round_prompts(t, 7, 1000, 5)
    assert all(np.array_equal(x, y) for x, y in
               zip(r5, generator.round_prompts(t, 7, 1000, 5)))
    warm = generator.round_prompts(t, 7, 1000, 5, warm=True)
    assert not any(np.array_equal(x, y) for x, y in zip(r5, warm))


def test_check_sample_from_the_seed():
    assert generator.check_sample(5, 64, 8) == generator.check_sample(5, 64, 8)
    assert generator.check_sample(5, 10, 32) == list(range(10))
    assert len(set(generator.check_sample(2 ** 33, 64, 8))) == 8


def test_hamiltonian_same_spectrum_every_seed():
    ref = None
    for seed in (0, 9, 2 ** 31 + 1):
        b, m = gen.hamiltonian(seed, 10, 4, 0.3, "cpu")
        b2, m2 = gen.hamiltonian(seed, 10, 4, 0.3, "cpu")
        assert torch.equal(b, b2) and torch.equal(m, m2)
        h = b.permute(0, 2, 1, 3).reshape(40, 40).double()
        assert torch.allclose(h, h.T)
        eig = torch.linalg.eigvalsh(h)
        if ref is None:
            ref, ref_b = eig, b
        else:
            assert torch.allclose(eig, ref, atol=1e-5)
            assert not torch.allclose(b, ref_b)


def test_weights_reproducible_from_the_seed():
    cfg = tiny.moe()
    a = gen.lm_params(cfg, 2 ** 31 + 3, "cpu")
    b = gen.lm_params(cfg, 2 ** 31 + 3, "cpu")
    c = gen.lm_params(cfg, 4, "cpu")
    wa, wb, wc = (p["blocks"][1]["moe"]["w_in"] for p in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert wa.dtype == torch.bfloat16
    assert a["blocks"][0]["moe"]["router"].dtype == torch.float32
    assert len(a["blocks"]) == cfg["num_hidden_layers"]


@pytest.mark.parametrize("workload,traced", [
    ("h2o-dft-ls.scf", False), ("h2o-dft-ls.scf", True),
    ("deepseek-moe-16b.decode", False), ("deepseek-moe-16b.decode", True),
    ("deepseek-moe-16b.prefill", False), ("deepseek-moe-16b.prefill", True),
])
def test_result_line_keys(workload, traced):
    line, checks = tiny.run(workload, traced=traced, seconds=0.6)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if traced:
        keys.append("breakdown")
    assert list(line) == keys + ["checks"]  # the compared numbers last
    assert line["correct"] is True and line["failed"] == 0
    bench = harness.load_bench(tiny.ROOT)
    want = {m["name"] for m in harness.cell_metrics(bench, workload, traced)}
    assert set(line["metrics"]) <= want
    if not traced:
        assert set(line["metrics"]) == want  # every end-to-end metric
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert checks[-1].startswith("check failed: 0 of ")
    json.dumps(line)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure")


@pytest.mark.parametrize("workload", ["h2o-dft-ls.scf",
                                      "deepseek-moe-16b.decode"])
def test_no_card_no_result(no_card, workload):
    env = dict(os.environ, BENCH_RUN="1")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tiny.ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_needs_the_program(tmp_path):
    """A checkout with only BENCHMARK.json and the benchmark's folder has
    no program to run: no result."""
    import shutil

    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "h2o-dft-ls.scf",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_cell_metrics_follow_workloads():
    bench = harness.load_bench(tiny.ROOT)
    e2e = [m["name"] for m in harness.cell_metrics(
        bench, "deepseek-moe-16b.decode", False)]
    assert e2e == ["tokens_per_s", "itl_p90_ms", "setup_s"]
    layer = [m["name"] for m in harness.cell_metrics(
        bench, "h2o-dft-ls.scf", True)]
    assert "block_spgemm_roofline.scf" in layer
    assert not any(n.endswith(".decode") for n in layer)
