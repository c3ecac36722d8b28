"""Small sizes of the benchmark's configurations and mixes, for runs of
the whole harness on the CPU (the program's plain paths)."""
from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def config(name: str) -> dict:
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())


def h2o() -> dict:
    c = config("h2o-dft-ls")
    c.update(block_rows=16, block_size=8, occupancy=0.3, backend="stacks")
    # the configuration's limits hold here too: the program reads about
    # 2e-7 at this size, the TF32 control 4e-4
    return c


def moe() -> dict:
    c = config("deepseek-moe-16b")
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             moe_intermediate_size=32, intermediate_size=64,
             n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
             num_hidden_layers=2, vocab_size=256)
    # from the CPU readings at this size (8 to 13 seeds; a decode window
    # of 0.4 s holds fewer steps on a loaded CPU, and its numbers swing
    # more): the program's mean gap under 0.017, its largest session mean
    # under 0.07, its 75th percentile and slot medians 0 and its median
    # |error| under 0.0093; the float8 control's mean gap over 0.05 and
    # median |error| over 0.11
    c["limits"] = {"logit_gap_mean": 0.03, "logit_gap_p75": 0.02,
                   "logit_err_median": 0.06, "gap_session_max": 0.12,
                   "gap_slot_max": 0.02}
    return c


DECODE = {"mode": "decode", "sessions": 4, "prompt_len": 8, "max_len": 512,
          "warm_steps": 2, "trace_steps": 3, "check_requests": 4,
          "checks": ["logit_gap_mean", "gap_session_max"]}
ROUNDS = {"mode": "rounds", "requests_per_round": 2,
          "prompt_tokens": {"mean": 12, "log_sd": 0.6}, "classes": 2,
          "new_tokens": 1, "warm_cycles": 1, "trace_rounds": 2,
          "check_requests": 64,
          "checks": ["logit_gap_p75", "logit_err_median", "gap_slot_max"]}
SCF = {"mode": "scf", "scale_step": 1e-3, "warm_sweeps": 4}


def run(workload: str, *, seed: int = 3, seconds: float = 0.3,
        traced: bool = False):
    """(result line, check lines) of one CPU run of ``workload`` at the
    small size."""
    from perfbench import harness

    cfg, traffic = {
        "h2o-dft-ls.scf": (h2o, SCF),
        "deepseek-moe-16b.decode": (moe, DECODE),
        "deepseek-moe-16b.prefill": (moe, ROUNDS),
    }[workload]
    return harness.run_cell(ROOT, workload, seed, seconds, traced,
                            device="cpu", cfg=cfg(), traffic=dict(traffic))
