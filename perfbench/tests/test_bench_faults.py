"""The whole run, without the look for a card, with the timed path broken
underneath: ``correct`` has to come out false for each fault a cell can
have — a step that leaves its state unchanged, half of the batch left
out, an answer altered where it is produced.  (No cell runs across chips,
so none can leave an exchange out.)  The sound run passes the same
limits."""
from __future__ import annotations

import pytest
import torch

from perfbench.tests import tiny

SERVING = ["deepseek-moe-16b.decode", "deepseek-moe-16b.prefill"]


def _sound(workload):
    line, _ = tiny.run(workload, seconds=0.5)
    assert line["correct"] is True, line["checks"]


def _broken(workload):
    line, _ = tiny.run(workload, seconds=0.5)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", SERVING + ["h2o-dft-ls.scf"])
def test_sound_run_is_correct(workload):
    _sound(workload)


def test_decode_cache_left_unwritten(monkeypatch):
    from repro_torch.models import transformer as T

    monkeypatch.setattr(T, "_update_kv", lambda *a, **k: None)
    _broken("deepseek-moe-16b.decode")


@pytest.mark.parametrize("workload", SERVING)
def test_expert_layer_returns_its_input(monkeypatch, workload):
    from repro_torch.models import moe as MoE

    orig = MoE.apply_moe

    def unchanged(cfg, p, x, **kw):
        y, aux = orig(cfg, p, x, **kw)[:2]
        return torch.zeros_like(y), aux

    monkeypatch.setattr(MoE, "apply_moe", unchanged)
    _broken(workload)


@pytest.mark.parametrize("workload", SERVING)
def test_half_the_batch_left_out(monkeypatch, workload):
    from repro_torch.models import moe as MoE

    orig = MoE.apply_moe

    def half(cfg, p, x, **kw):
        y, aux = orig(cfg, p, x, **kw)[:2]
        y = y.clone()
        y[y.shape[0] // 2:] = 0
        return y, aux

    monkeypatch.setattr(MoE, "apply_moe", half)
    _broken(workload)


@pytest.mark.parametrize("workload", SERVING)
def test_token_altered_where_sampled(monkeypatch, workload):
    from repro_torch.serving.engine import ServingEngine

    orig = ServingEngine._sample

    def off_by_one(self, logits):
        return (orig(self, logits) + 1) % logits.shape[-1]

    monkeypatch.setattr(ServingEngine, "_sample", off_by_one)
    _broken(workload)


@pytest.mark.parametrize("workload", SERVING)
def test_token_altered_in_one_slot(monkeypatch, workload):
    """A fault in one of the engine's slots alone (its sampled token moved
    on by one) shows in the per-slot or per-session number."""
    from repro_torch.serving.engine import ServingEngine

    orig = ServingEngine._sample

    def slot_one_off(self, logits):
        out = orig(self, logits).clone()
        out[1] = (out[1] + 1) % logits.shape[-1]
        return out

    monkeypatch.setattr(ServingEngine, "_sample", slot_one_off)
    line, _ = tiny.run(workload, seconds=0.5)
    assert line["correct"] is False, line["checks"]
    slot = "gap_session_max" if workload.endswith("decode") else \
        "gap_slot_max"
    c = line["checks"][slot]
    assert c["value"] > c["limit"], line["checks"]


def test_sweep_returns_its_state_unchanged(monkeypatch):
    from repro_torch.core import signiter

    def get_sweep_program(x, *a, **k):
        def sweep(xb, xm, xn, ib, im):
            zero = torch.zeros((), device=xb[0].device)
            return xb, xm, xn, zero, zero
        return sweep

    monkeypatch.setattr(signiter, "get_sweep_program", get_sweep_program)
    _broken("h2o-dft-ls.scf")


def test_half_the_products_left_out(monkeypatch):
    from repro_torch.core import signiter

    orig = signiter.local_filtered_mm

    def half(ab, am, an, bb, bm, bn, **kw):
        am = am.clone()
        am[am.shape[0] // 2:] = False
        return orig(ab, am, an, bb, bm, bn, **kw)

    monkeypatch.setattr(signiter, "local_filtered_mm", half)
    _broken("h2o-dft-ls.scf")


def test_density_matrix_altered(monkeypatch):
    from repro_torch.core import bsm as B
    from repro_torch.core import signiter

    orig = signiter.density_matrix

    def altered(*a, **k):
        p, stats = orig(*a, **k)
        blocks = p.blocks.clone()
        blocks[0, 0] += 1e-2
        return B.BlockSparseMatrix(blocks=blocks, mask=p.mask,
                                   norms=p.norms), stats

    monkeypatch.setattr(signiter, "density_matrix", altered)
    _broken("h2o-dft-ls.scf")
