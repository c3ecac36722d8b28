"""The plain references at small sizes: the density matrix against its
defining properties and the dense sign iteration, the MoE decoder against
the program's forward pass on the same weights (so the reference follows
the configuration as the program runs it)."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench import gen
from perfbench.reference import moe_lm
from perfbench.reference import purification as R
from perfbench.tests import tiny


def _h(seed=3, nb=10, bs=4):
    b, m = gen.hamiltonian(seed, nb, bs, 0.3, "cpu")
    return R.dense(b, m)


def test_density_matrix_properties():
    h = _h()
    p, n_occ = R.density_matrix(h, 0.0)
    assert torch.allclose(p @ p, p, atol=1e-10)
    assert torch.allclose(p, p.T, atol=1e-12)
    assert abs(float(torch.trace(p)) - n_occ) < 1e-9
    assert n_occ == int((torch.linalg.eigvalsh(h) < 0).sum())
    # P commutes with H
    assert torch.allclose(p @ h, h @ p, atol=1e-9)


def test_dense_sign_iteration_matches_eigh():
    h = _h(seed=5)
    p, _ = R.density_matrix(h, 0.0)
    ns = R.newton_schulz(h, 0.0, tol=1e-12, max_iter=200,
                         dtype=torch.float64)
    assert R.max_abs_error(ns, p) < 1e-8
    ns32 = R.newton_schulz(h, 0.0, tol=1e-6, max_iter=100)
    assert R.max_abs_error(ns32, p) < 1e-4


def test_tf32_rounding_by_hand():
    # the spacing is 2^-10 in [1, 2) and 2^-9 in [2, 4); a half spacing
    # rounds away from zero
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0 - 2 ** -9 - 2 ** -11, -3.0 - 2 ** -10])
    assert R.to_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                     -3.0 - 2 ** -9, -3.0 - 2 ** -9]


def test_dense_assembly():
    blocks = torch.arange(2 * 2 * 2 * 3, dtype=torch.float32).reshape(
        2, 2, 2, 3)
    mask = torch.tensor([[True, False], [True, True]])
    d = R.dense(blocks, mask)
    assert d.shape == (4, 6) and d.dtype == torch.float64
    assert torch.equal(d[:2, :3], blocks[0, 0].double())
    assert torch.equal(d[:2, 3:], torch.zeros(2, 3, dtype=torch.float64))
    assert torch.equal(d[2:, 3:], blocks[1, 1].double())


def test_route_ties_go_to_the_lower_expert():
    cfg = {"num_experts_per_tok": 2}
    x = torch.ones((1, 2))
    router = torch.tensor([[1.0, 2.0, 2.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    w, idx = moe_lm.route(cfg, router, x)
    assert idx.tolist() == [[1, 2]]
    assert torch.allclose(w, torch.tensor([[0.5, 0.5]]))


def _f32_model():
    cfg = tiny.moe()
    cfg["torch_dtype"] = "float32"
    return cfg


def test_moe_reference_follows_the_program():
    """The program's forward (its exact ``dense`` expert path, f32) and
    the reference on the same weights and tokens."""
    from perfbench.drivers.lm_serving import arch_config
    from repro_torch.models import transformer as T

    cfg = _f32_model()
    params = gen.lm_params(cfg, 11, "cpu")
    acfg = arch_config(cfg)
    acfg = dataclasses.replace(acfg, moe=dataclasses.replace(acfg.moe,
                                                             impl="dense"))
    toks = torch.randint(0, cfg["vocab_size"], (2, 24),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        x, _ = T.forward(acfg, params, toks)
        ref = moe_lm.final_hidden(cfg, params, toks)
    assert torch.allclose(x, ref, atol=2e-5, rtol=1e-4)
    from repro_torch.models import layers as L

    lp = L.logits_matmul(acfg, params["embed"], x)
    lr = moe_lm.logits(params, ref.reshape(-1, cfg["hidden_size"]))
    assert torch.allclose(lp.reshape(lr.shape), lr, atol=1e-4)


def test_fp8_control_moves_the_logits():
    cfg = _f32_model()
    params = gen.lm_params(cfg, 12, "cpu")
    toks = torch.randint(0, cfg["vocab_size"], (1, 16),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        h = moe_lm.final_hidden(cfg, params, toks)[0]
        hq = moe_lm.final_hidden(cfg, params, toks, quant="fp8")[0]
        d = (moe_lm.logits(params, hq, "fp8") - moe_lm.logits(params, h))
    assert float(d.abs().mean()) > 1e-2


@pytest.mark.parametrize("quant", [None, "fp8"])
def test_reference_is_layer_by_layer_in_f32(quant):
    cfg = tiny.moe()  # bf16 weights: the reference computes in f32
    params = gen.lm_params(cfg, 13, "cpu")
    toks = torch.zeros((1, 5), dtype=torch.long)
    with torch.no_grad():
        h = moe_lm.final_hidden(cfg, params, toks, quant=quant)
    assert h.dtype == torch.float32 and h.shape == (1, 5, 64)
    assert params["blocks"][0]["moe"]["w_in"].dtype == torch.bfloat16
