"""The work counts against hand counts on small inputs, and their
independence of how the program lays the work out."""
from __future__ import annotations

import math

import pytest
import torch

from perfbench import workcount as W


def test_roofs_are_the_data_sheets():
    assert W.TF32_FLOPS == 495e12 and W.BF16_FLOPS == 989e12
    assert W.HBM_BYTES_PER_S == 3.35e12
    # f32 block products are held to the TF32 tensor-core roof, not 67 TF
    assert W.ROOF_BY_DTYPE["float32"] == W.TF32_FLOPS
    assert W.least_seconds(989e12, 0.0, W.BF16_FLOPS) == 1.0
    assert W.least_seconds(0.0, 6.7e12, W.BF16_FLOPS) == 2.0


def _grid(mask, norms):
    return (torch.tensor(mask, dtype=torch.bool),
            torch.tensor(norms, dtype=torch.float32))


def test_kept_products_by_hand():
    # A = [[a, b], [0, c]], B = [[d, 0], [e, f]]; norms chosen so that
    # |b| |e| = 0.5 falls under the threshold 1 and every other pair of
    # present blocks is kept
    am, an = _grid([[1, 1], [0, 1]], [[2.0, 0.5], [0.0, 3.0]])
    bm, bn = _grid([[1, 0], [1, 1]], [[4.0, 9.0], [1.0, 5.0]])
    # kept: a d (8), b f (2.5), c e (3), c f (15); dropped: b e (0.5)
    kept, c_blocks = W.kept_products(am, an, bm, bn, threshold=1.0)
    assert kept == 4
    assert c_blocks == 4  # C00 (a d), C01 (b f), C10 (c e), C11 (c f)
    # an absent block's stale norm never counts
    an2 = an.clone()
    an2[1, 0] = 100.0
    assert W.kept_products(am, an2, bm, bn, threshold=1.0)[0] == 4
    # threshold 0: every pair of present blocks
    assert W.kept_products(am, an, bm, bn, threshold=0.0)[0] == 5


def test_spgemm_work_by_hand():
    am, an = _grid([[1, 1], [0, 1]], [[2.0, 0.5], [0.0, 3.0]])
    bm, bn = _grid([[1, 0], [1, 1]], [[4.0, 9.0], [1.0, 5.0]])
    w = W.spgemm_work(am, an, bm, bn, threshold=1.0, bs=23,
                      dtype="float32", same_operand=False)
    assert w["flops"] == 4 * 2 * 23 ** 3
    assert w["bytes"] == (3 + 3 + 4) * 23 * 23 * 4
    same = W.spgemm_work(am, an, am, an, threshold=0.0, bs=23,
                         dtype="float32", same_operand=True)
    # A A: a a, b 0 (absent), a b, b c, 0, c c -> kept a.a, a.b, b.c, c.c
    assert same["products"] == 4
    assert same["bytes"] == (3 + 3) * 23 * 23 * 4  # A read once, C written


def test_kept_products_in_row_chunks():
    g = torch.Generator().manual_seed(0)
    am = torch.rand((37, 29), generator=g) < 0.3
    bm = torch.rand((29, 41), generator=g) < 0.3
    an = torch.rand((37, 29), generator=g)
    bn = torch.rand((29, 41), generator=g)
    cube = (am[:, :, None] & bm[None]) & (an[:, :, None] * bn[None] > 0.2)
    for rows in (1, 5, 64):
        kept, cb = W.kept_products(am, an, bm, bn, 0.2, rows=rows)
        assert kept == int(cube.sum())
        assert cb == int(cube.any(1).sum())


def test_moe_work_by_hand():
    top_e = torch.tensor([[[0, 3], [3, 5]], [[0, 1], [7, 3]]])  # 4 tokens
    w = W.moe_work(top_e, d_model=8, d_expert=6, dtype="bfloat16")
    assert w["pairs"] == 8 and w["experts_hit"] == 5  # 0, 1, 3, 5, 7
    assert w["flops"] == 8 * 3 * 2 * 8 * 6
    assert w["bytes"] == 5 * 3 * 8 * 6 * 2 + 2 * 4 * 8 * 2


def test_kept_pairs_by_hand():
    assert W.kept_pairs(4, 4, causal=True) == 10
    assert W.kept_pairs(4, 4, causal=False) == 16
    assert W.kept_pairs(4, 4, causal=True, window=2) == 7
    assert W.kept_pairs(2, 6, causal=True, q_offset=4) == 5 + 6
    w = W.flash_work(batch=2, heads=4, kv_heads=2, sq=4, skv=4, hd=8,
                     causal=True, dtype="bfloat16")
    assert w["pairs"] == 2 * 4 * 10
    assert w["flops"] == 4 * 8 * 80
    assert w["bytes"] == 2 * 8 * 2 * (2 * 4 * 4 + 2 * 2 * 4)


def test_model_flops_from_the_widths():
    cfg = dict(hidden_size=8, num_attention_heads=2, num_key_value_heads=2,
               moe_intermediate_size=3, num_experts_per_tok=2,
               n_shared_experts=1, n_routed_experts=4, num_hidden_layers=2,
               vocab_size=10)
    per_layer = (2 * 8 * 32) + 2 * 8 * 4 + 2 * 3 * 8 * 3 * 3 + 4 * 8 * 5
    assert W.lm_token_flops(cfg, 5) == 2 * per_layer
    assert W.lm_decode_flops(cfg, 4) == 2 * per_layer + 2 * 8 * 10
    assert W.lm_prefill_flops(cfg, 3) == pytest.approx(
        sum(W.lm_token_flops(cfg, k) for k in (1, 2, 3)) + 160)


def test_deepseek_token_flops():
    """About 2 x 2.6 B active parameters a token (attention projections,
    router, 6 routed and 2 shared experts of 3 x 2,048 x 1,408, over 28
    layers), plus the head's 2 x 2,048 x 102,400."""
    from perfbench.tests.tiny import config

    cfg = config("deepseek-moe-16b")
    active = 28 * (4 * 2048 ** 2 + 2048 * 64 + 8 * 3 * 2048 * 1408)
    assert W.lm_token_flops(cfg, 0) == 2 * active
    assert W.lm_token_flops(cfg, 1) - W.lm_token_flops(cfg, 0) == \
        28 * 4 * 2048
    assert math.isclose(W.lm_decode_flops(cfg, 0) - W.lm_token_flops(cfg, 1),
                        2 * 2048 * 102400)


@pytest.mark.parametrize("token_block,capacity", [(4, None), (2, None),
                                                  (8, None), (4, 4096)])
def test_moe_count_ignores_the_program_layout(token_block, capacity):
    """The counted work comes from the router's choices: running the
    program's spgemm MoE layer with another token block or list capacity
    changes its kernel layout, not the count."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe as MoE

    base = get_arch("deepseek-moe-16b").reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, impl="spgemm", token_block=token_block))
    gen = torch.Generator().manual_seed(0)
    p = MoE.init_moe(cfg, gen, torch.float32)
    x = torch.randn((2, 12, cfg.d_model), generator=gen)
    seen = []
    orig = MoE.router_probs

    def spy(moe, logits):
        out = orig(moe, logits)
        seen.append(out[1])
        return out

    MoE.router_probs = spy
    try:
        spec = MoE.DispatchSpec(stack_capacity=capacity)
        with MoE.dispatch_scope(spec):
            MoE.apply_moe(cfg, p, x)
    finally:
        MoE.router_probs = orig
    w = W.moe_work(seen[0], d_model=cfg.d_model,
                   d_expert=MoE.moe_dims(cfg)[1], dtype="float32")
    probs = torch.softmax(x.reshape(-1, cfg.d_model) @ p["router"], -1)
    ref_e = torch.sort(probs, dim=-1, descending=True,
                       stable=True)[1][:, :cfg.moe.top_k]
    assert w["pairs"] == 24 * cfg.moe.top_k
    assert w["experts_hit"] == int(torch.unique(ref_e).numel())
