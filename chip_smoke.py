#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``), one GPU.

    python3 chip_smoke.py

Phases, each raising on failure:

1. the device (name, and name / power limit from nvidia-smi) and the
   kernel build (``nvcc`` into ``build/kernels/``), with its seconds;
2. the block-SpGEMM kernel against its plain PyTorch version and the
   ``ref`` oracle on the card, over block shapes (rectangular and above
   the 96-wide panel included), f32 / bf16 and f8 storage (e4m3fn, e5m2:
   within one f8 ulp), occupancy and the on-the-fly
   threshold (capacity 0 included), on a 5 x 6 x 4 grid and on a 9 x 6 x 7
   grid with ragged group edges and scaled blocks that the threshold
   filters in part;
3. a full-width multiply, ``engine.multiply(H, H, backend="cuda")`` at
   nb = 512, bs = 23, occupancy 0.10 decay (the paper's H2O-DFT-LS blocks
   and occupancy, cut to one card), checked against the plain version;
   kernel, plain and library (dense ``torch.matmul``) times and the bound;
   then the kernel alone on a full 512^3 product list (the later sweeps),
   with the list build (group masks included) and the dense
   ``torch.matmul`` of the full-fill matrix beside it;
4. the full-width purification through ``repro_torch.launch.purify``,
   with the kernel's launch count set to 0 just before and read just
   after: sweeps, occupancy trajectory, wall time, launches, trace(P)
   against the float64 eigenvalue count, max |P^2 - P|;
5. the flash-attention kernels (bf16 on the tensor cores, f32 SIMT)
   against their plain version and the ``ref.attention_ref`` oracle on the
   card: causal on and off, windows 16 / 32 / 64 / 100 / 128, softcaps
   30 / 50, GQA 8:2, ragged 200 / 333, sq != skv, d 32 / 64 / 128,
   whisper's encoder (h 20, 1,500 frames, non-causal: a 92-key tail) and
   cross-attention (32 queries against 1,500 keys); the
   launch counter must rise by one per call; then bf16 layouts: the
   projections' head-transposed views (no copy), a seq stride TMA cannot
   take (one counted copy per tensor) and a query offset;
6. the whole reduced olmo-1b, jamba-v0.1-52b (mamba, attention, MoE; 16
   layers), rwkv6-7b, whisper-large-v3 (with frames) and pixtral-12b
   (with patches), f32, on the card against the same models on the CPU,
   from the same parameters: prefill (the flash kernel once per attention
   layer; whisper's also once per encoder layer and per cross-attention)
   and four decode steps with per-slot positions, logits within 1e-4;
7. full-width serving of olmo-1b (16 layers, d_model 2048, bf16) through
   ``repro_torch.launch.serve.run``: 16 requests through 8 slots, 2,048-
   token prompts, 64 new tokens each, both kernels' counts set to 0 just
   before and read just after; every request gets 64 tokens in the
   vocabulary, the flash kernel runs once per layer per prefill round on
   the projections' views as they are (no TMA copy), the
   prefill logits are finite and the first token of every request is their
   argmax, and request 0 served equals request 0 generated alone;
8. where the serving time goes: one prefill round (8 x 2,048 tokens) and
   16 decode steps of the same model under ``torch.profiler``: device
   time by kernel group (flash, cuBLAS matmuls, the rest), the top
   kernels, and the device's idle share of each window;
9. the flash kernel at the serving shape (b 8, h 16, s 2048, d 128, bf16,
   causal) against its plain version (bf16 with a row's limit shrinking
   as 1 / sqrt(its keys), and the f32 kernel on the same inputs at
   1e-4), timed beside the plain version,
   ``scaled_dot_product_attention`` (the library figure) and the bound;
10. every distributed engine at nb = 512 on meshes of ranks on the card,
    H.H and the full-fill X.X, against the single-device kernel, bytes per
    rank equal to ``plan_volume`` of the resolved transport;
11. the sharded purification on (l 2, r 2, c 2) through the entry point,
    against phase 4;
12. both purifications under ``torch.profiler``;
13. DBCSR's sparse wire and block distributions on H2O-DFT-LS: H.H on
    every engine of phase 10 under compressed and dense panels (bit for
    bit; bytes equal to ``plan_volume``), phase 11's chain under a
    forecast envelope and with compressed panels (bit for bit phase 11's
    P; every realized sweep mask inside the forecast; host syncs per
    sweep), and under the randomized and nnz-greedy assignments (phase
    11's gates; the product-load imbalance of each);
14. the pattern-aware tuner on H2O-DFT-LS at nb = 512 on a (r 2, c 2)
    mesh of ranks: the card's rank-to-rank copy rate (one dense panel
    hop), ``engine.multiply(H, H, mesh, engine="auto")`` on a fresh tuning
    database (candidates, pruned, the analytic stage's host seconds, every
    trial; C against the oracle, no trial error, CUDA candidates only),
    the same decision from the decision cache and then from the database
    file after ``plan.clear_cache()`` (no trial), the purification entry
    point with ``--engine auto --tuning-db`` cold (one decision, at most 3
    trials) and warm (no trial, the same engine), both inside phase 11's
    chain gates, and the kernel against its plain version at the default
    group layout and two smaller ones, each timed;
15. blocked sparse tensors: ``core.tensor.contract("ijk,kl->ijl", T, B,
    backend="cuda")`` on a screened three-center tensor (nb 32 and bs 23
    on every index, occupancy 0.10 decay, f32) against the plain backend
    and a dense f32 ``torch.einsum``; the kernel on the matricized
    (529 x 23) x (23 x 23) blocks timed beside its bound, plain version
    and the einsum;
16. one MoE layer of deepseek-moe-16b at full width (8 x 256 tokens,
    bf16) under dense, tp and spgemm (the dispatch cache's backend and
    capacity): spgemm against dense within 3e-2 with nothing dropped,
    3 kernel launches, under 4 GiB above the resident weights (the
    stride-0 expert bank); the kernel at the MoE shape (4 x 2048 times
    2048 x 1408 blocks) beside its bound and one ``torch.bmm``;
17. deepseek-moe-16b served at full width and depth (28 layers, 16.88 B
    bf16 parameters) through ``repro_torch.launch.serve``: 8 requests of
    256-token prompts + 32 new tokens, under ``--moe-impl spgemm`` (the
    decode decision names the kernel at capacity 128, launches 3 x 28 x
    (prefill calls + decode steps), nothing dropped, every request as
    generated alone; then one prefill round and four decode steps under
    ``torch.profiler``: device time by kernel group, idle share) and the
    config's ``tp`` (its drops printed);
18. jamba-v0.1-52b at full width and 16 of its 32 layers (bf16, 48.4 GiB
    of weights from seed 0) through ``repro_torch.launch.serve.run``:
    (a) the config's tp on 12 requests of 2,048-token prompts + 32 new
    through 8 slots (tokens in the vocabulary, flash launches = 2
    attention layers x prefill calls, first tokens the argmax of a
    separate prefill; dropped / routed printed), then one tp prefill
    round and four decode steps under ``torch.profiler`` by group (the
    mamba mixers' and the MoE layers' non-GEMM kernels, GEMMs, flash,
    the rest) with the idle share; (b) spgemm on the same weights, 8
    requests of 256 tokens + 16 new (nothing dropped, every request as
    generated alone, block-SpGEMM launches = 3 x 8 MoE layers x (prefill
    calls + decode steps)); (c) the kernel at this MoE shape ((4 x 4096)
    times (4096 x 14336) blocks, bf16) against its plain version, timed
    beside its bound and one grouped ``torch.bmm``; (e) the flash kernel
    at jamba's attention shape (h 32, hkv 8, s 2048, d 128) against its
    plain version, timed beside SDPA and the bound;
19. rwkv6-7b at full width and depth (bf16, seed 0), the same traffic as
    18 (a): tokens in the vocabulary, first tokens the argmax of a
    separate prefill, request 0 and the first refilled request as
    generated alone, neither kernel launched; the kernels a prefill
    launches (counted under ``torch.profiler`` at 64 and 128 tokens);
20. whisper-large-v3 at full width and depth (32 encoder + 32 decoder
    layers, bf16, 1.6 B parameters from seed 0) through the model's entry
    points with frames: 8 requests of 1,500 frame embeddings and a
    32-token prompt, 128 new greedy tokens (``T.prefill(frame_embeds=)``,
    then ``decode_step`` at per-slot positions): tokens in the
    vocabulary, first tokens the argmax of a separate prefill, 96 flash
    launches a prefill (encoder, self and cross) with no TMA copy, a
    non-zero cross cache, request 0 generated alone equal to request 0
    served; the encoder alone timed; a decode step under
    ``torch.profiler`` by group (GEMMs, cross-attention, the rest) with
    the idle share and the f32 copy of the cross K cache timed; the flash
    kernel at the encoder's shape (b 8, h 20, s 1,500, d 64, non-causal)
    against its plain version, timed beside SDPA and the bound;
21. pixtral-12b at full width and depth (40 layers, bf16, 12.25 B
    parameters from seed 0): (a) 16 requests of 1,024-token prompts + 64
    new through 8 slots via ``repro_torch.launch.serve.run`` with phase
    7's gates (40 flash launches a prefill round); (b) early fusion, 256
    patch embeddings in front of 8 of those prompts, 64 new greedy tokens
    (finite logits, first tokens the argmax of a separate prefill, 40
    launches, logits that differ from the text-only ones); (c) the flash
    kernel at (a)'s shape (h 32, hkv 8, s 1,024, d 128, causal) against
    its plain version, timed beside SDPA and the bound; (d) a prefill
    round and four decode steps under ``torch.profiler`` by kernel group;
22. the flash backward kernels (delta, dK / dV, dQ; three launches a
    call; bf16 on the tensor cores, f32 SIMT) and the forward's row
    log-sum-exp against their plain versions on the card: causal on and
    off, windows 32 / 64 / 100, softcaps 30 / 50, GQA 8:2, ragged 200 /
    333, sq != skv, rows that keep no key, a query offset, d 32 / 64 /
    128, f32 and bf16, a repeat call bit for bit the first; then at
    olmo-1b's training shape (b 8, h 16, s 2,048, d 128, bf16, causal)
    checked, repeated bit for bit, and timed whole and kernel by kernel
    (dK / dV, dQ) beside the plain backward, SDPA's backward and the
    bound (TFLOP/s on five, seven and ten products; TMA copies; ptxas's
    registers and spills of the backward kernels);
23. one training step (``launch.steps.build_train_step``) of reduced
    olmo-1b and gemma2-27b (f32; window, softcaps, post-norms) on the
    card against the same step on the CPU from the same parameters and
    batch, under remat none, full and dots: loss, grad norm and every
    leaf of params, mu and nu within 1e-4 (``train_state_close``), flash
    forward and backward launches per layer;
24. olmo-1b at full width and depth (1.18 B parameters, bf16, AdamW f32
    moments) trained through ``repro_torch.launch.train.run``: 10 steps
    of 8 x 2,048 tokens, remat full, lr 3e-3, the flash counts set to 0
    just before and read just after (forward 16 x 2 x 10, backward 16 x 3
    x 10, no TMA copy), finite losses with the last below the first; the
    loss trajectory, step ms, tokens/s, peak memory and the model-FLOP
    share; one step under ``torch.profiler`` by group (GEMMs, flash
    forward, flash backward, cross-entropy, AdamW, the rest) with the
    idle share; then at the reduced size 4 steps, a checkpoint and a
    resumed launch to 8 against one 8-step run within 1e-6;
25. sharded training on meshes of ranks on the one card
    (``launch.steps.build_train_step(..., mesh=)``: TP over ``model``,
    FSDP over ``data``, the batch over ``(pod, data)``).  (a) reduced
    olmo-1b, gemma2-27b and qwen1.5-4b (f32) on (data 2, model 2) and
    (pod 2, data 1, model 2) with ``head_2p5d``, under ZeRO-1,
    microbatch 2, compressed gradients and sequence parallelism: one
    step against the one-device step on the card within phase 23's
    limits, bytes per rank equal to ``steps.step_bytes``'s count from
    the specs, flash launches exact per rank; (b) olmo-1b at full width
    and depth through ``launch.train.run(["--mesh", "2x2", ...])`` with
    phase 24's traffic: finite losses, the last below the first, step 1's
    loss within 1e-2 of phase 24's, flash counts 4 ranks x phase 24's, no
    TMA copy; step ms, tokens/s, the model-FLOP share, peak memory beside
    the state the specs place, bytes per rank per step beside the count;
    one step under ``torch.profiler`` by group (collectives their own);
    then at the reduced size a 2 x 2 checkpoint resumed on 1 x 1 against
    the same run without the round trip, within 1e-6; (c) the 2.5D LM
    head (``parallel.matmul_2p5d``) at olmo's training shape (T 16,384, d
    2,048, V 50,304, bf16) on (pod 2, model 2): within the bf16 limit of
    one ``torch.matmul``, bytes exactly ``plan_2p5d``'s, timed beside
    that matmul and the all-gather-the-weight baseline;
26. the dry run.  (a) olmo-1b at full width and depth (bf16) served on
    (data 2, model 2) ranks of the card (``launch.steps.build_prefill_step``
    / ``build_serve_step(..., mesh=)``: the cache laid out by
    ``cache_specs``) against the one-device steps on the same parameters:
    8 prompts of 2,048 tokens, then 32 decode steps on the one-device
    run's greedy tokens; every step's logits within the bf16 limit (3e-2
    of the largest), flash launches exactly one per rank and layer, no TMA
    copy; the sharded prefill s, decode ms a step (and the one-device
    step's) and the share of greedy tokens equal.  (b) the dry run's
    tracer (``roofline/hlo_cost.py`` on ``meta`` ranks) against the card
    on phase 24's 1 x 1 step and phase 25's 2 x 2 step: the traced FLOPs
    equal ``FlopCounterMode`` over the real step, the traced wire bytes
    ``step_bytes`` and the measured ``bytes_moved``; the traced peak
    beside ``max_memory_allocated``, the roofline's bound beside the
    measured step.  (c) ``launch.dryrun``'s cells of olmo-1b (decode_32k,
    prefill_32k, train_4k) on the abstract single-pod mesh, each ``ok``:
    trace_s, the three terms, the dominant one and the memory per device;
    host work on ``meta`` tensors in a process of its own, started before
    phase 17 so that it overlaps the device-bound spgemm serving of phases
    17 and 18 (its one core beside the run's), read here;
27. the MoE and hybrid families on (data 2, model 2) ranks of the card
    (``parallel/runtime.py``: experts over ``data`` with d_expert over
    ``model`` (tp) or the experts over ``model`` (ep), the load-balance
    loss from global sums, mamba's channels over ``model``).  (a)
    reduced deepseek-moe-16b under tp and ep and reduced jamba (one
    8-layer pattern), f32: one sharded training step and a prefill + 4
    decode steps on the card against the same on a CPU mesh, within 1e-4
    (``train_state_close``; loss, ce, moe_aux, grad norm; logits), bytes
    per rank equal to ``step_bytes``, flash launches exact; (b) full
    width through ``launch.train --mesh 2x2 --layers N`` (deepseek 4 of
    28 layers, 8 x 2,048 tokens; jamba its first 2 layers, attention +
    MLP then mamba + MoE, 4 x 2,048 tokens; the full depth's AdamW state
    exceeds the card), 5 steps: finite losses and moe_aux, the last loss
    below the first, every step's loss within 1e-2 of the one-device
    step's at the same cut (jamba, whose one-device AdamW state does not
    fit beside its update: step 1's loss), bytes per
    rank equal to ``step_bytes``, flash launches 4 ranks x attention
    layers x steps x (2 forward, 3 backward), the peak against 80 GiB;
    (c) serving on 2 x 2 ranks (tp, bf16; the tensor-parallel partials
    summed in f32) against the one-device steps batched as the data
    ranks batch the rows (deepseek at full depth, jamba cut to 8 layers;
    8 x 256-token prompts + 16 decode steps on the one-device run's
    greedy tokens): on the ranks' own expert choices, logits within 3e-2
    of the largest and at least 0.90 of the greedy tokens equal, or
    within twice what weights one ulp off move the one-device steps on
    their own choices where that is more, the prefill's dropped / routed
    printed; on the one-device run's expert choices (``_Routing``: a
    near-tied choice flipped by a sum in another order spreads over a
    capacity-dispatched row), 3e-2 and 0.90, or no farther than the
    one-device steps' f32 twin (the same weights in f32) where that is
    farther, and the same dropped choices; the same weights in f32 on
    those choices against the one-device f32 steps within 1e-4, every
    greedy token equal; flash launches one per rank and attention layer
    in every run;
28. the ssm, audio and vlm families on (data 2, model 2) ranks of the
    card (rwkv6's channels and heads over ``model``; whisper's encoder on
    each rank's frames and cross-attention under the ``xattn`` rules;
    pixtral's patches placed after the vocab-parallel embedding's
    reduction).  (a) reduced rwkv6-7b, whisper-large-v3 (with frames) and
    pixtral-12b (with patches), f32: one sharded training step and a
    prefill + 4 decode steps on the card against the same on a CPU mesh,
    within 1e-4, bytes per rank equal to ``step_bytes``, flash launches
    exact; (b) full width, three sharded steps each (rwkv6 4 of 32 layers,
    8 x 1,024 tokens; whisper at full depth, 8 x (1,500 frames + 448
    tokens); pixtral 4 of 40 layers, 8 x (256 patches + 1,792 tokens)):
    finite losses, step 1's within 1e-2 of the one-device loss, bytes per
    rank equal to ``step_bytes``, flash launches 4 ranks x attention calls
    x steps x (2 forward, 3 backward), step ms, tokens/s, the peak; (c)
    serving at full width and depth (bf16, f32 partial sums; rwkv6 8 x 256
    + 16, whisper 8 x (1,500 frames + 32) + 32, pixtral 8 x (256 patches
    + 768 tokens) + 16) against the one-device steps on their greedy
    tokens: logits within 3e-2 of the largest and at least 0.90 of the
    greedy tokens equal; where that misses (bf16's own rounding: rwkv6's
    recurrence carries it through 32 layers and 256 tokens), each bf16
    path is held to the one-device steps' f32 twin (the same weights in
    f32): the ranks within 3e-2 / 0.90 of it or twice the one-device
    steps' own distance from it, and the same weights in f32 on the ranks
    within 1e-4 of the twin, or twice what weights one ulp off move the
    twin where that is more; flash launches one per rank and attention
    call, prefill s and decode ms;
29. the examples: the twins of the JAX package's five drivers
    (``repro_torch.examples``) through their ``main`` at its defaults
    (``train_lm`` at ``--steps TRAIN_LM_STEPS``), both kernels' counts
    set to 0 just before each call and read just after, each call's
    seconds and counts printed:
    ``linear_scaling_dft`` (the static 2.5D chain, then ``--tuning-db``
    cold and warm: trials cold, none warm), ``quickstart``,
    ``tensor_contraction`` (the tuner's choice of backend decides whether
    the block-SpGEMM kernel runs), ``serve_batch`` (the flash kernel once
    per layer for its prefill round and once per layer for the
    teacher-forced forward) and ``train_lm`` (``TRAIN_LM_STEPS`` steps of
    the 8-layer d 768 olmo-family model on 2 x 2 ranks: flash forward 4
    ranks x layers x steps x 2, backward x 3; the loss falls by more than
    1), each ending with its ``"<name> OK"``.

Timed phases print the card's SM and memory clocks and temperature
before and after.  Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2
and prints no result.  Imports nothing of jax or of the JAX package.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs.dbcsr_benchmarks import BENCHMARKS  # noqa: E402

# the paper's H2O-DFT-LS matrix (Table 1): its blocks, occupancy and
# pattern, on a block grid cut to one card
H2O = BENCHMARKS["h2o_dft_ls"]
NB, BS, OCC, PATTERN, SEED = 512, H2O.block_size, H2O.occupancy, \
    H2O.pattern, 0
THRESHOLD, FILTER_EPS = 1e-9, 1e-8
PURIFY_ARGV = ["--nb", str(NB), "--bs", str(BS), "--occupancy", str(OCC),
               "--threshold", str(THRESHOLD), "--filter-eps", str(FILTER_EPS),
               "--max-iter", "100", "--tol", "1e-6", "--sync-every", "4",
               "--backend", "cuda", "--repeats", "1", "--seed", str(SEED)]
# published H100 SXM peaks (data sheet, 700 W): f32 outside the tensor
# cores, bf16 dense tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
# kernel vs plain / oracle: f32 up to summation order; bf16 one output
# rounding of unit-scaled blocks (the reference's _DTYPE_TOL)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# f8 storage: the kernel and the plain version round f32 sums that differ
# in order only, so they agree within one f8 ulp: (mantissa bits, least
# normal exponent) of each format
F8 = {"float8_e4m3fn": (3, -6), "float8_e5m2": (2, -14)}
IDEMPOTENCY_TOL = 1e-3  # max |P^2 - P|, as the reference's own test
# flash kernel vs plain / oracle: f32 up to summation order; bf16 the
# kernel's rounding of p to bf16 before P.V (the TPU kernel's), which the
# plain loop skips — the reference's own bf16 tolerance
FLASH_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# at the serving shape the late rows average ~2,000 keys and their outputs
# are ~0.04, below FLASH_TOL's bf16 limit.  There the kernel's f32 instance
# on the same inputs is held to the f32 limit, and the bf16 limit of a row
# that keeps n keys is atol / sqrt(n) + rtol |plain|: the kernel's rounding
# of p (2^-9 relative per term) moves a row's average of n keys by about
# 2^-9 max|v| / sqrt(n) <= 1.1e-2 / sqrt(n), and one output rounding is
# under 2^-8 relative
FLASH_SERVE_TOL_BF16 = dict(atol=3e-2, rtol=2e-2)
MODEL_TOL = 1e-4  # reduced f32 model, CUDA vs CPU logits
# the serving cell: olmo-1b at full width; 8 slots x 2,048-token prompts
# + 64 new tokens (the repo's prefill_32k / decode_32k cut to fit the run)
SERVE_ARGV = ["--arch", "olmo-1b", "--batch", "8", "--prompt-len", "2048",
              "--max-new", "64", "--max-len", "2176", "--queue", "16",
              "--seed", str(SEED)]
FLASH_SHAPE = dict(b=8, h=16, s=2048, d=128)  # one prefill round's layer


def _clocks(tag: str) -> None:
    """Print the card's SM and memory clocks and temperature, as nvidia-smi
    reads them, on a line of its own (before and after each timed phase:
    a card held below its clocks runs slower, whatever the code)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"{tag} clocks (sm, mem, temperature): {out}", flush=True)


def _timed(n: int, fn, *args):
    """Run phase ``n`` between two clock readings, and print its host
    seconds."""
    _clocks(f"[{n}] before:")
    t0 = time.perf_counter()
    out = fn(*args)
    _clocks(f"[{n}] after:")
    print(f"[{n}] phase {n} took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def _time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _timed_call(fn) -> tuple:
    """(``fn()``, its CUDA-event ms): one call, no warm-up — for a plain
    version that is no yardstick, whose output the check needs anyway."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _served_alone(engine, prompts: list, outputs: list) -> list:
    """Every served request against its generation alone: one flag per
    request."""
    return [engine.generate([q])[0] == out
            for q, out in zip(prompts, outputs)]


def _close(got, want, tol: float) -> tuple[bool, float]:
    d = (got.float() - want.float()).abs()
    if d.numel() == 0:
        return True, 0.0
    ok = bool((d <= tol + tol * want.float().abs()).all())
    return ok, float(d.max())


def _f8_close(got, want, dtype: str) -> tuple[bool, float]:
    """Within one f8 ulp of the larger of the two magnitudes (the
    subnormal spacing below the least normal)."""
    import torch

    mant, emin = F8[dtype]
    g, w = got.float(), want.float()
    top = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** emin)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - mant)
    d = (g - w).abs()
    return bool((d <= ulp).all()), float(d.max()) if d.numel() else 0.0


def _bound(ok, bs: int, itemsize: int) -> tuple[float, str]:
    """``_bound_rect`` of square f32 blocks."""
    return _bound_rect(ok, bs, bs, bs, itemsize, PEAK_F32_FLOPS)


def _bound_rect(ok, bs_r: int, bs_k: int, bs_c: int, itemsize: int,
                peak: float) -> tuple[float, str]:
    """Least time for a product list: its FMAs at ``peak``, or each used
    operand block read once and each non-empty output block written once
    at the memory rate, whichever is larger."""
    n = int(ok.sum())
    t_ops = 2.0 * n * bs_r * bs_k * bs_c / peak
    words = (int(ok.any(2).sum()) * bs_r * bs_k
             + int(ok.any(0).sum()) * bs_k * bs_c
             + int(ok.any(1).sum()) * bs_r * bs_c)
    t_bytes = words * itemsize / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# (ni, nk, nj, block scales): unit blocks, and a grid with ragged group
# edges (9 x 7 blocks against 4 x 4 groups) whose blocks are scaled by
# 10^U(-2, 0), so threshold 0.05 filters part of a group's products
SPGEMM_GRIDS = ((5, 6, 4, False), (9, 6, 7, True))


def phase_kernel_vs_plain(torch, np, K, S, ref, lm, B) -> float:
    """Phase 2: kernel against plain version and oracle; returns max err."""
    rng = np.random.default_rng(SEED)
    worst, cases, bad = 0.0, 0, []
    worst_f8 = dict.fromkeys(F8, 0.0)
    for shape, (ni, nk, nj, scaled) in (
            (shape, grid) for grid in SPGEMM_GRIDS
            for shape in ((4, 4, 4), (8, 8, 8), (23, 23, 23), (64, 64, 64),
                          (128, 128, 128), (4, 16, 8), (30, 7, 25))):
        bs_r, bs_k, bs_c = shape
        for dtype in ("float32", "bfloat16", *F8):
            dt = getattr(torch, dtype)
            for occ in (0.0, 0.05, 0.3, 1.0):
                for thr in (0.0, 0.05):
                    a = rng.standard_normal((ni, nk, bs_r, bs_k)) / np.sqrt(bs_k)
                    b = rng.standard_normal((nk, nj, bs_k, bs_c)) / np.sqrt(bs_k)
                    if scaled:
                        a *= 10.0 ** rng.uniform(-2, 0, (ni, nk, 1, 1))
                        b *= 10.0 ** rng.uniform(-2, 0, (nk, nj, 1, 1))
                    am = torch.from_numpy(rng.random((ni, nk)) < occ).cuda()
                    bm = torch.from_numpy(rng.random((nk, nj)) < occ).cuda()
                    # masked in f32, then stored (f8 has no multiply)
                    ta = (torch.from_numpy(a.astype(np.float32)).cuda()
                          * am[:, :, None, None]).to(dt)
                    tb = (torch.from_numpy(b.astype(np.float32)).cuda()
                          * bm[:, :, None, None]).to(dt)
                    ok = lm.pair_filter(am, B.block_norms(ta), bm,
                                        B.block_norms(tb), thr)
                    n = S.product_count(ok)
                    stacks = S.compact_pair_mask(
                        ok, capacity=S.bucket_capacity(n))
                    before = K.launches
                    got = K.block_spgemm_stacks(ta, tb, stacks, ni=ni, nj=nj)
                    if K.launches != before + (1 if n else 0):
                        bad.append((shape, (ni, nk, nj), dtype, occ, thr,
                                    "no launch"))
                    plain = K.block_spgemm_stacks_plain(ta, tb, stacks,
                                                        ni=ni, nj=nj)
                    oracle = ref.block_spgemm_ref(ta, tb, ok)
                    for want in (plain, oracle):
                        if dtype in F8:
                            good, err = _f8_close(got, want, dtype)
                            worst_f8[dtype] = max(worst_f8[dtype], err)
                        else:
                            good, err = _close(got, want, TOL[dtype])
                            worst = max(worst, err)
                        if not good:
                            bad.append((shape, (ni, nk, nj), dtype, occ, thr,
                                        err))
                    cases += 1
    torch.cuda.synchronize()
    print(f"[2] kernel vs plain and oracle: {cases} cases, max |err| "
          f"{worst:.3e}, tolerances {TOL}; f8 storage max |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst_f8.items())
          + " (each within one f8 ulp)", flush=True)
    if bad:
        raise AssertionError(f"kernel disagrees: {bad}")
    return worst


def phase_full_width_multiply(torch, K, S, B, E, plan) -> dict:
    """Phase 3: engine.multiply at full width, checked and timed."""
    h = B.random_bsm(SEED, nb=NB, bs=BS, occupancy=OCC, pattern=PATTERN,
                     symmetric=True, device="cuda")
    plan.clear_cache()
    c = E.multiply(h, h, backend="cuda", threshold=THRESHOLD,
                   filter_eps=FILTER_EPS)
    ok = S.pair_cube(h.mask, h.mask, h.norms, h.norms, THRESHOLD)
    stacks, n = plan.get_product_stacks(ok)  # the multiply's cached list
    gm = _group_masks(K, stacks)

    def kernel():
        return K.block_spgemm_groups(h.blocks, h.blocks, gm, ni=NB, nj=NB)

    def plain():
        return K.block_spgemm_stacks_plain(h.blocks, h.blocks, stacks,
                                           ni=NB, nj=NB)

    ck, cp = kernel(), plain()
    good, err = _close(ck, cp, TOL["float32"])
    if not good:
        raise AssertionError(f"full-width kernel vs plain: max |err| {err}")
    cm = ok.any(1)
    want = B.filter_bsm(B.make_bsm(cp, cm), FILTER_EPS)
    good_c, err_c = _close(c.blocks, want.blocks, TOL["float32"])
    if not (good_c and torch.equal(c.mask, want.mask)):
        raise AssertionError(f"multiply result vs plain: max |err| {err_c}")
    del ck, cp, want
    ms = _time_ms(kernel, reps=7, warmup=2)
    plain_ms = _time_ms(plain, reps=5, warmup=1)
    dense = h.to_dense()
    library_ms = _time_ms(lambda: torch.matmul(dense, dense), reps=5,
                          warmup=1)
    bound_ms, bound_by = _bound(ok, BS, 4)
    occ = float(h.occupancy())
    tiles = int(cm.sum())
    print(f"[3] multiply H.H: n={NB * BS}, H occupancy {occ:.4f}, products "
          f"{n} ({n / NB**3:.2%} of the cube), output tiles {tiles}, "
          f"C occupancy {float(c.occupancy()):.4f}; kernel vs plain max "
          f"|err| {err:.3e}", flush=True)
    print(f"[3] times (ms, median of CUDA events): kernel {ms:.4f}  plain "
          f"{plain_ms:.4f}  library(torch.matmul dense f32) {library_ms:.4f} "
          f" bound {bound_ms:.4f} ({bound_by}); kernel "
          f"{2.0 * n * BS**3 / ms / 1e9:.3f} TFLOP/s", flush=True)
    del dense, stacks, gm, c, ok
    # the later sweeps: X fills to 100 %, the full 512^3 list
    x = B.random_bsm(SEED + 1, nb=NB, bs=BS, pattern="dense", device="cuda")

    def list_build():
        # what each multiply does before the kernel: filter cube, count,
        # compaction and group masks (three host syncs)
        ok = S.pair_cube(x.mask, x.mask, x.norms, x.norms, THRESHOLD)
        st = S.compact_pair_mask(
            ok, capacity=S.bucket_capacity(S.product_count(ok)))
        return ok, st, _group_masks(K, st)

    ok_full, st_full, gm_full = list_build()
    n_full = int(st_full.valid.sum())
    build_ms = _time_ms(list_build, reps=3)
    masks_ms = _time_ms(lambda: _group_masks(K, st_full), reps=3)
    full_ms = _time_ms(lambda: K.block_spgemm_groups(
        x.blocks, x.blocks, gm_full, ni=NB, nj=NB), reps=3)
    full_bound_ms, full_by = _bound(ok_full, BS, 4)
    del ok_full, st_full, gm_full
    xd = x.to_dense()  # at full fill the dense product is the same product
    full_library_ms = _time_ms(lambda: torch.matmul(xd, xd), reps=5,
                               warmup=1)
    print(f"[3] full fill: products {n_full}, list build {build_ms:.4f} ms "
          f"(of which group masks {masks_ms:.4f} ms), "
          f"kernel {full_ms:.4f} ms, bound {full_bound_ms:.4f} ({full_by}), "
          f"{2.0 * n_full * BS**3 / full_ms / 1e9:.3f} TFLOP/s; library "
          f"(torch.matmul dense f32) {full_library_ms:.4f} ms, "
          f"{2.0 * (NB * BS)**3 / full_library_ms / 1e9:.3f} TFLOP/s, "
          f"kernel / library {full_ms / full_library_ms:.2f}x", flush=True)
    del x, xd
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                full_ms=full_ms, full_library_ms=full_library_ms)


def _group_masks(K, stacks):
    """The per-group k masks the kernel walks, for NB x NB blocks of BS."""
    tile = K.kernel_tile(BS, BS)
    return K.group_masks(stacks, ni=NB, nk=NB, nj=NB, g_r=tile.g_r,
                         g_c=tile.g_c)


def phase_purify(torch, K, purify) -> tuple[int, dict]:
    """Phase 4: the main path, through the user's entry point; returns the
    launches and the report (with P) for phase 11."""
    torch.cuda.reset_peak_memory_stats()
    K.launches = 0
    report = purify.run(PURIFY_ARGV + ["--p", "1", "--l", "1"])
    launches = K.launches
    r = report["runs"][0]
    print(f"[4] purification: {r['iterations']} sweeps, converged "
          f"{r['converged']}, wall {r['wall_s']:.3f} s, kernel launches "
          f"{launches}, trace(P) {r['trace']:.4f} vs eigenvalue count "
          f"{report['n_occ']} (|err| {r['trace_err']:.3e}, tolerance "
          f"{purify.TRACE_TOL}), max|P^2-P| {r['idempotency']:.3e}, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    if launches == 0:
        raise AssertionError("the purification never launched the kernel")
    if not (report["ok"] and r["converged"]):
        raise AssertionError(f"purification failed: {r}")
    if r["idempotency"] > IDEMPOTENCY_TOL:
        raise AssertionError(f"P is no projector: {r['idempotency']}")
    return launches, report


def _tree_to(tree, dev):
    """Nested dicts / lists of tensors copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


# (b, h, hkv, sq, skv, d, causal, window, softcap)
FLASH_CASES = (
    (1, 2, 2, 256, 256, 64, True, None, None),
    (1, 2, 2, 256, 256, 64, False, None, None),
    (1, 2, 2, 256, 256, 64, True, 32, None),
    (1, 2, 2, 256, 256, 128, True, 128, None),
    (1, 2, 2, 256, 256, 64, True, None, 50.0),
    (2, 8, 2, 256, 256, 128, True, None, None),
    (2, 4, 4, 200, 200, 64, True, None, None),
    (2, 4, 4, 200, 200, 128, False, None, None),
    (1, 4, 2, 128, 384, 128, True, None, None),
    (1, 4, 2, 384, 128, 64, False, None, None),
    (1, 2, 1, 333, 333, 128, True, 100, 30.0),
    (2, 8, 2, 200, 200, 32, True, None, None),
    (1, 8, 2, 200, 328, 64, True, 64, None),
    (1, 4, 2, 333, 200, 128, False, None, 30.0),
    (2, 8, 2, 256, 256, 32, True, 16, 50.0),
    # whisper: the encoder's self-attention over 1,500 frames (a 92-key
    # tail past the last 128-key tile) and the decoder's cross-attention
    (2, 20, 20, 1500, 1500, 64, False, None, None),
    (2, 20, 20, 32, 1500, 64, False, None, None),
)


def phase_flash_vs_plain(torch, np, FA, ref) -> float:
    """Phase 5: the flash kernel against its plain version and the oracle;
    returns the max |err| against the plain version."""
    rng = np.random.default_rng(SEED)
    worst, bad, cases = 0.0, [], 0
    for case in FLASH_CASES:
        b, h, hkv, sq, skv, d, causal, window, softcap = case
        amp = 4.0 if softcap else 1.0  # logits large enough to meet the cap
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, k, v = (torch.from_numpy(rng.standard_normal(shape) * a)
                       .to("cuda", dt) for shape, a in (
                           ((b, h, sq, d), amp), ((b, hkv, skv, d), amp),
                           ((b, hkv, skv, d), 1.0)))
            kw = dict(causal=causal, window=window, softcap=softcap)
            before = FA.launches
            got = FA.flash_attention(q, k, v, **kw)
            if FA.launches != before + 1:
                bad.append((case, dtype, "no launch"))
            plain = FA.flash_attention_plain(q, k, v, **kw)
            rep = h // hkv
            oracle = ref.attention_ref(q, k.repeat_interleave(rep, 1),
                                       v.repeat_interleave(rep, 1), **kw)
            for i, want in enumerate((plain, oracle)):
                good, err = _close(got, want, FLASH_TOL[dtype])
                if i == 0:
                    worst = max(worst, err)
                if not good:
                    bad.append((case, dtype, err))
            cases += 1
    # layouts: the projections' head-transposed views (TMA reads them as
    # they are), a seq stride of d + 4 elements (not 16-byte units: the
    # wrapper copies each), and a query offset
    b, h, hkv, s, d = 2, 8, 2, 200, 128
    for name, pad, transposed, q_offset, copies in (
            ("transposed", 0, True, 0, 0), ("stride d+4", 4, False, 0, 3),
            ("q_offset 56", 0, False, 56, 0)):
        def make(heads, a=1.0):
            x = rng.standard_normal((b, s, heads, d + pad)) * a
            x = torch.from_numpy(x).to("cuda", torch.bfloat16)
            x = x.transpose(1, 2)  # (b, heads, s, d + pad)
            return x[..., :d] if transposed or pad else x.contiguous()
        q, k, v = make(h), make(hkv), make(hkv)
        kw = dict(causal=True, q_offset=q_offset)
        before = FA.copies
        got = FA.flash_attention(q, k, v, **kw)
        plain = FA.flash_attention_plain(q, k, v, **kw)
        good, err = _close(got, plain, FLASH_TOL["bfloat16"])
        worst = max(worst, err)
        if not good or FA.copies - before != copies:
            bad.append((name, err, FA.copies - before))
        cases += 1
    torch.cuda.synchronize()
    print(f"[5] flash kernel vs plain and oracle: {cases} cases, max |err| "
          f"vs plain {worst:.3e}, tolerances {FLASH_TOL}", flush=True)
    if bad:
        raise AssertionError(f"flash kernel disagrees: {bad}")
    return worst


# phase 6: the reduced models (f32) on the card and on the CPU; the
# prompt is a multiple of the recurrent mixers' reduced chunk (8)
MODEL_ARCHS = ("olmo-1b", "jamba-v0.1-52b", "rwkv6-7b", "whisper-large-v3",
               "pixtral-12b")


def _stub_embeds(torch, np, cfg, batch: int, seed: int, dtype=None) -> dict:
    """The prefill keyword of an arch's stub frontend, drawn from ``seed``
    on the card: whisper's ``frame_embeds`` (batch, n_frames, d), pixtral's
    ``patch_embeds`` (batch, n_patches, d); none for the others."""
    if cfg.encoder is not None:
        name, n = "frame_embeds", cfg.encoder.n_frames
    elif cfg.frontend == "vision":
        name, n = "patch_embeds", cfg.n_patches
    else:
        return {}
    x = np.random.default_rng(seed).standard_normal((batch, n, cfg.d_model),
                                                    dtype=np.float32)
    return {name: torch.from_numpy(x).to(
        "cuda", dtype or getattr(torch, cfg.dtype))}


def _flash_per_prefill(T, cfg, with_frames: bool = True) -> int:
    """Flash launches of one prefill: one per attention layer, and with
    an encoder and frames one per encoder layer and one more (the
    cross-attention) per decoder layer."""
    n = sum(k["mixer"] == "attention" for k in T.layer_kinds(cfg))
    if cfg.encoder is not None and with_frames:
        n += cfg.encoder.n_layers + cfg.n_layers
    return n


def phase_model_cuda_vs_cpu(torch, np, T, FA, get_arch) -> float:
    """Phase 6: reduced olmo-1b, jamba-v0.1-52b, rwkv6-7b, whisper-large-v3
    (with frames) and pixtral-12b (with patches), f32, the same parameters
    and embeddings on the card and on the CPU: prefill (the flash kernel
    once per attention layer: olmo's 4, jamba's 2 of 16, none of rwkv6's,
    whisper's 2 encoder + 2 self + 2 cross, pixtral's 2) and four decode
    steps with per-slot positions."""
    worst_all = 0.0
    for arch in MODEL_ARCHS:
        cfg = get_arch(arch).reduced()
        p_cpu = T.init_params(cfg, SEED, device="cpu")
        dev = "cuda"
        p_dev = _tree_to(p_cpu, dev)
        rng = np.random.default_rng(SEED)
        batch, plen, max_len = 4, 200, 256
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, plen)))
        emb = _stub_embeds(torch, np, cfg, batch, SEED + 1)
        c_cpu = T.init_cache(cfg, batch, max_len, device="cpu")
        c_dev = T.init_cache(cfg, batch, max_len, device=dev)
        before = FA.launches
        l_dev, c_dev = T.prefill(cfg, p_dev, toks.to(dev), c_dev, **emb)
        launched = FA.launches - before
        l_cpu, c_cpu = T.prefill(cfg, p_cpu, toks, c_cpu,
                                 **{k: v.cpu() for k, v in emb.items()})
        worst = float((l_dev.cpu() - l_cpu).abs().max())
        pos = torch.tensor([plen, plen - 7, plen - 50, plen - 1])
        for _ in range(4):
            t = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, 1)))
            l_dev, c_dev = T.decode_step(cfg, p_dev, t.to(dev), c_dev,
                                         pos.to(dev))
            l_cpu, c_cpu = T.decode_step(cfg, p_cpu, t, c_cpu, pos)
            worst = max(worst, float((l_dev.cpu() - l_cpu).abs().max()))
            pos = pos + 1
        n_attn = sum(k["mixer"] == "attention" for k in T.layer_kinds(cfg))
        want = _flash_per_prefill(T, cfg)
        print(f"[6] reduced {arch} f32 ({cfg.n_layers} layers, {n_attn} "
              f"attention, d_model {cfg.d_model}{', ' if emb else ''}"
              f"{', '.join(emb)}), cuda vs cpu: prefill + 4 decode steps, "
              f"max |logit err| {worst:.3e} (tolerance {MODEL_TOL}), flash "
              f"launches in the prefill {launched}", flush=True)
        if launched != want:
            raise AssertionError(f"{arch}: prefill launched the flash kernel"
                                 f" {launched} times, not {want}")
        if not worst <= MODEL_TOL:
            raise AssertionError(f"{arch} on cuda vs cpu: {worst}")
        worst_all = max(worst_all, worst)
    return worst_all


def phase_serve(torch, np, T, K, FA, serve, argv=SERVE_ARGV, tag="[7]"):
    """Phase 7 (and 21 (a)): the serving path at full width, through the
    entry point; returns the report, the engine that served it and the
    first round's prompts on the card (for phase 8)."""
    built = serve.build(argv)
    K.launches = 0
    FA.launches = 0
    FA.copies = 0
    st = serve.run(argv, built=built)
    launches = FA.launches
    spgemm_launches = K.launches
    copies = FA.copies
    n_rounds = len(st["prefill_s"])
    print(f"{tag} serve: {st['requests']} requests, {st['tokens']} tokens, "
          f"wall {st['wall_s']:.3f} s, {st['tokens_per_s']:.1f} tok/s, "
          f"prefill s per round {[round(x, 4) for x in st['prefill_s']]}, "
          f"decode ms/step median {st['decode_ms_median']:.4f}, refills "
          f"{st['refills']}, flash launches {launches} "
          f"({st['n_layers']} layers x {n_rounds} prefill rounds), "
          f"block_spgemm launches {spgemm_launches}, flash input copies "
          f"{copies}, peak memory {st['peak_mem_gib']} GiB", flush=True)
    if launches == 0:
        raise AssertionError("serving never launched the flash kernel")
    if launches != st["n_layers"] * n_rounds:
        raise AssertionError(f"flash launches {launches} != layers x "
                             f"prefill rounds {st['n_layers']} x {n_rounds}")
    if copies:
        raise AssertionError(f"the projections' views reached the flash "
                             f"kernel through {copies} copies")
    if not st["ok"]:
        raise AssertionError("a request got too few tokens or a token "
                             "outside the vocabulary")
    # a separate prefill of the first round, and request 0 generated alone
    _, cfg, engine, prompts = built
    n = engine.batch
    toks = torch.from_numpy(np.stack(prompts[:n])).to(engine.device,
                                                      torch.long)
    cache = T.init_cache(cfg, n, engine.max_len, device=engine.device)
    logits, cache = T.prefill(cfg, engine.params, toks, cache)
    del cache
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite")
    first = logits[:, -1].argmax(-1).tolist()
    got_first = [o[0] for o in st["outputs"][:n]]
    solo = engine.generate([prompts[0]])[0]
    same = solo == st["outputs"][0]
    print(f"{tag} prefill logits finite, max |logit| "
          f"{float(logits.float().abs().max()):.3f}; first tokens "
          f"{'equal' if first == got_first else 'DIFFER'} to their argmax; "
          f"request 0 served {'equals' if same else 'DIFFERS from'} "
          f"request 0 generated alone", flush=True)
    if first != got_first:
        raise AssertionError(f"first tokens {got_first} != argmax {first}")
    if not same:
        raise AssertionError(f"served {st['outputs'][0]} != generated {solo}")
    st["flash_launches"] = launches
    return st, engine, toks


def _kernel_group(name: str) -> str:
    if "flash_bwd" in name:
        return "flash_bwd"
    if "flash_bf16_kernel" in name or "flash_f32_kernel" in name:
        return "flash"
    # cuBLAS: nvjet_* (its Hopper GEMMs), gemv*, cutlass / xmma / sm90_*
    if any(t in name for t in ("nvjet", "gemm", "gemv", "cutlass", "xmma",
                               "sm90_")):
        return "matmul"
    return "other"


def _purify_group(name: str) -> str:
    """Kernel group of a purification: the block-SpGEMM kernel, copies
    (rank-to-rank panels, concatenations, casts), and the rest."""
    if "group_kernel" in name:
        return "block_spgemm"
    if "Memcpy" in name or "copy" in name.lower():
        return "copies"
    return "other"


def _profile_window(torch, fn, group=_kernel_group,
                    names=("flash", "matmul", "other")
                    ) -> tuple[float, dict, int, list]:
    """(wall ms, device ms by kernel group, kernel launches, top kernels)
    of ``fn`` under torch.profiler; one stream, so kernel times add up to
    the busy time.  Only the device is recorded: the host ops' events
    (several for every kernel) would cost the profiler host work and add
    nothing here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups = dict.fromkeys(names, 0.0)
    kernels = []
    for e in prof.key_averages():
        # a span's device range (``repro_torch.obs``) is no kernel
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = e.device_time_total
        groups[group(e.key)] += us / 1e3
        kernels.append((us / 1e3, e.count, e.key))
    n_launches = sum(c for _, c, _ in kernels)
    return wall_ms, groups, n_launches, sorted(kernels, reverse=True)[:6]


def phase_breakdown(torch, T, engine, toks, n_decode: int = 16,
                    tag: str = "[8]") -> None:
    """Phase 8 (and 21 (d)): device time by kernel group and idle share,
    for one prefill round and ``n_decode`` decode steps (greedy,
    synchronised each step as ``serve`` is)."""
    cfg, n = engine.cfg, toks.shape[0]
    cache = T.init_cache(cfg, n, engine.max_len, device=engine.device)
    box = {}

    def prefill():
        box["logits"], _ = T.prefill(cfg, engine.params, toks, cache)

    def decode():
        tok = box["logits"][:, -1].argmax(-1)
        pos = torch.full((n,), toks.shape[1], device=engine.device)
        for _ in range(n_decode):
            logits, _ = T.decode_step(cfg, engine.params, tok[:, None],
                                      cache, pos)
            tok = logits[:, -1].argmax(-1)
            tok.tolist()  # the host reads each step's tokens
            pos = pos + 1

    for name, fn, steps in (("prefill", prefill, 1),
                            ("decode", decode, n_decode)):
        wall, groups, n_launches, top = _profile_window(torch, fn)
        busy = sum(groups.values())
        if busy <= 0:
            raise AssertionError(f"the profiler saw no device time in {name}")
        idle = 1.0 - busy / wall
        per = ", ".join(f"{k} {v / steps:.4f}" for k, v in groups.items())
        unit = "round" if steps == 1 else "step"
        print(f"{tag} {name} ({steps} x): wall {wall / steps:.4f} ms, device "
              f"busy {busy / steps:.4f} ms, idle share {idle:.4f}, "
              f"{n_launches / steps:.0f} kernels per {unit}; device ms per "
              f"{unit}: {per}", flush=True)
        for ms, count, key in top:
            print(f"{tag}   {ms / steps:9.4f} ms  x{count // steps:<5d} "
                  f"{key[:90]}", flush=True)
    del cache, box


def _flash_bound(b, h, hkv, sq, skv, d, itemsize,
                causal=True) -> tuple[float, str]:
    """Least time: 4 d operations per kept (q, k) pair at the bf16 tensor
    rate (causal row i keeps i + 1 keys, sq == skv; a non-causal row all
    skv), or q, k, v read once and o written once at the memory rate."""
    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * skv)
    t_ops = 4.0 * d * pairs / PEAK_BF16_FLOPS
    t_bytes = 2.0 * b * d * (h * sq + hkv * skv) * itemsize / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _flash_bwd_bound(b, h, hkv, sq, skv, d, itemsize,
                     causal=True) -> tuple[float, str]:
    """Least time of the backward: five products (S, dP, dV, dK, dQ) of 2 d
    operations per kept (q, k) pair at the bf16 tensor rate, or q, k, v, o
    and dO read once, dq, dk and dv written once (and the f32 lse read) at
    the memory rate."""
    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * skv)
    t_ops = 5 * 2.0 * d * pairs / PEAK_BF16_FLOPS
    t_bytes = (b * d * (4 * h * sq + 4 * hkv * skv) * itemsize
               + 4 * b * h * sq) / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flash_serve_limit(plain, keys, atol: float, rtol: float):
    """Phase 9's limit on |kernel - plain| for each output of a (b, h, s,
    d) result whose row i keeps ``keys[i]`` keys: atol / sqrt(keys) +
    rtol |plain| (``keys`` a (s,) float tensor)."""
    return atol / keys.sqrt()[:, None] + rtol * plain.float().abs()


def phase_flash_serving_shape(torch, np, FA) -> dict:
    """Phase 9: the kernel at one prefill layer's shape, checked, timed.

    The bf16 tensor-core kernel against the plain version, each output
    within ``flash_serve_limit`` (FLASH_SERVE_TOL_BF16): the limit shrinks
    as 1 / sqrt(the row's keys), so it alone fails a kernel that walks the
    wrong kv tiles of the long late rows, whose outputs are small (a
    stand-in whose rows from 200 on lose their keys past 192 fails it:
    tests/test_torch_flash_attention.py).  Then the SIMT f32 kernel on the
    same inputs cast to f32 against the plain version at 1e-4."""
    b, h, s, d = (FLASH_SHAPE[k] for k in "bhsd")
    rng = np.random.default_rng(SEED + 2)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d),
                                                    dtype=np.float32))
               .to("cuda", torch.bfloat16) for _ in range(3))
    keys = torch.arange(1, s + 1, device="cuda", dtype=torch.float32)
    errs = {}
    for dtype, tol in (("bfloat16", FLASH_SERVE_TOL_BF16),
                       ("float32", dict(atol=FLASH_TOL["float32"],
                                        rtol=FLASH_TOL["float32"]))):
        x = [t.to(getattr(torch, dtype)) for t in (q, k, v)]
        got = FA.flash_attention(*x, causal=True)
        plain = FA.flash_attention_plain(*x, causal=True)
        diff = (got.float() - plain.float()).abs()
        if dtype == "float32":  # one limit for every row
            keys = torch.ones_like(keys)
        ratio = diff / flash_serve_limit(plain, keys, **tol)
        errs[dtype] = float(diff.max())
        late = slice(3 * s // 4, None)  # the last quarter of the rows
        print(f"[9] {dtype} kernel vs plain: max |err| {errs[dtype]:.3e} "
              f"(last quarter of rows {float(diff[:, :, late].max()):.3e}); "
              f"worst |err| / limit {float(ratio.max()):.4f} (last quarter "
              f"{float(ratio[:, :, late].max()):.4f})", flush=True)
        if not float(ratio.max()) <= 1.0:
            raise AssertionError(f"flash kernel vs plain at the serving "
                                 f"shape, {dtype}: max |err| {errs[dtype]}")
        del x, got, plain, diff, ratio
    err = errs["bfloat16"]
    ms = _time_ms(lambda: FA.flash_attention(q, k, v, causal=True), reps=10,
                  warmup=2)
    plain_ms = _time_ms(lambda: FA.flash_attention_plain(q, k, v,
                                                         causal=True),
                        reps=3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _time_ms(lambda: sdpa(q, k, v, is_causal=True), reps=10,
                          warmup=2)
    bound_ms, bound_by = _flash_bound(b, h, h, s, s, d, 2)
    tflops = 4.0 * d * b * h * (s * (s + 1) // 2) / ms / 1e9
    print(f"[9] flash at b={b} h={h} s={s} d={d} bf16 causal: kernel vs "
          f"plain max |err| {err:.3e}; times (ms, median of CUDA events): "
          f"kernel {ms:.4f}  plain {plain_ms:.4f}  library(sdpa) "
          f"{library_ms:.4f}  bound {bound_ms:.4f} ({bound_by}); kernel "
          f"{tflops:.3f} TFLOP/s on the kept pairs", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


# (engine, mesh, l, c_layout): the paper's engines on meshes of ranks
ENGINE_CASES = (
    ("cannon", dict(p=2), None, "2d"),
    ("onesided", dict(p=2), None, "2d"),
    ("onesided", dict(p_r=2, p_c=4), None, "2d"),
    ("gather", dict(p=2), None, "2d"),
    ("gather", dict(p_r=2, p_c=4), None, "2d"),
    ("twofive", dict(p_r=2, p_c=4), None, "2d"),  # pull, forced L = 2
    ("twofive", dict(p=4), 4, "2d"),  # pull, L = 4
    ("twofive", dict(p=2, l=2), None, "2d"),  # stacked
    ("twofive", dict(p=2, l=2), None, "scatter"),
    ("twofive", dict(p=2, l=4), None, "2d"),  # stacked, uneven chunks
)
SHARDED_P_TOL = 1e-3  # ||P_sharded - P_single||_F / ||P_single||_F


def _psum_bytes(n: int) -> float:
    """Per-rank bytes of the sweep's psum of three f32 partials over n
    ranks (all-reduce: 2 (n - 1) / n of the payload)."""
    return 2.0 * (n - 1) / n * 3 * 4


def _f64_product(m):
    """M . M in float64 (dense ``torch.matmul`` on the card), in block
    layout on the host."""
    md = m.to_dense().double()
    return (md @ md).reshape(NB, BS, NB, BS).permute(0, 2, 1, 3).cpu()


def _f64_err(c, exact) -> float:
    return float((c.blocks.cpu().double() - exact).abs().max())


def phase_engines(torch, B, E, CV, T, lm, K, plan, mesh_mod) -> int:
    """Phase 10: every engine at full width against the single-device
    kernel result; returns the kernel launches of the phase.

    H.H is held to TOL (1e-5 + 1e-5 |ref|).  At full fill (X.X) each entry
    sums 11,776 f32 products, and an engine that adds its k-panels in
    another order than the single-device kernel differs from it by their
    rounding, about u sqrt(n) |entry| (the first chip run of the engines
    measured 1.6e-4 - 1.8e-4, beyond TOL); so there both are held against
    the float64 product, and an engine's max error may be at most twice
    the single-device kernel's (one missing block product moves an entry
    by ~0.2)."""
    h = B.random_bsm(SEED, nb=NB, bs=BS, occupancy=OCC, pattern=PATTERN,
                     symmetric=True, device="cuda")
    x = B.random_bsm(SEED + 1, nb=NB, bs=BS, pattern="dense", device="cuda")
    total, bad = 0, []
    for name, m in (("H.H", h), ("X.X", x)):
        want = B.filter_bsm(E.multiply_reference(
            m, m, threshold=THRESHOLD, backend="cuda"), THRESHOLD)
        plan.clear_cache()  # the oracle's cached product list (3.8 GB at
        torch.cuda.empty_cache()  # full fill) is not the engines' memory
        exact = single_err = None
        if name == "X.X":
            exact = _f64_product(m)
            single_err = _f64_err(want, exact)
            torch.cuda.empty_cache()
            print(f"[10] X.X single-device kernel vs float64: max |err| "
                  f"{single_err:.3e}", flush=True)
        for engine, mk, l, layout in ENGINE_CASES:
            mesh = mesh_mod.make_spgemm_mesh(**mk, device="cuda")
            # the transport multiply resolves (transport=None: "auto")
            tr = plan.resolve_transport(None, m, m, mesh, engine, l)
            vol = CV.plan_volume(plan.plan_multiply(mesh, engine, l), NB, BS,
                                 itemsize=4, c_layout=layout,
                                 transport=tr).total
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            T.reset_bytes()
            K.launches, calls0 = 0, lm.calls
            t0 = time.perf_counter()
            c = E.multiply(m, m, mesh, engine=engine, l=l, c_layout=layout,
                           backend="cuda", threshold=THRESHOLD)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            launches, calls = K.launches, lm.calls - calls0
            moved, peak = T.bytes_moved(), torch.cuda.max_memory_allocated()
            good, err = _close(c.blocks, want.blocks, TOL["float32"])
            extra = ""
            if exact is not None:
                err64 = _f64_err(c, exact)
                good = err64 <= 2.0 * single_err
                extra = f", vs float64 {err64:.3e} (limit {2 * single_err:.3e})"
            same_mask = bool(torch.equal(c.mask, want.mask))
            total += launches
            tag = (f"{name} {engine} {dict(mesh.shape)}"
                   + (f" L={l}" if l else "") + f" C {layout}")
            print(f"[10] {tag}: wall {wall_ms:.3f} ms, kernel launches "
                  f"{launches}, local multiplies {calls} (3 host syncs "
                  f"each), bytes per rank {moved:.0f} (plan_volume, "
                  f"{tr.mode} transport: {vol:.0f}), peak memory {peak / 2**30:.3f} GiB, masks "
                  f"{'equal' if same_mask else 'DIFFER'}, max |err| vs the "
                  f"single-device kernel {err:.3e}{extra}", flush=True)
            if not (good and same_mask) or moved != vol or launches == 0:
                bad.append((tag, err, same_mask, moved, vol, launches))
            del c
        del want, exact
    del h, x
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"engines disagree: {bad}")
    return total


def phase_sharded_purify(torch, K, CV, plan, mesh_mod, purify,
                         single: dict) -> tuple[int, dict]:
    """Phase 11: the sharded purification (p 2, l 2, twofive) through the
    entry point, against phase 4's gates and P; returns its launches and
    the report (with P) for phase 13."""
    torch.cuda.reset_peak_memory_stats()
    K.launches = 0
    report = purify.run(PURIFY_ARGV + ["--p", "2", "--l", "2", "--engine",
                                       "twofive"])
    launches = K.launches
    r, r1 = report["runs"][0], single["runs"][0]
    p1, p2 = single["p"], report["p"]
    diff = (p2.blocks - p1.blocks).float()
    rel = float(diff.norm() / p1.blocks.float().norm())
    mesh = mesh_mod.make_spgemm_mesh(p=2, l=2, device="cuda")
    vol = CV.plan_volume(plan.plan_multiply(mesh, "twofive"), NB, BS,
                         itemsize=4).total
    want_sweep = 2.0 * vol + _psum_bytes(4)
    per_sweep = r["bytes_per_rank"] / r["iterations"]
    print(f"[11] sharded purification on {report['mesh']} ({report['ranks']}"
          f" ranks, {report['engine']}): {r['iterations']} sweeps (phase 4: "
          f"{r1['iterations']}), converged {r['converged']}, wall "
          f"{r['wall_s']:.3f} s (phase 4: {r1['wall_s']:.3f} s), kernel "
          f"launches {launches}, local multiplies {r['local_multiplies']}, "
          f"bytes per rank per sweep {per_sweep:.0f} (2 x plan_volume + "
          f"psum: {want_sweep:.0f}), trace(P) {r['trace']:.4f} vs "
          f"{report['n_occ']} (|err| {r['trace_err']:.3e}), max|P^2-P| "
          f"{r['idempotency']:.3e}, max |P - P_single| "
          f"{float(diff.abs().max()):.3e}, relative Frobenius {rel:.3e}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    if launches == 0:
        raise AssertionError("the sharded purification never launched the "
                             "kernel")
    if not (report["ok"] and r["converged"]):
        raise AssertionError(f"sharded purification failed: {r}")
    if r["idempotency"] > IDEMPOTENCY_TOL:
        raise AssertionError(f"P is no projector: {r['idempotency']}")
    if abs(r["iterations"] - r1["iterations"]) > 1:
        raise AssertionError(f"{r['iterations']} sweeps against phase 4's "
                             f"{r1['iterations']}")
    if not rel <= SHARDED_P_TOL:
        raise AssertionError(f"sharded P vs single-device P: {rel}")
    if per_sweep != want_sweep:
        raise AssertionError(f"bytes per sweep {per_sweep} != {want_sweep}")
    return launches, report


def phase_purify_breakdown(torch, B, SI, mesh_mod) -> None:
    """Phase 12: where the purification's time goes, single-device and
    sharded on (l 2, r 2, c 2): one more chain of each under
    torch.profiler (device ms by kernel group, kernels, idle share; the
    profiler adds host time, so the idle share is an upper bound)."""
    h = B.random_bsm(SEED, nb=NB, bs=BS, occupancy=OCC, pattern=PATTERN,
                     symmetric=True, device="cuda")
    mesh = mesh_mod.make_spgemm_mesh(p=2, l=2, device="cuda")
    kw = dict(threshold=THRESHOLD, filter_eps=FILTER_EPS, max_iter=100,
              tol=1e-6, sync_every=4, backend="cuda")
    for name, x in (("single-device", h), ("sharded (2,2,2)",
                                           B.shard_bsm(h, mesh))):
        wall, groups, n, top = _profile_window(
            torch, lambda: SI.density_matrix(x, 0.0, **kw),
            group=_purify_group, names=("block_spgemm", "copies", "other"))
        busy = sum(groups.values())
        if busy <= 0:
            raise AssertionError(f"the profiler saw no device time ({name})")
        per = ", ".join(f"{k} {v:.1f}" for k, v in groups.items())
        print(f"[12] {name} purification under the profiler: wall "
              f"{wall:.1f} ms, device busy {busy:.1f} ms (idle share "
              f"{1.0 - busy / wall:.4f}), {n} kernels; device ms: {per}",
              flush=True)
        for ms, count, key in top:
            print(f"[12]   {ms:10.1f} ms  x{count:<6d} {key[:90]}",
                  flush=True)
    del h
    torch.cuda.empty_cache()


def _p_gates(torch, report_p, n_occ: int, single_p) -> tuple[float, float,
                                                             float]:
    """(|trace(P) - n_occ|, max |P^2 - P|, relative Frobenius distance to
    phase 4's P) of a gathered P, in float64 on the card."""
    pd = report_p.to_dense().double()
    trace = float(torch.diagonal(pd).sum())
    idem = float((pd @ pd - pd).abs().max())
    del pd
    diff = (report_p.blocks - single_p.blocks).float()
    rel = float(diff.norm() / single_p.blocks.float().norm())
    return abs(trace - n_occ), idem, rel


def _sweep_syncs(torch, fn):
    """``fn()`` under CUDA's sync debug mode; returns (its result, the
    host syncs it made)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def phase_dbcsr(torch, B, E, CV, SI, TR, K, plan, mesh_mod, D, purify,
                single: dict, sharded: dict) -> int:
    """Phase 13: DBCSR's sparse wire and block distributions on H2O-DFT-LS
    (``configs/dbcsr_benchmarks.py``) at nb = 512: compressed single
    multiplies on every engine of phase 10, then phase 11's chain on
    (l 2, r 2, c 2) under a forecast envelope, with compressed panels, and
    under the randomized and nnz-greedy assignments.  Returns the chains'
    kernel launches."""
    backend = sharded["backend"]
    h = B.random_bsm(SEED, nb=NB, bs=BS, occupancy=OCC, pattern=PATTERN,
                     symmetric=True, device="cuda")
    mask_np = B.host_mask(h)
    bad = []
    # --- 13.1: compressed against dense, one multiply per engine ---------
    for engine, mk, l, layout in ENGINE_CASES:
        mesh = mesh_mod.make_spgemm_mesh(**mk, device="cuda")
        pl = plan.plan_multiply(mesh, engine, l)
        caps = TR.capacities_for(mask_np, mask_np, pl)
        auto = plan.resolve_transport("auto", h, h, mesh, engine, l).mode
        out, moved, want, wall = {}, {}, {}, {}
        # in turns (dense, compressed, compressed, dense); walls averaged
        for mode in ("dense", "compressed", "compressed", "dense"):
            tr = plan.resolve_transport(mode, h, h, mesh, engine, l)
            want[mode] = CV.plan_volume(pl, NB, BS, itemsize=4,
                                        c_layout=layout, transport=tr).total
            torch.cuda.synchronize()
            TR.reset_bytes()
            t0 = time.perf_counter()
            c = E.multiply(h, h, mesh, engine=engine, l=l, c_layout=layout,
                           backend=backend, threshold=THRESHOLD,
                           transport=mode)
            torch.cuda.synchronize()
            wall[mode] = wall.get(mode, 0.0) + 500.0 * (time.perf_counter()
                                                        - t0)
            if mode in out and not (torch.equal(c.mask, out[mode].mask) and
                                    torch.equal(c.blocks, out[mode].blocks)):
                bad.append((engine, mk, l, layout, mode, "not repeatable"))
            out[mode] = c
            if moved.setdefault(mode, TR.bytes_moved()) != TR.bytes_moved():
                bad.append((engine, mk, l, layout, mode, TR.bytes_moved()))
            del c
        same = (torch.equal(out["dense"].mask, out["compressed"].mask)
                and torch.equal(out["dense"].blocks, out["compressed"].blocks))
        tag = (f"{engine} {dict(mesh.shape)}" + (f" L={l}" if l else "")
               + f" C {layout}")
        print(f"[13] H.H {tag}: capacities (A, B) {caps[0]}, {caps[1]} of "
              f"{caps[2]}, {caps[3]} blocks per panel; auto resolves "
              f"{auto}; bytes per rank compressed {moved['compressed']:.0f}"
              f" (plan_volume {want['compressed']:.0f}) vs dense "
              f"{moved['dense']:.0f} (plan_volume {want['dense']:.0f}), "
              f"ratio {moved['compressed'] / moved['dense']:.4f}; wall (mean "
              f"of 2, in turns) compressed {wall['compressed']:.3f} ms, dense "
              f"{wall['dense']:.3f} ms; C "
              f"{'bitwise equal' if same else 'DIFFERS'}", flush=True)
        if (not same or auto != TR.resolve_mode("auto", *caps)
                or any(moved[m] != want[m] for m in want)):
            bad.append((tag, same, auto, moved, want))
        del out
    if bad:
        raise AssertionError(f"compressed transport: {bad}")
    torch.cuda.empty_cache()

    # --- 13.2-13.4: phase 11's chain, the same H on (l 2, r 2, c 2) -------
    mesh = mesh_mod.make_spgemm_mesh(p=2, l=2, device="cuda")
    pl = plan.plan_multiply(mesh, "twofive")
    kw = dict(engine="twofive", threshold=THRESHOLD, filter_eps=FILTER_EPS,
              max_iter=100, tol=1e-6, sync_every=4, backend=backend)
    want_p, want_it = sharded["p"], sharded["runs"][0]["iterations"]
    single_it = single["runs"][0]["iterations"]
    launches = 0

    def chain(label, x, **extra):
        nonlocal launches
        torch.cuda.synchronize()
        TR.reset_bytes()
        K.launches = 0
        t0 = time.perf_counter()
        p, stats = SI.density_matrix(x, 0.0, **kw, **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = K.launches
        launches += n
        print(f"[13] chain {label}: {stats.iterations} sweeps, wall "
              f"{wall:.3f} s, kernel launches {n} ({n / stats.iterations:.1f}"
              f" per sweep), bytes per rank per sweep "
              f"{TR.bytes_moved() / stats.iterations:.0f}", flush=True)
        if n == 0 or not stats.converged:
            raise AssertionError(f"chain {label}: launches {n}, {stats}")
        return B.unshard_bsm(p), stats, TR.bytes_moved()

    hs = B.shard_bsm(h, mesh)
    plan.clear_cache()
    p_env, st_env, bytes_env = chain("envelope, transport auto", hs,
                                     envelope="auto", transport="auto")
    # the chain's entering operand, as density_matrix builds it (H - 0 I,
    # unit-scaled): its envelope is the chain's, a cache hit
    x = hs.add(B.sharded_identity(NB, BS, mesh).scale(-0.0))
    x = x.scale(1.0 / x.frobenius_norm())
    hits = plan.cache_stats()["envelope_hits"]
    env = plan.get_envelope(B.host_mask(x), B.host_array(x.gather(x.norms)),
                            sweeps=kw["max_iter"], threshold=THRESHOLD,
                            filter_eps=FILTER_EPS, bs=BS)
    if plan.cache_stats()["envelope_hits"] != hits + 1:
        raise AssertionError("the chain's envelope is not the forecast of "
                             "its entering operand")
    tr_auto = env.transport(mesh, "twofive", None, "auto")
    tr_comp = env.transport(mesh, "twofive", None, "compressed")
    sm = env.sweep_masks
    fixed = next((i for i in range(1, len(sm)) if sm[i] is sm[i - 1]), None)
    print(f"[13] envelope: forecast {st_env.forecast_s:.3f} host s "
          f"({len(sm)} sweeps, symbolic fixed point after sweep {fixed}), "
          f"cube {float(env.cube.mean()):.4f} full, product-list capacity "
          f"per rank {env.device_capacity(mesh, 'twofive')}, "
          f"panel capacities (A, B) {tr_comp.cap_a}, {tr_comp.cap_b}; auto "
          f"resolves {tr_auto.mode}", flush=True)
    # the realized sweeps against the forecast, and the host syncs of a
    # sweep, on the same chain driven sweep by sweep
    sweep = SI.get_sweep_program(
        x, mesh, engine="twofive", threshold=THRESHOLD,
        filter_eps=FILTER_EPS, backend=backend, envelope=env,
        transport="auto")
    ident = B.sharded_identity(NB, BS, mesh)
    xb, xm, xn = x.blocks, x.mask, x.norms
    syncs, escaped = [], []
    for s in range(st_env.iterations):
        (xb, xm, xn, _, _), n = _sweep_syncs(
            torch, lambda: sweep(xb, xm, xn, ident.blocks, ident.mask))
        syncs.append(n)
        realized = B.host_mask(B.ShardedBSM(xb, xm, xn, mesh))
        if (realized & ~env.sweep_masks[s]).any():
            escaped.append(s)
    del xb, xm, xn, x, sweep
    print(f"[13] realized sweep masks inside the forecast: "
          f"{st_env.iterations - len(escaped)} of {st_env.iterations}; host "
          f"syncs inside a sweep {min(syncs)}-{max(syncs)} (16 local "
          f"multiplies), plus one residual read per 4 sweeps", flush=True)
    same_env = torch.equal(p_env.blocks, want_p.blocks) and torch.equal(
        p_env.mask, want_p.mask)
    vol_auto = CV.plan_volume(pl, NB, BS, itemsize=4, transport=tr_auto).total
    if (escaped or not same_env or st_env.iterations != want_it
            or bytes_env != st_env.iterations * (2 * vol_auto
                                                 + _psum_bytes(4))):
        raise AssertionError(f"enveloped chain: escaped {escaped}, P equal "
                             f"{same_env}, {st_env.iterations} vs {want_it} "
                             f"sweeps, bytes {bytes_env}")
    del p_env
    p_c, st_c, bytes_c = chain("envelope, transport compressed", hs,
                               envelope="auto", transport="compressed")
    vol_c = CV.plan_volume(pl, NB, BS, itemsize=4, transport=tr_comp).total
    want_sweep = 2.0 * vol_c + _psum_bytes(4)
    vol_d = CV.plan_volume(pl, NB, BS, itemsize=4).total
    same_c = torch.equal(p_c.blocks, want_p.blocks) and torch.equal(
        p_c.mask, want_p.mask)
    print(f"[13] compressed chain: P {'bitwise equal' if same_c else 'DIFFERS'}"
          f" to phase 11's; bytes per rank per sweep "
          f"{bytes_c / st_c.iterations:.0f} (2 x plan_volume + psum: "
          f"{want_sweep:.0f}; dense {2.0 * vol_d + _psum_bytes(4):.0f})",
          flush=True)
    if (not same_c or st_c.iterations != want_it
            or bytes_c / st_c.iterations != want_sweep):
        raise AssertionError(f"compressed chain: P equal {same_c}, "
                             f"{st_c.iterations} sweeps, bytes {bytes_c}")
    del p_c, hs
    torch.cuda.empty_cache()
    counts = D.product_counts(mask_np, mask_np)
    imb = {"identity": D.assignment_imbalance(counts, mesh)}
    n_occ = single["n_occ"]
    for mode in ("randomized", "nnz_greedy"):
        ha = B.shard_bsm(h, mesh, assignment=mode)
        imb[mode] = D.assignment_imbalance(counts, mesh, ha.assignment)
        p_a, st_a, _ = chain(f"assignment {mode}", ha)
        tr_err, idem, rel = _p_gates(torch, p_a, n_occ, single["p"])
        print(f"[13] {mode}: |trace(P) - {n_occ}| {tr_err:.3e}, "
              f"max|P^2-P| {idem:.3e}, relative Frobenius to phase 4's P "
              f"{rel:.3e}, sweeps {st_a.iterations} (phase 4: {single_it})",
              flush=True)
        if (abs(st_a.iterations - single_it) > 1
                or tr_err > purify.TRACE_TOL or idem > IDEMPOTENCY_TOL
                or not rel <= SHARDED_P_TOL):
            raise AssertionError(f"chain under {mode}: {st_a.iterations} "
                                 f"sweeps, {tr_err}, {idem}, {rel}")
        del ha, p_a
        torch.cuda.empty_cache()
    print("[13] product-load imbalance (max / mean over the 4 (r, c) "
          "ranks of H.H's mask product): " + ", ".join(
              f"{k} {v:.4f}" for k, v in imb.items()), flush=True)
    return launches


TUNER_TOP_K = 3  # the tuner's default: trials of the analytic top three
TUNER_REPS = 2  # the tuner's default: timed rounds per trial
# phase 14.4: the default group (None, 4 x 4 for 23 x 23 blocks) and two
# smaller ones the kernel takes; the tuner ranks the default only
# (``tile_candidates``), and these times are why
GROUP_LAYOUTS = (None, (2, 2), (1, 1))


def _label(dec) -> str:
    """A decision's label without its source tag."""
    return dec.label.rsplit("[", 1)[0]


def phase_tuner(torch, B, E, TR, K, S, plan, mesh_mod, tuner, purify,
                single: dict) -> int:
    """Phase 14: the pattern-aware tuner on H2O-DFT-LS at nb = 512 on a 2D
    mesh (r 2, c 2) of ranks on the card (cannon, onesided, gather and
    twofive L = 4 to choose from).  14.0 the card's rank-to-rank copy
    rate; 14.1 ``multiply(H, H, mesh, engine="auto")`` on a fresh
    database; 14.2 the decision again (a cache hit), then from the
    database file after ``clear_cache``; 14.3 the purification entry point
    with ``--engine auto --tuning-db`` cold and warm; 14.4 the kernel
    against its plain version at the default group layout and two smaller
    ones (the tuner ranks the default only).
    Returns the kernel launches of 14.3's two chains."""
    import tempfile

    h = B.random_bsm(SEED, nb=NB, bs=BS, occupancy=OCC, pattern=PATTERN,
                     symmetric=True, device="cuda")
    mesh = mesh_mod.make_spgemm_mesh(p=2, device="cuda")

    # --- 14.0: wire bytes per rank of one dense panel hop over its time ---
    hs = B.shard_bsm(h, mesh)
    state = (list(hs.blocks), list(hs.mask))
    TR.reset_bytes()
    TR.permute(mesh, state, "c", ((0, 1), (1, 0)))
    per_rank = TR.bytes_moved()
    hop_ms = _time_ms(lambda: TR.permute(mesh, state, "c",
                                         ((0, 1), (1, 0))), reps=7)
    rate = per_rank / (hop_ms / 1e3)
    print(f"[14] copy rate: one dense panel hop on (r 2, c 2), "
          f"{per_rank:.0f} bytes per rank in {hop_ms:.4f} ms (4 ranks in "
          f"turn): {rate:.6g} bytes per rank per second (model COPY_BW "
          f"{tuner.model.COPY_BW:.6g})", flush=True)
    del hs, state

    # --- 14.1: engine="auto" on a fresh database ---------------------------
    want = B.filter_bsm(E.multiply_reference(h, h, threshold=THRESHOLD,
                                             backend="cuda"), THRESHOLD)
    plan.clear_cache()
    torch.cuda.empty_cache()
    db_dir = tempfile.mkdtemp(prefix="tuning-db-")
    path = f"{db_dir}/multiply.json"
    tuner.set_default_db(path)
    K.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c = E.multiply(h, h, mesh, engine="auto", threshold=THRESHOLD)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, run, st = K.launches, tuner.last_run(), plan.cache_stats()
    dec = tuner.autotune(h, h, mesh, threshold=THRESHOLD)
    print(f"[14] 14.1 multiply(H, H, engine='auto') on (r 2, c 2): "
          f"{run.candidates} candidates, {run.pruned} pruned (Eq. 6, "
          f"{tuner.model.device_memory_budget(mesh) / 1e9:.3f} GB per "
          f"rank), analytic stage {run.analytic_s:.3f} host s, "
          f"{st['tuner_trials']} trials, wall {wall:.3f} s with the trials, "
          f"kernel launches {launches}", flush=True)
    for label, seconds, err in run.trials:
        print(f"[14]   trial {label}: {seconds * 1e3:.4f} ms"
              + (f" ERROR {err}" if err else ""), flush=True)
    print(f"[14]   winner {dec.label} (measured {dec.measured_s * 1e3:.4f} "
          f"ms)", flush=True)
    # the dense-panel identity gather, named, timed as a trial is (a
    # warm-up, then the minimum of TUNER_REPS): the gap to the pick
    named = []
    for rep in range(1 + TUNER_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        E.multiply(h, h, mesh, engine="gather", backend="cuda",
                   transport="dense", threshold=THRESHOLD)
        torch.cuda.synchronize()
        if rep:
            named.append(time.perf_counter() - t0)
    print(f"[14]   named gather/cuda: {min(named) * 1e3:.4f} ms, the pick "
          f"{dec.measured_s / min(named):.4f}x of it", flush=True)
    good, err = _close(c.blocks, want.blocks, TOL["float32"])
    same_mask = bool(torch.equal(c.mask, want.mask))
    cuda_trials = any("/cuda" in label for label, _, _ in run.trials)
    if not (good and same_mask):
        raise AssertionError(f"tuned C: masks equal {same_mask}, max |err| "
                             f"{err}")
    if any(e for _, _, e in run.trials) or any(
            "/stacks" in label for label, _, _ in run.trials):
        raise AssertionError(f"trials: {run.trials}")
    if (cuda_trials and launches == 0) or not (
            1 <= st["tuner_trials"] <= TUNER_TOP_K):
        raise AssertionError(f"launches {launches}, counters {st}")
    del c

    # --- 14.2: the decision cache, then the database file -------------------
    E.multiply(h, h, mesh, engine="auto", threshold=THRESHOLD)
    st2 = plan.cache_stats()
    if (st2["tuner_hits"] != st["tuner_hits"] + 2
            or st2["tuner_trials"] != st["tuner_trials"]):
        raise AssertionError(f"repeat: {st} -> {st2}")
    plan.clear_cache()
    tuner.set_default_db(path)
    c = E.multiply(h, h, mesh, engine="auto", threshold=THRESHOLD)
    st3 = plan.cache_stats()
    warm = tuner.autotune(h, h, mesh, threshold=THRESHOLD)
    print(f"[14] 14.2 repeat: tuner hits {st['tuner_hits']} -> "
          f"{st2['tuner_hits']} (the multiply and the decision read), "
          f"trials {st2['tuner_trials']}; after clear_cache from the "
          f"database: {warm.label}, trials {st3['tuner_trials']}, misses "
          f"{st3['tuner_misses']}", flush=True)
    if (warm.source != "db" or _label(warm) != _label(dec)
            or st3["tuner_trials"] != 0 or st3["tuner_misses"] != 0
            or not torch.equal(c.mask, want.mask)):
        raise AssertionError(f"warm database: {warm}, {st3}")
    del c, want
    plan.clear_cache()
    torch.cuda.empty_cache()

    # --- 14.3: the entry point, --engine auto --tuning-db, cold and warm ---
    argv = PURIFY_ARGV + ["--p", "2", "--l", "1", "--engine", "auto",
                          "--tuning-db", f"{db_dir}/purify.json"]
    r1 = single["runs"][0]
    total = 0
    engines = []
    for name in ("cold", "warm"):
        K.launches = 0
        report = purify.run(argv)
        total += K.launches
        r, t = report["runs"][0], report["tuner"]
        engines.append((report["engine"], r["l"]))
        tr_err, idem, rel = _p_gates(torch, report["p"], report["n_occ"],
                                     single["p"])
        print(f"[14] 14.3 purify --engine auto --tuning-db ({name}): engine "
              f"{report['engine']}" + ("" if r["l"] is None else
                                      f" L={r['l']}")
              + f", tuner {t['tuner_hits']}h/{t['tuner_misses']}m/"
              f"{t['tuner_trials']}t, {r['iterations']} sweeps (phase 4: "
              f"{r1['iterations']}), wall {r['wall_s']:.3f} s, kernel "
              f"launches {K.launches}, |trace(P) - {report['n_occ']}| "
              f"{tr_err:.3e}, max|P^2-P| {idem:.3e}, relative Frobenius to "
              f"phase 4's P {rel:.3e}", flush=True)
        if name == "cold":
            run = tuner.last_run()
            for label, seconds, err in run.trials:
                print(f"[14]   chain trial {label}: {seconds * 1e3:.4f} ms"
                      + (f" ERROR {err}" if err else ""), flush=True)
            bad = t["tuner_misses"] != 1 or not (
                1 <= t["tuner_trials"] <= TUNER_TOP_K) or any(
                e for _, _, e in run.trials)
        else:
            bad = t["tuner_trials"] != 0 or t["tuner_misses"] != 0 \
                or engines[1] != engines[0]
        if (bad or not (report["ok"] and r["converged"])
                or K.launches == 0
                or abs(r["iterations"] - r1["iterations"]) > 1
                or idem > IDEMPOTENCY_TOL or not rel <= SHARDED_P_TOL):
            raise AssertionError(f"purify {name}: {t}, {r['iterations']} "
                                 f"sweeps, {tr_err}, {idem}, {rel}")
        del report
        torch.cuda.empty_cache()

    # --- 14.4: the kernel at three group layouts, on H.H --------------------
    ok = S.pair_cube(h.mask, h.mask, h.norms, h.norms, THRESHOLD)
    stacks, _n = plan.get_product_stacks(ok)
    plain = K.block_spgemm_stacks_plain(h.blocks, h.blocks, stacks, ni=NB,
                                        nj=NB)
    times = []
    for g in GROUP_LAYOUTS:
        tile = K.kernel_tile(BS, BS, group=g)
        gm = K.group_masks(stacks, ni=NB, nk=NB, nj=NB, g_r=tile.g_r,
                           g_c=tile.g_c)

        def kernel():
            return K.block_spgemm_groups(h.blocks, h.blocks, gm, ni=NB,
                                         nj=NB)

        good, err = _close(kernel(), plain, TOL["float32"])
        ms = _time_ms(kernel, reps=7, warmup=2)
        times.append((tile.g_r, tile.g_c, ms))
        print(f"[14] 14.4 group {tile.g_r} x {tile.g_c}"
              + (" (default)" if g is None else "")
              + f": {int((gm.groups >= 0).sum())} active groups, {ms:.4f} ms, max "
              f"|err| vs plain {err:.3e}", flush=True)
        if not good:
            raise AssertionError(f"group {g}: max |err| {err}")
    print("[14] 14.4 kernel ms by group layout: " + ", ".join(
        f"{r} x {c} {ms:.4f}" for r, c, ms in times), flush=True)
    del h, ok, stacks, plain
    plan.clear_cache()
    torch.cuda.empty_cache()
    return total


# phase 15: a screened three-center tensor (ij|k) contracted with a (k, l)
# operand, at H2O-DFT-LS's block size and bench_tensor.py's occupancy; nb
# cut to 32 because the dense block grid holds all nb^3 bs^3 words (nb 64
# would take 12.8 GB per operand)
TENSOR_NB, TENSOR_OCC = 32, 0.10
# phase 16: one MoE layer of deepseek-moe-16b at full width on 8 x 256
# tokens; spgemm against dense within the reference's bf16 tolerance, and
# the memory it may take above the resident weights
MOE_SHAPE = (8, 256)
MOE_TOL = 3e-2
MOE_MEM_LIMIT = 4 * 2**30
# phase 17: deepseek-moe-16b served at full width and depth, 8 requests of
# 256-token prompts + 32 new tokens through 8 slots, under spgemm and tp
MOE_SERVE_ARGV = ["--arch", "deepseek-moe-16b", "--batch", "8",
                  "--prompt-len", "256", "--max-new", "32", "--max-len",
                  "320", "--queue", "8", "--seed", str(SEED)]


def phase_tensor(torch, K, S, plan, TN) -> dict:
    """Phase 15: ``contract("ijk,kl->ijl", T, B, backend="cuda")`` on a
    screened three-center tensor, against the plain backend (TOL) and a
    dense f32 ``torch.einsum`` of the densified operands; the kernel on the
    matricized (529 x 23) x (23 x 23) blocks timed beside its bound, its
    plain version and the einsum."""
    nb, bs = TENSOR_NB, BS
    t = TN.random_tensor(SEED, (nb,) * 3, bs, occupancy=TENSOR_OCC,
                         pattern=PATTERN, device="cuda")
    b = TN.random_tensor(SEED + 1, (nb, nb), bs, occupancy=0.15,
                         pattern=PATTERN, device="cuda")
    plan.clear_cache()
    K.launches = 0
    got = TN.contract("ijk,kl->ijl", t, b, backend="cuda")
    launches = K.launches
    plain = TN.contract("ijk,kl->ijl", t, b, backend="stacks")
    good, err = _close(got.blocks, plain.blocks, TOL["float32"])
    if not (good and torch.equal(got.mask, plain.mask)):
        raise AssertionError(f"contract cuda vs stacks: max |err| {err}")
    td, bd = t.to_dense(), b.to_dense()
    dense = torch.einsum("ijk,kl->ijl", td, bd)
    good_d, err_d = _close(got.to_dense(), dense, TOL["float32"])
    if not good_d:
        raise AssertionError(f"contract vs dense einsum: max |err| {err_d}")
    if launches != 1:
        raise AssertionError(f"the contraction launched the kernel "
                             f"{launches} times, not once")
    del got, plain, dense
    ma, mb = TN.matricize(t, (0, 1), (2,)), TN.matricize(b, (0,), (1,))
    ok = S.pair_cube(ma.mask, mb.mask, ma.norms, mb.norms, 0.0)
    stacks, n = plan.get_product_stacks(ok)
    tile = K.kernel_tile(ma.bs_r, mb.bs_c)
    gm = K.group_masks(stacks, ni=ma.nb_r, nk=ma.nb_c, nj=mb.nb_c,
                       g_r=tile.g_r, g_c=tile.g_c)

    def kernel():
        return K.block_spgemm_groups(ma.blocks, mb.blocks, gm, ni=ma.nb_r,
                                     nj=mb.nb_c)

    ms = _time_ms(kernel, reps=7, warmup=2)
    plain_ms = _time_ms(lambda: K.block_spgemm_stacks_plain(
        ma.blocks, mb.blocks, stacks, ni=ma.nb_r, nj=mb.nb_c), reps=3)
    library_ms = _time_ms(lambda: torch.einsum("ijk,kl->ijl", td, bd),
                          reps=5)
    bound_ms, bound_by = _bound_rect(ok, ma.bs_r, ma.bs_c, mb.bs_c, 4,
                                     PEAK_F32_FLOPS)
    print(f"[15] contract ijk,kl->ijl: T {nb}^3 blocks of {bs}^3 "
          f"(occupancy {float(t.occupancy()):.4f}, {PATTERN}), B {nb}^2 "
          f"(occupancy {float(b.occupancy()):.4f}); matricized "
          f"({ma.nb_r} x {ma.nb_c}) blocks of {ma.bs_r} x {ma.bs_c} times "
          f"({mb.nb_r} x {mb.nb_c}) of {mb.bs_r} x {mb.bs_c}, {n} products, "
          f"group {tile.g_r} x {tile.g_c} x {tile.n_sub_r * tile.n_sub_c} "
          f"sub-tiles; kernel launches {launches}; max |err| vs stacks "
          f"{err:.3e}, vs dense einsum {err_d:.3e}", flush=True)
    print(f"[15] times (ms, median of CUDA events): kernel {ms:.4f}  plain "
          f"{plain_ms:.4f}  library(torch.einsum dense f32) "
          f"{library_ms:.4f}  bound {bound_ms:.4f} ({bound_by}); kernel "
          f"{2.0 * n * ma.bs_r * ma.bs_c * mb.bs_c / ms / 1e9:.3f} TFLOP/s",
          flush=True)
    del t, b, td, bd, ma, mb, ok, stacks, gm
    plan.clear_cache()
    torch.cuda.empty_cache()
    return dict(launches=launches, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err)


def phase_moe_layer(torch, K, S, MoE, get_arch, envelope) -> int:
    """Phase 16: one MoE layer of deepseek-moe-16b at full width (64
    experts, top-6, d_expert 1408, 2 shared) on 8 x 256 tokens, bf16,
    under dense, tp and spgemm (the backend and capacity the dispatch
    cache decides for this call's grid).  spgemm against dense within
    MOE_TOL with nothing dropped, exactly 3 kernel launches, and under
    MOE_MEM_LIMIT above the resident weights; then the kernel at the MoE
    shape against its plain version, its bound and one ``torch.bmm`` over
    the product list's A blocks grouped by expert."""
    import dataclasses

    import numpy as np

    base = get_arch("deepseek-moe-16b")
    e, de = MoE.moe_dims(base)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    p = MoE.init_moe(base, gen, torch.bfloat16)
    b, s = MOE_SHAPE
    x = torch.randn((b, s, base.d_model), generator=gen, device="cuda")
    x = x.to(torch.bfloat16)
    cfgs = {impl: dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, impl=impl)) for impl in ("dense", "tp", "spgemm")}
    # the dispatch decision for this call's grid, from its own mask
    logits = x.float() @ p["router"]
    _, top_e, _ = MoE.router_probs(base.moe, logits)
    tb = base.moe.token_block
    mask = MoE.dispatch_block_mask(top_e.reshape(b * s, -1), e, tb)
    cache = envelope.DispatchCache(np.eye(e, dtype=bool), dtype="bfloat16",
                                   device="cuda")
    env, dec = cache.resolve(mask.cpu().numpy())
    spec = MoE.DispatchSpec(envelope=env, backend=dec["backend"],
                            stack_capacity=dec["capacity"])
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    out = {}
    for impl in ("dense", "tp", "spgemm"):
        K.launches = 0
        torch.cuda.reset_peak_memory_stats()
        with MoE.dispatch_scope(spec if impl == "spgemm" else None):
            y, _, st = MoE.apply_moe(cfgs[impl], p, x, collect_stats=True)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - resident
            launches = K.launches
            ms = _time_ms(lambda: MoE.apply_moe(cfgs[impl], p, x), reps=3)
        out[impl] = (y, int(st["dropped"]), int(st["routed"]), launches,
                     peak, ms)
    yd, ys = out["dense"][0], out["spgemm"][0]
    good, err = _close(ys, yd, MOE_TOL)
    ratio = float(((ys.float() - yd.float()).abs()
                   / (MOE_TOL + MOE_TOL * yd.float().abs())).max())
    for impl, (_, dropped, routed, launches, peak, ms) in out.items():
        print(f"[16] {impl}: {ms:.4f} ms per layer, dropped {dropped} of "
              f"{routed} routed, kernel launches {launches}, peak "
              f"{peak / 2**30:.3f} GiB above the resident "
              f"{resident / 2**30:.3f} GiB", flush=True)
    print(f"[16] deepseek-moe-16b layer, {b} x {s} tokens bf16: dispatch "
          f"decision backend={dec['backend']} capacity={dec['capacity']} "
          f"source={dec['source']}, {int(mask.sum())} occupied (block, "
          f"expert) pairs of {mask.numel()}; spgemm vs dense max |err| "
          f"{err:.3e}, worst |err| / ({MOE_TOL} + {MOE_TOL} |dense|) "
          f"{ratio:.4f}", flush=True)
    _, dropped, _, launches, peak, _ = out["spgemm"]
    if not good or dropped:
        raise AssertionError(f"spgemm vs dense: max |err| {err}, dropped "
                             f"{dropped}")
    if launches != 3:
        raise AssertionError(f"spgemm launched the kernel {launches} times,"
                             " not 3")
    if peak >= MOE_MEM_LIMIT:
        raise AssertionError(f"spgemm took {peak / 2**30:.3f} GiB above the "
                             "weights")
    del out, yd, ys
    # the kernel at the MoE shape: A (nb, E) blocks of tb x d times the
    # aliased w_in bank's (E, E) blocks of d x de
    xt = x.reshape(b * s, base.d_model)
    a = MoE._dispatch_bsm(xt, mask, tb)
    bank = MoE.diag_expert_bsm(p["w_in"])
    ok = S.pair_cube(a.mask, bank.mask, a.norms, bank.norms, 0.0)
    n = S.product_count(ok)
    stacks = S.compact_pair_mask(ok, capacity=S.bucket_capacity(n))
    tile = K.kernel_tile(tb, de)
    gm = K.group_masks(stacks, ni=a.nb_r, nk=e, nj=e, g_r=tile.g_r,
                       g_c=tile.g_c)

    def kernel():
        return K.block_spgemm_groups(a.blocks, bank.blocks, gm, ni=a.nb_r,
                                     nj=e)

    def plain():
        return K.block_spgemm_stacks_plain(a.blocks, bank.blocks, stacks,
                                           ni=a.nb_r, nj=e)

    cp, plain_ms = _timed_call(plain)
    good_k, err_k = _close(kernel(), cp, TOL["bfloat16"])
    del cp
    if not good_k:
        raise AssertionError(f"kernel vs plain at the MoE shape: {err_k}")
    ms = _time_ms(kernel, reps=5)
    # the library figure: one bmm over the listed A blocks grouped by
    # expert (padded to the largest group) against the expert weights
    counts = mask.sum(0)
    width = int(counts.max())
    order = torch.argsort((~mask).t().to(torch.int8), dim=1, stable=True)
    rows = order[:, :width]  # (E, width) token blocks of each expert
    keep = torch.arange(width, device="cuda")[None, :] < counts[:, None]
    grouped = (a.blocks[rows, torch.arange(e, device="cuda")[:, None]]
               * keep[:, :, None, None].to(a.dtype))
    grouped = grouped.reshape(e, width * tb, base.d_model)
    library_ms = _time_ms(lambda: torch.bmm(grouped, p["w_in"]), reps=5)
    bound_ms, bound_by = _bound_rect(ok, tb, base.d_model, de, 2,
                                     PEAK_BF16_FLOPS)
    print(f"[16] kernel at the MoE shape ({a.nb_r} x {e}) blocks of {tb} x "
          f"{base.d_model} times the aliased ({e} x {e}) bank of "
          f"{base.d_model} x {de}: {n} products, group {tile.g_r} x "
          f"{tile.g_c}, {tile.n_sub_c} column sub-tiles; kernel vs plain "
          f"max |err| {err_k:.3e}; times (ms, median of CUDA events): "
          f"kernel {ms:.4f}  plain {plain_ms:.4f}  library(torch.bmm over "
          f"A grouped by expert, {width} blocks each) {library_ms:.4f}  "
          f"bound {bound_ms:.4f} ({bound_by}); kernel "
          f"{2.0 * n * tb * base.d_model * de / ms / 1e9:.3f} TFLOP/s",
          flush=True)
    del p, x, a, bank, ok, stacks, gm, grouped
    torch.cuda.empty_cache()
    return launches


def _moe_group(name: str) -> str:
    if "group_kernel" in name:
        return "block_spgemm"
    return _kernel_group(name)


def _moe_breakdown(torch, T, MoE, engine, prompts, n_decode: int = 4):
    """Phase 17's device time by kernel group and idle share: one prefill
    round of the served prompts and ``n_decode`` decode steps under the
    engine's dispatch spec (synchronised each step, as ``serve`` is)."""
    import numpy as np

    cfg, n = engine.cfg, engine.batch
    toks = torch.from_numpy(np.stack(prompts[:n])).to(engine.device,
                                                      torch.long)
    cache = T.init_cache(cfg, n, engine.max_len, device=engine.device)
    box = {}

    def prefill():
        with MoE.dispatch_scope(engine.dispatch_spec):
            box["logits"], _ = T.prefill(cfg, engine.params, toks, cache)

    def decode():
        tok = box["logits"][:, -1].argmax(-1)
        pos = torch.full((n,), toks.shape[1], device=engine.device)
        with MoE.dispatch_scope(engine.dispatch_spec):
            for _ in range(n_decode):
                logits, _ = T.decode_step(cfg, engine.params, tok[:, None],
                                          cache, pos)
                tok = logits[:, -1].argmax(-1)
                tok.tolist()  # the host reads each step's tokens
                pos = pos + 1

    names = ("block_spgemm", "flash", "matmul", "other")
    for name, fn, steps in (("prefill", prefill, 1),
                            ("decode", decode, n_decode)):
        wall, groups, n_launches, top = _profile_window(torch, fn, _moe_group,
                                                        names)
        busy = sum(groups.values())
        if busy <= 0:
            raise AssertionError(f"the profiler saw no device time in {name}")
        per = ", ".join(f"{k} {v / steps:.4f}" for k, v in groups.items())
        unit = "round" if steps == 1 else "step"
        print(f"[17] spgemm {name} ({steps} x): wall {wall / steps:.4f} ms, "
              f"device busy {busy / steps:.4f} ms, idle share "
              f"{1.0 - busy / wall:.4f}, {n_launches / steps:.0f} kernels "
              f"per {unit}; device ms per {unit}: {per}", flush=True)
        for ms, count, key in top[:4]:
            print(f"[17]   {ms / steps:9.4f} ms  x{count // steps:<5d} "
                  f"{key[:90]}", flush=True)
    del cache, box


def phase_moe_serve(torch, K, FA, T, MoE, serve) -> tuple[int, int]:
    """Phase 17: deepseek-moe-16b at full width and depth (28 layers, 64
    experts, 16.88 B bf16 parameters from seed 0) served through
    ``repro_torch.launch.serve`` under ``--moe-impl spgemm`` and then the
    config's ``tp`` on the same weights.  spgemm: every request gets its
    tokens in the vocabulary, nothing dropped, the decode decision names
    the kernel at capacity 128, kernel launches = 3 x layers x (prefill
    calls + decode steps), and every served request equals the request
    generated alone; then where spgemm's time goes (``_moe_breakdown``).
    tp's drops make "as generated alone" untrue by design: its dropped /
    routed are printed, not gated.  Returns the block-SpGEMM launches of
    the spgemm run and the flash launches of both runs."""
    torch.cuda.empty_cache()
    print(f"[17] memory allocated before the weights: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    argv = MOE_SERVE_ARGV + ["--moe-impl", "spgemm"]
    built = serve.build(argv)
    engine = built[2]
    cfg = built[1]
    print(f"[17] weights resident: {torch.cuda.memory_allocated() / 2**30:.3f}"
          f" GiB", flush=True)
    K.launches = 0
    FA.launches = 0
    st = serve.run(argv, built=built)
    launches, flash_launches = K.launches, FA.launches
    want = 3 * cfg.n_layers * (st["prefill_calls"] + st["decode_steps"])
    dec = st["dispatch"]
    t_alone = time.perf_counter()
    same = _served_alone(engine, built[3], st["outputs"])
    t_alone = time.perf_counter() - t_alone
    print(f"[17] spgemm: {st['tokens_per_s']:.3f} tok/s, prefill s "
          f"{[round(v, 4) for v in st['prefill_s']]}, decode ms median "
          f"{st['decode_ms_median']:.4f}, peak {st['peak_mem_gib']:.3f} GiB;"
          f" decision capacity={dec['capacity']} backend={dec['backend']} "
          f"source={dec['source']}; dispatch counters "
          f"{st['dispatch_counters']}; dropped {st['moe']['dropped']} of "
          f"{st['moe']['routed']}; kernel launches {launches} (3 x "
          f"{cfg.n_layers} x ({st['prefill_calls']} prefill + "
          f"{st['decode_steps']} decode) = {want}), flash launches "
          f"{flash_launches}; served == generated alone: {sum(same)} of "
          f"{len(same)} ({t_alone:.1f} s)", flush=True)
    if not st["ok"] or st["moe"]["dropped"]:
        raise AssertionError("spgemm serving: a request got too few tokens "
                             "or a token outside the vocabulary, or a "
                             "choice was dropped")
    if dec["backend"] != "cuda" or dec["capacity"] != 128:
        raise AssertionError(f"decode decision {dec}")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    if not all(same):
        raise AssertionError(f"served requests differ from the requests "
                             f"generated alone: {same}")
    _moe_breakdown(torch, T, MoE, engine, built[3])
    tp_argv = MOE_SERVE_ARGV + ["--moe-impl", "tp"]
    built_tp = serve.build(tp_argv, params=engine.params)
    del built, engine
    K.launches = 0
    FA.launches = 0
    st_tp = serve.run(tp_argv, built=built_tp)
    flash_launches += FA.launches
    print(f"[17] tp: {st_tp['tokens_per_s']:.3f} tok/s, prefill s "
          f"{[round(v, 4) for v in st_tp['prefill_s']]}, decode ms median "
          f"{st_tp['decode_ms_median']:.4f}, peak "
          f"{st_tp['peak_mem_gib']:.3f} GiB; dropped "
          f"{st_tp['moe']['dropped']} of {st_tp['moe']['routed']} routed; "
          f"block_spgemm launches {K.launches}, flash launches "
          f"{FA.launches}", flush=True)
    if not st_tp["ok"]:
        raise AssertionError("tp serving: a request got too few tokens or "
                             "a token outside the vocabulary")
    del built_tp
    torch.cuda.empty_cache()
    return launches, flash_launches


# phase 18: jamba-v0.1-52b at full width and 16 of its 32 layers (two
# repetitions of its 8-layer pattern: 95.8 GiB of bf16 weights at full
# depth is more than the card holds), random weights from seed 0.  (a) the
# config's tp: 12 requests of 2,048-token prompts + 32 new through 8 slots
# (one refill round); (b) spgemm on the same weights: 8 requests of
# 256-token prompts + 16 new
JAMBA_LAYERS = 16
JAMBA_TP_ARGV = ["--arch", "jamba-v0.1-52b", "--batch", "8", "--prompt-len",
                 "2048", "--max-new", "32", "--max-len", "2096", "--queue",
                 "12", "--seed", str(SEED)]
JAMBA_SPGEMM_ARGV = ["--arch", "jamba-v0.1-52b", "--batch", "8",
                     "--prompt-len", "256", "--max-new", "16", "--max-len",
                     "288", "--queue", "8", "--seed", str(SEED),
                     "--moe-impl", "spgemm"]
# phase 19: rwkv6-7b at full width and depth, the same traffic as 18 (a)
RWKV_PROFILE_LENS = (64, 128)
RWKV_ARGV = ["--arch", "rwkv6-7b", "--batch", "8", "--prompt-len", "2048",
             "--max-new", "32", "--max-len", "2096", "--queue", "12",
             "--seed", str(SEED)]


def _gib(torch) -> str:
    return f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB"


def _build_cut(serve, argv, n_layers: int, params):
    """``serve.build(argv)``'s tuple for the arch cut to its first
    ``n_layers`` layers, serving ``params`` (drawn for the cut config)."""
    import dataclasses

    from repro_torch.serving.engine import ServingEngine

    args, cfg, engine, prompts = serve.build(argv, params=params)
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    engine = ServingEngine(cfg, params, batch=args.batch,
                           max_len=args.max_len, gen=engine.gen)
    return args, cfg, engine, prompts


def _first_tokens_gate(torch, np, T, tag: str, engine, prompts,
                       outputs) -> None:
    """A separate prefill of the first round's prompts: finite logits, and
    the served first tokens are their argmax."""
    n = engine.batch
    toks = torch.from_numpy(np.stack(prompts[:n])).to(engine.device,
                                                      torch.long)
    cache = T.init_cache(engine.cfg, n, engine.max_len, device=engine.device)
    logits, cache = engine._prefill(toks, cache)
    del cache
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: prefill logits are not finite")
    first = logits[:, -1].argmax(-1).tolist()
    got = [o[0] for o in outputs[:n]]
    print(f"{tag} prefill logits finite, max |logit| "
          f"{float(logits.float().abs().max()):.3f}; first tokens "
          f"{'equal' if first == got else 'DIFFER'} to their argmax",
          flush=True)
    if first != got:
        raise AssertionError(f"{tag}: first tokens {got} != argmax {first}")


class _Spans:
    """Wraps module functions in ``torch.profiler.record_function`` spans
    for the length of a ``with`` block (the model code carries none)."""

    def __init__(self, torch, targets):
        self.torch, self.targets, self.saved = torch, targets, []

    def __enter__(self):
        record = self.torch.profiler.record_function
        for mod, name, span in self.targets:
            fn = getattr(mod, name)

            def wrapped(*a, _fn=fn, _span=span, **kw):
                with record(_span):
                    return _fn(*a, **kw)

            self.saved.append((mod, name, fn))
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _span_profile(torch, fn, spans: dict) -> tuple[float, dict, int]:
    """(wall ms, device ms by group, kernels) of ``fn`` under
    torch.profiler.  Kernels are grouped by name (flash, flash_bwd,
    matmul), the rest by the span that launched them (``spans``: span name
    -> group), and what no span launched is "other"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in spans  # the spans' own device ranges
              and not getattr(e, "is_user_annotation", False)]
    groups = dict.fromkeys(["flash", "flash_bwd", "matmul",
                            *spans.values(), "other"], 0.0)
    for e in device:
        g = _kernel_group(e.name)
        if g != "other":
            groups[g] += e.device_time_total / 1e3

    def walk(ev, owner):
        owner = spans.get(ev.name, owner)
        if owner is not None:
            groups[owner] += sum(k.duration for k in ev.kernels
                                 if _kernel_group(k.name) == "other") / 1e3
        for ch in ev.cpu_children:
            walk(ch, owner)

    for ev in events:
        if ev.device_type == DeviceType.CPU and ev.cpu_parent is None:
            walk(ev, None)
    busy = sum(e.device_time_total for e in device) / 1e3
    groups["other"] += busy - sum(groups.values())
    return wall_ms, groups, len(device)


def _jamba_breakdown(torch, np, T, M, MoE, engine, prompts,
                     n_decode: int = 4) -> None:
    """Phase 18 (d): one tp prefill round of the served prompts and
    ``n_decode`` decode steps under ``torch.profiler``, device time by
    group: the mamba mixers' non-GEMM kernels (the scan's elementwise
    passes, the conv, the coefficients), the MoE layers' non-GEMM kernels
    (routing, dispatch, combine), GEMMs, flash and the rest."""
    cfg, n = engine.cfg, engine.batch
    toks = torch.from_numpy(np.stack(prompts[:n])).to(engine.device,
                                                      torch.long)
    cache = T.init_cache(cfg, n, engine.max_len, device=engine.device)
    box = {}

    def prefill():
        box["logits"], _ = T.prefill(cfg, engine.params, toks, cache)

    def decode():
        tok = box["logits"][:, -1].argmax(-1)
        pos = torch.full((n,), toks.shape[1], device=engine.device)
        for _ in range(n_decode):
            logits, _ = T.decode_step(cfg, engine.params, tok[:, None],
                                      cache, pos)
            tok = logits[:, -1].argmax(-1)
            tok.tolist()  # the host reads each step's tokens
            pos = pos + 1

    targets = [(M, "apply_mamba", "mamba"), (M, "decode_mamba", "mamba"),
               (MoE, "apply_moe", "moe")]
    spans = {"mamba": "mamba_scan", "moe": "moe"}
    for name, fn, steps in (("prefill", prefill, 1),
                            ("decode", decode, n_decode)):
        with _Spans(torch, targets):
            wall, groups, n_kernels = _span_profile(torch, fn, spans)
        busy = sum(groups.values())
        if busy <= 0:
            raise AssertionError(f"the profiler saw no device time in {name}")
        per = ", ".join(f"{k} {v / steps:.4f}" for k, v in groups.items())
        unit = "round" if steps == 1 else "step"
        print(f"[18] tp {name} ({steps} x): wall {wall / steps:.4f} ms, "
              f"device busy {busy / steps:.4f} ms, idle share "
              f"{1.0 - busy / wall:.4f}, {n_kernels / steps:.0f} kernels per "
              f"{unit}; device ms per {unit}: {per}", flush=True)
    del cache, box


def _jamba_moe_kernel(torch, K, S, MoE, cfg, p) -> dict:
    """Phase 18 (c): the kernel at jamba's MoE shape, one of the served
    model's MoE layers (``p``) on 8 x 256 tokens: A (512 x 16) blocks of
    4 x 4,096 times the aliased w_in bank's (16 x 16) blocks of 4,096 x
    14,336, bf16; against its plain version, timed beside its bound and
    one ``torch.bmm`` over the token blocks grouped by expert."""
    e, de = MoE.moe_dims(cfg)
    tb = cfg.moe.token_block
    b, s = MOE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda")
    xt = x.to(torch.bfloat16).reshape(b * s, cfg.d_model)
    _, top_e, _ = MoE.router_probs(cfg.moe, xt.float() @ p["router"])
    mask = MoE.dispatch_block_mask(top_e, e, tb)
    a = MoE._dispatch_bsm(xt, mask, tb)
    bank = MoE.diag_expert_bsm(p["w_in"])
    ok = S.pair_cube(a.mask, bank.mask, a.norms, bank.norms, 0.0)
    n = S.product_count(ok)
    stacks = S.compact_pair_mask(ok, capacity=S.bucket_capacity(n))
    tile = K.kernel_tile(tb, de)
    gm = K.group_masks(stacks, ni=a.nb_r, nk=e, nj=e, g_r=tile.g_r,
                       g_c=tile.g_c)

    def kernel():
        return K.block_spgemm_groups(a.blocks, bank.blocks, gm, ni=a.nb_r,
                                     nj=e)

    def plain():
        return K.block_spgemm_stacks_plain(a.blocks, bank.blocks, stacks,
                                           ni=a.nb_r, nj=e)

    cp, plain_ms = _timed_call(plain)
    good, err = _close(kernel(), cp, TOL["bfloat16"])
    del cp
    if not good:
        raise AssertionError(f"kernel vs plain at jamba's MoE shape: {err}")
    ms = _time_ms(kernel, reps=3)
    counts = mask.sum(0)
    width = int(counts.max())
    order = torch.argsort((~mask).t().to(torch.int8), dim=1, stable=True)
    rows = order[:, :width]
    keep = torch.arange(width, device="cuda")[None, :] < counts[:, None]
    grouped = (a.blocks[rows, torch.arange(e, device="cuda")[:, None]]
               * keep[:, :, None, None].to(a.dtype))
    grouped = grouped.reshape(e, width * tb, cfg.d_model)
    library_ms = _time_ms(lambda: torch.bmm(grouped, p["w_in"]), reps=5)
    bound_ms, bound_by = _bound_rect(ok, tb, cfg.d_model, de, 2,
                                     PEAK_BF16_FLOPS)
    flop = 2.0 * tb * cfg.d_model * de
    print(f"[18] kernel at jamba's MoE shape ({a.nb_r} x {e}) blocks of "
          f"{tb} x {cfg.d_model} times the aliased ({e} x {e}) bank of "
          f"{cfg.d_model} x {de}: {n} products ({flop / 1e9:.3f} GFLOP "
          f"each), group {tile.g_r} x {tile.g_c}; kernel vs plain max |err| "
          f"{err:.3e}; times (ms, median of CUDA events): kernel {ms:.4f}  "
          f"plain {plain_ms:.4f}  library(torch.bmm over A grouped by "
          f"expert, {width} blocks each) {library_ms:.4f}  bound "
          f"{bound_ms:.4f} ({bound_by}); kernel "
          f"{n * flop / ms / 1e9:.3f} TFLOP/s", flush=True)
    del x, xt, a, bank, ok, stacks, gm, grouped
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                products=n)


def phase_jamba(torch, np, K, S, FA, T, MoE, serve, get_arch
                ) -> tuple[int, int, dict]:
    """Phase 18: jamba-v0.1-52b at full width (d 4,096, d_ff 14,336, 16
    experts top-2, d_state 16, expand 2) and 16 layers, bf16, weights
    from seed 0, served through ``repro_torch.launch.serve.run``: (a) tp
    (every token in the vocabulary, flash launches = 2 attention layers x
    prefill calls, no block-SpGEMM launch, first tokens the argmax of a
    separate prefill); (b) spgemm on the same weights (nothing dropped,
    every request as generated alone, block-SpGEMM launches = 3 x 8 MoE
    layers x (prefill calls + decode steps)); (c) the kernel at this MoE
    shape; (d) where a tp prefill round and a decode step spend their
    time; (e) the flash kernel at jamba's attention shape.  Returns the
    block-SpGEMM launches of (b), the flash launches of (a) and (b), and
    the figures of (c) (with (e)'s under "flash")."""
    import dataclasses

    from repro_torch.models import mamba as M

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_arch("jamba-v0.1-52b"),
                              n_layers=JAMBA_LAYERS)
    kinds = T.layer_kinds(cfg)
    n_attn = sum(k["mixer"] == "attention" for k in kinds)
    n_moe = sum(k["moe"] for k in kinds)
    print(f"[18] jamba-v0.1-52b cut to {cfg.n_layers} layers ({n_attn} "
          f"attention, {n_moe} MoE), {cfg.param_count() / 1e9:.3f} B "
          f"parameters; memory allocated before the weights: {_gib(torch)}",
          flush=True)
    params = T.init_params(cfg, SEED, device="cuda")
    print(f"[18] weights resident: {_gib(torch)}", flush=True)

    # (a) the config's tp
    built = _build_cut(serve, JAMBA_TP_ARGV, JAMBA_LAYERS, params)
    engine = built[2]
    K.launches = 0
    FA.launches = 0
    st = serve.run(JAMBA_TP_ARGV, built=built)
    flash_a, spgemm_a = FA.launches, K.launches
    print(f"[18] tp: {st['requests']} requests, {st['tokens']} tokens, "
          f"{st['tokens_per_s']:.3f} tok/s, prefill s per round "
          f"{[round(v, 4) for v in st['prefill_s']]}, decode ms median "
          f"{st['decode_ms_median']:.4f}, peak {st['peak_mem_gib']:.3f} GiB;"
          f" dropped {st['moe']['dropped']} of {st['moe']['routed']} routed; "
          f"flash launches {flash_a} ({n_attn} x {st['prefill_calls']} "
          f"prefill calls), block_spgemm launches {spgemm_a}", flush=True)
    if not st["ok"]:
        raise AssertionError("jamba tp: a request got too few tokens or a "
                             "token outside the vocabulary")
    if flash_a != n_attn * st["prefill_calls"] or spgemm_a:
        raise AssertionError(f"jamba tp: flash launches {flash_a}, "
                             f"block_spgemm launches {spgemm_a}")
    MoE.reset_drop_counts()
    _first_tokens_gate(torch, np, T, "[18] tp:", engine, built[3],
                       st["outputs"])
    real = MoE.drop_counts()  # the round's 8 prompts, no padding rows
    print(f"[18] tp: a prefill round of the first 8 prompts drops "
          f"{int(real['dropped'])} of {int(real['routed'])} routed choices "
          f"(the served total above also counts the second round's 4 "
          f"padding rows, which route alike)", flush=True)
    _jamba_breakdown(torch, np, T, M, MoE, engine, built[3])
    del built, engine, st

    # (b) spgemm on the same weights
    built = _build_cut(serve, JAMBA_SPGEMM_ARGV, JAMBA_LAYERS, params)
    engine = built[2]
    K.launches = 0
    FA.launches = 0
    st = serve.run(JAMBA_SPGEMM_ARGV, built=built)
    launches, flash_b = K.launches, FA.launches
    want = 3 * n_moe * (st["prefill_calls"] + st["decode_steps"])
    dec = st["dispatch"]
    t_alone = time.perf_counter()
    same = _served_alone(engine, built[3], st["outputs"])
    t_alone = time.perf_counter() - t_alone
    print(f"[18] spgemm: {st['tokens_per_s']:.3f} tok/s, prefill s "
          f"{[round(v, 4) for v in st['prefill_s']]}, decode ms median "
          f"{st['decode_ms_median']:.4f}, peak {st['peak_mem_gib']:.3f} GiB;"
          f" decode decision backend={dec['backend']} capacity="
          f"{dec['capacity']} source={dec['source']}; dropped "
          f"{st['moe']['dropped']} of {st['moe']['routed']}; kernel launches"
          f" {launches} (3 x {n_moe} x ({st['prefill_calls']} prefill + "
          f"{st['decode_steps']} decode) = {want}), flash launches "
          f"{flash_b}; served == generated alone: {sum(same)} of "
          f"{len(same)} ({t_alone:.1f} s)", flush=True)
    if not st["ok"] or st["moe"]["dropped"]:
        raise AssertionError("jamba spgemm: a request got too few tokens or"
                             " a token outside the vocabulary, or a choice "
                             "was dropped")
    if dec["backend"] != "cuda":
        raise AssertionError(f"jamba spgemm decode decision {dec}")
    if launches != want:
        raise AssertionError(f"jamba spgemm kernel launches {launches} != "
                             f"{want}")
    if not all(same):
        raise AssertionError(f"jamba spgemm: served requests differ from "
                             f"the requests generated alone: {same}")
    del built, engine, st

    # (c) the kernel at this MoE shape, on the first MoE layer's weights
    first_moe = next(i for i, k in enumerate(kinds) if k["moe"])
    kern = _jamba_moe_kernel(torch, K, S, MoE, cfg,
                             params["blocks"][first_moe]["moe"])
    del params
    kern["flash"] = _flash_at(torch, np, FA, (8, cfg.n_heads, cfg.n_kv_heads,
                                              2048, 2048, cfg.hd), True,
                              "[18]", SEED + 3)
    torch.cuda.empty_cache()
    print(f"[18] memory allocated after freeing the weights: {_gib(torch)}",
          flush=True)
    return launches, flash_a + flash_b, kern


def phase_rwkv(torch, np, K, FA, T, serve) -> None:
    """Phase 19: rwkv6-7b at full width and depth (32 layers, d 4,096, 64
    heads of 64), bf16, weights from seed 0, served through
    ``repro_torch.launch.serve.run``: every token in the vocabulary, the
    first tokens the argmax of a separate prefill, request 0 and the
    first refilled request each as generated alone, and neither kernel
    launched (the model has no attention and no MoE).  Then the kernels a
    prefill launches: the token loop is launch-bound."""
    torch.cuda.empty_cache()
    print(f"[19] memory allocated before the weights: {_gib(torch)}",
          flush=True)
    built = serve.build(RWKV_ARGV)
    engine, cfg, prompts = built[2], built[1], built[3]
    print(f"[19] weights resident: {_gib(torch)}", flush=True)
    K.launches = 0
    FA.launches = 0
    st = serve.run(RWKV_ARGV, built=built)
    flash, spgemm = FA.launches, K.launches
    print(f"[19] rwkv6-7b: {st['requests']} requests, {st['tokens']} tokens,"
          f" {st['tokens_per_s']:.3f} tok/s, prefill s per round "
          f"{[round(v, 4) for v in st['prefill_s']]}, decode ms median "
          f"{st['decode_ms_median']:.4f}, peak {st['peak_mem_gib']:.3f} GiB;"
          f" flash launches {flash}, block_spgemm launches {spgemm}",
          flush=True)
    if not st["ok"]:
        raise AssertionError("rwkv6: a request got too few tokens or a "
                             "token outside the vocabulary")
    if flash or spgemm:
        raise AssertionError(f"rwkv6 launched flash {flash} and "
                             f"block_spgemm {spgemm} times")
    _first_tokens_gate(torch, np, T, "[19]", engine, prompts, st["outputs"])
    refilled = engine.batch  # the first request of the second round
    for i in (0, refilled):
        solo = engine.generate([prompts[i]])[0]
        same = solo == st["outputs"][i]
        print(f"[19] request {i} served {'equals' if same else 'DIFFERS from'}"
              f" request {i} generated alone", flush=True)
        if not same:
            raise AssertionError(f"rwkv6 request {i}: served "
                                 f"{st['outputs'][i]} != alone {solo}")
    # kernels per prefill: every loop runs per token, so the count is
    # affine in the prompt length; measured at 64 and 128 tokens (the
    # profiler's own host work grows with the kernels it records)
    counts = {}
    for plen in RWKV_PROFILE_LENS:
        toks = torch.from_numpy(np.stack([q[:plen] for q in
                                          prompts[:engine.batch]])).to(
            engine.device, torch.long)
        cache = T.init_cache(cfg, engine.batch, engine.max_len,
                             device=engine.device)
        wall, groups, n_launches, _ = _profile_window(
            torch, lambda: T.prefill(cfg, engine.params, toks, cache))
        counts[plen] = n_launches
        print(f"[19] prefill of {engine.batch} x {plen} tokens under "
              f"torch.profiler: wall {wall:.4f} ms, device busy "
              f"{sum(groups.values()):.4f} ms, idle share "
              f"{1.0 - sum(groups.values()) / wall:.4f}, {n_launches} "
              f"kernels", flush=True)
        del cache
    lo, hi = RWKV_PROFILE_LENS
    per_token = (counts[hi] - counts[lo]) / (hi - lo)
    per_layer = per_token / cfg.n_layers
    print(f"[19] kernels per prompt token {per_token:.2f} ({per_layer:.2f}"
          f" per layer); a 2,048-token round launches "
          f"{counts[lo] + round(per_token * (2048 - lo))} (affine in the "
          f"length, from the two counts)", flush=True)
    del built, engine, st
    torch.cuda.empty_cache()


# phase 20: whisper-large-v3 at full width and depth, served as the
# reference's prefill step serves it (frames through the entry points):
# 8 requests, each 1,500 frame embeddings (30 s of audio, bf16, from the
# seed) and a 32-token decoder prompt, 128 new greedy tokens each
WHISPER = dict(batch=8, prompt=32, new=128)
# phase 21: pixtral-12b at full width and depth; (a) text traffic through
# the entry point: 16 requests of 1,024-token prompts + 64 new through 8
# slots (one refill round); (b) early fusion: 256 patch embeddings in
# front of 8 of those prompts (1,280 positions), 64 new greedy tokens
PIXTRAL_ARGV = ["--arch", "pixtral-12b", "--batch", "8", "--prompt-len",
                "1024", "--max-new", "64", "--max-len", "1152", "--queue",
                "16", "--seed", str(SEED)]
PIXTRAL_NEW = 64


def _greedy(torch, T, cfg, params, toks, n_new: int, max_len: int,
            **embeds) -> dict:
    """Greedy generation through the model's entry points: ``T.prefill``
    with the stub embeddings into a fresh cache, then ``n_new - 1``
    ``decode_step``s at per-slot (B,) positions, the host reading each
    step's tokens.  Returns the tokens (B lists), the prefill's logits,
    its flash launches and seconds, the decode steps' seconds and the
    cache."""
    from repro_torch.kernels import flash_attention as FA

    b, s = toks.shape
    cache = T.init_cache(cfg, b, max_len, device=toks.device)
    torch.cuda.synchronize()
    before = FA.launches
    t0 = time.perf_counter()
    logits, cache = T.prefill(cfg, params, toks, cache, **embeds)
    tok = logits[:, -1].argmax(-1)
    out = [tok.tolist()]
    prefill_s = time.perf_counter() - t0
    launches = FA.launches - before
    pos = torch.full((b,), s, device=toks.device)
    steps = []
    for _ in range(n_new - 1):
        t1 = time.perf_counter()
        step, cache = T.decode_step(cfg, params, tok[:, None], cache, pos)
        tok = step[:, -1].argmax(-1)
        out.append(tok.tolist())  # waits for the device
        steps.append(time.perf_counter() - t1)
        pos = pos + 1
    return dict(tokens=[list(r) for r in zip(*out)], logits=logits,
                launches=launches, prefill_s=prefill_s, decode_s=steps,
                cache=cache)


def _alone(torch, toks, embeds: dict) -> tuple:
    """Request 0 as ``ServingEngine.generate`` would run it alone: the
    full batch, every other row (tokens and embeddings) zero."""
    t = torch.zeros_like(toks)
    t[0] = toks[0]
    e = {}
    for k, v in embeds.items():
        e[k] = torch.zeros_like(v)
        e[k][0] = v[0]
    return t, e


def _flash_at(torch, np, FA, shape: tuple, causal: bool, tag: str,
              seed: int) -> dict:
    """The flash kernel at one attention shape of a served model (b, h,
    hkv, sq, skv, d), checked and timed.  The bf16 tensor-core kernel
    against its plain version, each output within ``flash_serve_limit``
    for the keys its row keeps (i + 1 for causal row i, sq == skv; all skv
    otherwise), then the SIMT f32 kernel on the same inputs cast to f32 at
    1e-4 (phase 9's checks); the bf16 kernel timed (and through its op's
    dispatch, the path a trace takes) beside its plain version,
    ``scaled_dot_product_attention`` (``enable_gqa`` when hkv < h) and the
    bound."""
    b, h, hkv, sq, skv, d = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, s, d),
                                                    dtype=np.float32))
               .to("cuda", torch.bfloat16)
               for n, s in ((h, sq), (hkv, skv), (hkv, skv)))
    keys = (torch.arange(1, sq + 1, device="cuda", dtype=torch.float32)
            if causal else torch.full((sq,), float(skv), device="cuda"))
    errs, ratios = {}, {}
    for dtype, tol in (("bfloat16", FLASH_SERVE_TOL_BF16),
                       ("float32", dict(atol=FLASH_TOL["float32"],
                                        rtol=FLASH_TOL["float32"]))):
        x = [t.to(getattr(torch, dtype)) for t in (q, k, v)]
        got = FA.flash_attention(*x, causal=causal)
        plain = FA.flash_attention_plain(*x, causal=causal)
        diff = (got.float() - plain.float()).abs()
        n = keys if dtype == "bfloat16" else torch.ones_like(keys)
        ratios[dtype] = float((diff / flash_serve_limit(plain, n,
                                                        **tol)).max())
        errs[dtype] = float(diff.max())
        del x, got, plain, diff
    kind = "causal" if causal else "non-causal"
    where = f"b={b} h={h} hkv={hkv} sq={sq} skv={skv} d={d} {kind}"
    print(f"{tag} flash at {where}: kernel vs plain max |err| bf16 "
          f"{errs['bfloat16']:.3e} (worst |err| / limit "
          f"{ratios['bfloat16']:.4f}), f32 {errs['float32']:.3e} (worst "
          f"{ratios['float32']:.4f})", flush=True)
    if not max(ratios.values()) <= 1.0:
        raise AssertionError(f"flash kernel vs plain at {where}: max |err| "
                             f"{errs}")
    ms = _time_ms(lambda: FA.flash_attention(q, k, v, causal=causal),
                  reps=10, warmup=2)
    # the same launch through its op's dispatch, the path a trace or
    # FlopCounterMode takes (a plain call launches directly)
    op_ms = _time_ms(lambda: torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, causal, None, None, None, 0, False), reps=10, warmup=2)
    plain_ms = _time_ms(lambda: FA.flash_attention_plain(q, k, v,
                                                         causal=causal),
                        reps=2, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = dict(enable_gqa=True) if hkv < h else {}
    library_ms = _time_ms(lambda: sdpa(q, k, v, is_causal=causal, **gqa),
                          reps=10, warmup=2)
    bound_ms, bound_by = _flash_bound(b, h, hkv, sq, skv, d, 2, causal)
    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * skv)
    print(f"{tag} flash at {where} bf16: times (ms, median of CUDA events):"
          f" kernel {ms:.4f} (through the op {op_ms:.4f})  plain "
          f"{plain_ms:.4f}  library(sdpa"
          f"{', enable_gqa' if gqa else ''}) {library_ms:.4f}  bound "
          f"{bound_ms:.4f} ({bound_by}); kernel "
          f"{4.0 * d * pairs / ms / 1e9:.3f} TFLOP/s on the kept pairs",
          flush=True)
    del q, k, v
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=errs["bfloat16"])


def _whisper_breakdown(torch, T, cfg, params, run: dict) -> None:
    """Phase 20 (c): one decode step of the served batch under
    ``torch.profiler``: device time by group (GEMMs, the cross-attention
    sub-layers' other kernels, the rest) with the idle share; and the f32
    copy of one layer's cross K cache that ``decode_attention`` makes,
    timed alone (CUDA events) and times the decoder's layers."""
    cache, b = run["cache"], len(run["tokens"])
    tok = torch.tensor([r[-1] for r in run["tokens"]], device="cuda")
    pos = torch.full((b,), WHISPER["prompt"] + WHISPER["new"] - 1,
                     device="cuda")

    def step():
        logits, _ = T.decode_step(cfg, params, tok[:, None], cache, pos)
        logits[:, -1].argmax(-1).tolist()

    step()  # warm
    with _Spans(torch, [(T, "_cross_decode", "xattn")]):
        wall, groups, n_kernels = _span_profile(
            torch, step, {"xattn": "cross_attention"})
    busy = sum(groups.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time in whisper's "
                             "decode step")
    per = ", ".join(f"{k} {v:.4f}" for k, v in groups.items())
    xk = cache["blocks"][0]["xk"]
    cast_ms = _time_ms(lambda: xk.float(), reps=10, warmup=2)
    print(f"[20] decode step under torch.profiler: wall {wall:.4f} ms, "
          f"device busy {busy:.4f} ms, idle share {1.0 - busy / wall:.4f}, "
          f"{n_kernels} kernels; device ms: {per}; the f32 copy of one "
          f"layer's cross K cache ({xk.numel() * 4 / 1e6:.1f} MB) "
          f"{cast_ms:.4f} ms, x {cfg.n_layers} layers = "
          f"{cast_ms * cfg.n_layers:.4f} ms a step", flush=True)


def phase_whisper(torch, np, FA, T, get_arch) -> tuple[int, dict]:
    """Phase 20: whisper-large-v3 at full width and depth (32 encoder + 32
    decoder layers, d 1,280, 20 heads of 64, d_ff 5,120, vocab 51,866),
    bf16, weights from seed 0, through the model's entry points with
    frames: (a) 8 requests, each 1,500 frame embeddings and a 32-token
    prompt, 128 new greedy tokens (``T.prefill(frame_embeds=)``, then
    ``decode_step`` at per-slot positions); gates: every token in the
    vocabulary, the first tokens the argmax of a separate prefill, 96
    flash launches a prefill (32 encoder + 32 self + 32 cross) with no
    input copied for TMA, a non-zero cross cache after the prefill, and
    request 0 generated alone (the other rows zero) equal to request 0
    served; (b) the encoder alone, timed; (c) a decode step by group;
    (d) the flash kernel at the three shapes the prefill gives it: the
    encoder's self-attention (b, 20, 1,500, 64, non-causal), the
    cross-attention (32 queries against 1,500 frames, non-causal) and the
    decoder's causal self-attention (32 x 32).  Returns the flash launches
    of the served prefill and (d)'s figures by shape."""
    torch.cuda.empty_cache()
    cfg = get_arch("whisper-large-v3")
    b, plen, n_new = WHISPER["batch"], WHISPER["prompt"], WHISPER["new"]
    max_len = plen + n_new
    print(f"[20] whisper-large-v3: {cfg.encoder.n_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads (hd {cfg.hd}), {cfg.param_count() / 1e9:.3f}"
          f" B parameters; memory allocated before the weights: "
          f"{_gib(torch)}", flush=True)
    params = T.init_params(cfg, SEED, device="cuda")
    print(f"[20] weights resident: {_gib(torch)}", flush=True)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, plen))).to(
        "cuda", torch.long)
    emb = _stub_embeds(torch, np, cfg, b, SEED + 5)
    want = _flash_per_prefill(T, cfg)

    # (a) the served batch
    torch.cuda.reset_peak_memory_stats()
    FA.copies = 0
    t0 = time.perf_counter()
    run = _greedy(torch, T, cfg, params, toks, n_new, max_len, **emb)
    wall = time.perf_counter() - t0
    n_tok = sum(len(r) for r in run["tokens"])
    copies = FA.copies
    zero = [bool((c["xk"] == 0).all() or (c["xv"] == 0).all())
            for c in run["cache"]["blocks"]]
    dec_ms = 1e3 * statistics.median(run["decode_s"])
    print(f"[20] {b} requests x ({cfg.encoder.n_frames} frames + {plen} "
          f"tokens) + {n_new} new: {n_tok} tokens in {wall:.3f} s "
          f"({n_tok / wall:.3f} tokens/s), prefill (encoder included) "
          f"{run['prefill_s']:.4f} s, decode median {dec_ms:.4f} ms; flash "
          f"launches in the prefill {run['launches']} (want {want}), flash "
          f"input copies {copies}; layers whose cross cache stayed zero "
          f"{sum(zero)}; peak {torch.cuda.max_memory_allocated() / 2**30:.3f}"
          f" GiB", flush=True)
    if not all(0 <= t < cfg.vocab and len(r) == n_new
               for r in run["tokens"] for t in r):
        raise AssertionError("whisper: too few tokens or a token outside "
                             "the vocabulary")
    if run["launches"] != want or copies:
        raise AssertionError(f"whisper: {run['launches']} flash launches "
                             f"(want {want}), {copies} copies")
    if any(zero):
        raise AssertionError("whisper: the prefill left a cross cache zero")
    first = run["logits"][:, -1].argmax(-1).tolist()
    again, _ = T.prefill(cfg, params, toks,
                         T.init_cache(cfg, b, max_len, device="cuda"), **emb)
    if not bool(torch.isfinite(again).all()):
        raise AssertionError("whisper: prefill logits are not finite")
    argmax = again[:, -1].argmax(-1).tolist()
    got = [r[0] for r in run["tokens"]]
    toks0, emb0 = _alone(torch, toks, emb)
    solo = _greedy(torch, T, cfg, params, toks0, n_new, max_len, **emb0)
    same = solo["tokens"][0] == run["tokens"][0]
    print(f"[20] prefill logits finite, max |logit| "
          f"{float(again.float().abs().max()):.3f}; first tokens "
          f"{'equal' if got == argmax == first else 'DIFFER'} to the argmax "
          f"of a separate prefill; request 0 served "
          f"{'equals' if same else 'DIFFERS from'} request 0 generated "
          f"alone", flush=True)
    if not got == argmax == first:
        raise AssertionError(f"whisper: first tokens {got} != argmax "
                             f"{argmax}")
    if not same:
        raise AssertionError(f"whisper: served {run['tokens'][0]} != alone "
                             f"{solo['tokens'][0]}")
    del again, solo

    # (b) the encoder alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T.encode(cfg, params, emb["frame_embeds"])
    torch.cuda.synchronize()
    print(f"[20] the encoder alone over {b} x {cfg.encoder.n_frames} frames:"
          f" {time.perf_counter() - t0:.4f} s", flush=True)

    # (c) where a decode step goes; (d) the kernel at the encoder's shape
    _whisper_breakdown(torch, T, cfg, params, run)
    launches = run["launches"]
    del run, params, emb
    torch.cuda.empty_cache()
    h, f = cfg.n_heads, cfg.encoder.n_frames
    return launches, {name: _flash_at(torch, np, FA, (b, h, h, sq, skv,
                                                      cfg.hd), causal,
                                      f"[20] ({name})", seed)
                      for name, sq, skv, causal, seed in (
                          ("encoder", f, f, False, SEED + 4),
                          ("cross", plen, f, False, SEED + 7),
                          ("self", plen, plen, True, SEED + 8))}


def phase_pixtral(torch, np, K, FA, T, serve) -> tuple[int, dict]:
    """Phase 21: pixtral-12b at full width and depth (40 layers, d 5,120,
    32 heads of 128 with 8 kv heads, d_ff 14,336, vocab 131,072, rope
    theta 1e9), bf16, weights from seed 0: (a) text traffic through
    ``repro_torch.launch.serve.run`` with phase 7's gates (40 flash
    launches a prefill round); (b) early fusion through
    ``T.prefill(patch_embeds=)``: 256 patch embeddings (bf16, from the
    seed) in front of 8 of (a)'s prompts, 64 new greedy tokens; gates:
    finite logits, the first tokens the argmax of a separate prefill, 40
    flash launches, and logits that differ from the same tokens' text-only
    logits; (c) the flash kernel at (a)'s prefill shape (1,024
    positions) and (b)'s (1,280); (d) a prefill round and four decode
    steps of (a)'s engine under ``torch.profiler`` by kernel group (run
    after (a)).  Returns the flash launches of (a) and (b), and (c)'s
    figures by shape."""
    torch.cuda.empty_cache()
    print(f"[21] memory allocated before the weights: {_gib(torch)}",
          flush=True)
    st, engine, toks = phase_serve(torch, np, T, K, FA, serve, PIXTRAL_ARGV,
                                   tag="[21] (a)")
    cfg, params = engine.cfg, engine.params
    print(f"[21] (a) {cfg.param_count() / 1e9:.3f} B parameters, peak "
          f"{st['peak_mem_gib']:.3f} GiB, prefill s per round "
          f"{[round(x, 4) for x in st['prefill_s']]}", flush=True)
    phase_breakdown(torch, T, engine, toks, n_decode=4, tag="[21] (d)")

    # (b) early fusion: placeholder ids under the prefix, then the prompt
    b = engine.batch
    ids = torch.cat([torch.zeros((b, cfg.n_patches), dtype=torch.long,
                                 device="cuda"), toks], dim=1)
    emb = _stub_embeds(torch, np, cfg, b, SEED + 6)
    emb["patch_embeds"] *= 0.02  # the token embeddings' scale
    max_len = ids.shape[1] + PIXTRAL_NEW
    t0 = time.perf_counter()
    run = _greedy(torch, T, cfg, params, ids, PIXTRAL_NEW, max_len, **emb)
    wall = time.perf_counter() - t0
    n_tok = sum(len(r) for r in run["tokens"])
    dec_ms = 1e3 * statistics.median(run["decode_s"])
    again, cache = T.prefill(cfg, params, ids,
                             T.init_cache(cfg, b, max_len, device="cuda"),
                             **emb)
    text, cache = T.prefill(cfg, params, ids, cache)
    del cache
    argmax = again[:, -1].argmax(-1).tolist()
    got = [r[0] for r in run["tokens"]]
    differ = float((text.float() - again.float()).abs().max())
    print(f"[21] (b) early fusion, {b} x ({cfg.n_patches} patches + "
          f"{toks.shape[1]} tokens) + {PIXTRAL_NEW} new: {n_tok} tokens in "
          f"{wall:.3f} s ({n_tok / wall:.3f} tokens/s), prefill "
          f"{run['prefill_s']:.4f} s, decode median {dec_ms:.4f} ms, flash "
          f"launches in the prefill {run['launches']}; logits finite: "
          f"{bool(torch.isfinite(again).all())}; first tokens "
          f"{'equal' if got == argmax else 'DIFFER'} to the argmax of a "
          f"separate prefill; max |logit with patches - text only| "
          f"{differ:.3f}", flush=True)
    if not bool(torch.isfinite(again).all()):
        raise AssertionError("pixtral fusion: logits are not finite")
    if got != argmax:
        raise AssertionError(f"pixtral fusion: first tokens {got} != argmax"
                             f" {argmax}")
    if run["launches"] != cfg.n_layers:
        raise AssertionError(f"pixtral fusion: {run['launches']} flash "
                             f"launches for {cfg.n_layers} layers")
    if not differ > 0.0:
        raise AssertionError("pixtral fusion: the patch prefix left the "
                             "logits as the text-only ones")
    if not all(0 <= t < cfg.vocab for r in run["tokens"] for t in r):
        raise AssertionError("pixtral fusion: a token outside the vocabulary")
    flash = st["flash_launches"] + run["launches"]
    del run, again, text, engine, params, st, emb
    torch.cuda.empty_cache()
    # (c) the kernel at (a)'s prefill shape and (b)'s fused one
    return flash, {name: _flash_at(torch, np, FA, (b, cfg.n_heads,
                                                   cfg.n_kv_heads, s, s,
                                                   cfg.hd), True,
                                   f"[21] ({name})", seed)
                   for name, s, seed in (
                       ("text", toks.shape[1], SEED + 3),
                       ("fused", cfg.n_patches + toks.shape[1],
                        SEED + 9))}



# phase 22: the flash backward kernels against the plain backward, (b, h,
# hkv, sq, skv, d, causal, window, softcap, q_offset); rows 300-333 of the
# (300, 100) window case keep no key
FLASH_BWD_CASES = (
    (1, 2, 2, 256, 256, 64, True, None, None, 0),
    (1, 2, 2, 256, 256, 64, False, None, None, 0),
    (1, 2, 2, 256, 256, 128, True, 64, None, 0),
    (2, 8, 2, 200, 200, 32, True, None, None, 0),
    (1, 2, 1, 333, 333, 128, True, 100, 30.0, 0),
    (1, 4, 2, 128, 384, 128, True, None, None, 0),
    (1, 4, 2, 384, 128, 64, False, None, 50.0, 0),
    (1, 2, 2, 333, 100, 64, True, 32, None, 0),
    (1, 8, 2, 200, 328, 64, True, 64, 50.0, 128),
)
# olmo-1b's training shape: one layer of 8 x 2,048 tokens
FLASH_TRAIN_SHAPE = (8, 16, 16, 2048, 2048, 128)
# the backward kernels and the plain backward both compute in f32 and round
# each result once, so at bf16 they differ by one output rounding (at most
# 2^-7 |plain|) plus f32 summation order, which shows only where terms
# cancel.  The limit of an output whose row (dQ) or key (dK, dV) is in n
# kept (q, k) pairs is atol / sqrt(n) + rtol |plain| (``flash_serve_limit``):
# the early keys' large, heavy-tailed gradients get rtol, the late keys'
# small ones a limit that a dropped key range or a mis-walked q tile
# exceeds many times (tests/test_torch_flash_attention.py).  f32: FLASH_TOL
# of each output, 1e-4 + 1e-4 |plain|
FLASH_BWD_TOL_BF16 = dict(atol=1e-2, rtol=1e-2)


def flash_bwd_kept(torch, sq: int, skv: int, g: int, causal=True,
                   window=None, q_offset: int = 0, device="cpu") -> tuple:
    """(the kept pairs of each query row, of each key): f32 (sq,) and
    (skv,) under the forward's masks, a key's counted over the g query
    heads of its kv head; each at least 1."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    keep = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    keep = keep.float()
    return keep.sum(1).clamp(min=1), (g * keep.sum(0)).clamp(min=1)


def flash_bwd_ratio(got, want, kept: tuple, dtype: str) -> tuple:
    """(worst |kernel - plain| / limit, max |kernel - plain|) over dq, dk
    and dv: bf16 within ``flash_serve_limit`` of each output's kept pairs
    (FLASH_BWD_TOL_BF16), f32 within FLASH_TOL of each output."""
    ratio = err = 0.0
    for g, w, n in zip(got, want, (kept[0], kept[1], kept[1])):
        diff = (g.float() - w.float()).abs()
        if dtype == "bfloat16":
            limit = flash_serve_limit(w, n, **FLASH_BWD_TOL_BF16)
        else:
            tol = FLASH_TOL["float32"]
            limit = flash_serve_limit(w, n.new_ones(n.shape), tol, tol)
        ratio = max(ratio, float((diff / limit).max()))
        err = max(err, float(diff.max()))
    return ratio, err


def _lse_close(torch, lse, plain) -> bool:
    """The same rows at +inf (no key kept), the rest within 1e-4 + 1e-5
    |plain|."""
    fin = torch.isfinite(plain)
    return bool(torch.equal(torch.isinf(lse), torch.isinf(plain))
                and ((lse - plain)[fin].abs()
                     <= 1e-4 + 1e-5 * plain[fin].abs()).all())


def _ptxas_kernels(log: str, names) -> list[str]:
    """'name<D>: N registers, S bytes spill stores, L bytes spill loads'
    for each entry function of ``-Xptxas -v``'s log whose mangled name
    holds one of ``names``."""
    import re

    rows, fn, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = next((n for n in names if n in m.group(1)), None)
            d = re.search(r"Li(\d+)E", m.group(1))
            fn = fn and f"{fn}<{d.group(1) if d else '?'}>"
        elif fn and "spill stores" in line:
            spill = line.split(",", 1)[1].strip()
        elif fn and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            rows.append(f"{fn}: {regs} registers, {spill}")
            fn = None
    return rows


def phase_flash_backward(torch, np, FA, ptxas_log: str = "") -> dict:
    """Phase 22: the forward's lse and the three backward kernels (delta,
    dK / dV, dQ) against the plain versions on the same out and lse, over
    FLASH_BWD_CASES in f32 and bf16 (BWD_KERNELS launches a call, a second
    call bit for bit the first), each output within ``flash_bwd_ratio``'s
    limit; then at olmo-1b's training shape, causal, in f32 and bf16 on the
    same inputs: the forward's out and lse and the backward checked (and
    repeated bit for bit), and the bf16 backward timed whole and kernel by
    kernel (dK / dV, dQ) beside the plain backward, SDPA's backward (its
    forward + backward less its forward) and the bound; ptxas's registers
    and spills of the backward kernels."""
    rng = np.random.default_rng(SEED + 22)
    worst, ratio, bad, cases = 0.0, 0.0, [], 0
    copies = FA.copies
    for case in FLASH_BWD_CASES:
        b, h, hkv, sq, skv, d, causal, window, softcap, q_offset = case
        amp = 4.0 if softcap else 1.0
        kept = flash_bwd_kept(torch, sq, skv, h // hkv, causal, window,
                              q_offset, "cuda")
        for dtype in ("float32", "bfloat16"):
            q, k, v, do = (
                torch.from_numpy(rng.standard_normal(shape) * a).to(
                    "cuda", getattr(torch, dtype))
                for shape, a in (((b, h, sq, d), amp),
                                 ((b, hkv, skv, d), amp),
                                 ((b, hkv, skv, d), 1.0),
                                 ((b, h, sq, d), 1.0)))
            kw = dict(causal=causal, window=window, softcap=softcap,
                      q_offset=q_offset)
            _, lse = FA.flash_attention_cuda(q, k, v, with_lse=True, **kw)
            out, plse = FA.flash_attention_plain_lse(q, k, v, **kw)
            lse_ok = _lse_close(torch, lse, plse)
            before = FA.bwd_launches
            got = FA.flash_attention_backward_cuda(q, k, v, out, plse, do,
                                                   **kw)
            launched = FA.bwd_launches - before
            again = FA.flash_attention_backward_cuda(q, k, v, out, plse, do,
                                                     **kw)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            want = FA.flash_attention_backward_plain(q, k, v, out, plse, do,
                                                     **kw)
            r, err = flash_bwd_ratio(got, want, kept, dtype)
            worst, ratio = max(worst, err), max(ratio, r)
            if not (r <= 1.0 and lse_ok and same
                    and launched == FA.BWD_KERNELS):
                bad.append((case, dtype, err, r, lse_ok, same, launched))
            cases += 1
    print(f"[22] flash backward vs plain: {cases} cases (f32 and bf16), "
          f"lse and +inf rows equal, max |err| {worst:.3e}, worst |err| / "
          f"limit {ratio:.4f} (f32 {FLASH_TOL['float32']} + "
          f"{FLASH_TOL['float32']} |plain|; bf16 {FLASH_BWD_TOL_BF16} over "
          f"the kept pairs), {FA.BWD_KERNELS} launches a call, repeat calls "
          f"bit for bit equal", flush=True)
    if bad:
        raise AssertionError(f"flash backward disagrees: {bad}")

    b, h, hkv, s, _, d = FLASH_TRAIN_SHAPE
    kept = flash_bwd_kept(torch, s, s, h // hkv, device="cuda")
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, n, s, d), dtype=np.float32)).to("cuda", torch.bfloat16)
        for n in (h, hkv, hkv, h))
    for dtype in ("float32", "bfloat16"):
        x = [t.to(getattr(torch, dtype)) for t in (q, k, v)]
        got_out, lse = FA.flash_attention_cuda(*x, causal=True,
                                               with_lse=True)
        out, plse = FA.flash_attention_plain_lse(*x, causal=True)
        tol = (FLASH_SERVE_TOL_BF16 if dtype == "bfloat16" else
               dict(atol=FLASH_TOL["float32"], rtol=FLASH_TOL["float32"]))
        n = kept[0] if dtype == "bfloat16" else torch.ones_like(kept[0])
        out_ratio = float(((got_out.float() - out.float()).abs()
                           / flash_serve_limit(out, n, **tol)).max())
        lse_ok = _lse_close(torch, lse, plse)
        lse_err = float((lse - plse).abs().max())
        del got_out, lse
        dout = do.to(x[0].dtype)
        got = FA.flash_attention_backward_cuda(*x, out, plse, dout)
        same = all(torch.equal(g, a) for g, a in zip(
            got, FA.flash_attention_backward_cuda(*x, out, plse, dout)))
        want = FA.flash_attention_backward_plain(*x, out, plse, dout)
        r, err = flash_bwd_ratio(got, want, kept, dtype)
        print(f"[22] flash at b={b} h={h} s={s} d={d} {dtype} causal, "
              f"kernel vs plain: forward out worst |err| / limit "
              f"{out_ratio:.4f}, lse max |err| {lse_err:.3e}; backward max "
              f"|err| {err:.3e}, worst |err| / limit {r:.4f}, repeat call "
              f"bit for bit {same}", flush=True)
        if not (out_ratio <= 1.0 and lse_ok and r <= 1.0 and same):
            raise AssertionError(
                f"flash at the training shape, {dtype}: out {out_ratio}, "
                f"lse {lse_err}, backward {err} ({r} of its limit), "
                f"repeat equal {same}")
        worst = max(worst, err)
        del x, dout, got, want
    copies = FA.copies - copies
    ms = _time_ms(lambda: FA.flash_attention_backward_cuda(q, k, v, out,
                                                           plse, do),
                  reps=5, warmup=1)
    launch, _ = FA.backward_launcher(q, k, v, out, plse, do)
    launch(FA.BWD_DELTA)  # the workspace the other two read
    dkdv_ms = _time_ms(lambda: launch(FA.BWD_DKDV), reps=5, warmup=1)
    dq_ms = _time_ms(lambda: launch(FA.BWD_DQ), reps=5, warmup=1)
    del launch
    plain_ms = _time_ms(lambda: FA.flash_attention_backward_plain(
        q, k, v, out, plse, do), reps=2, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    live = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(*live, is_causal=True), live, do)

    with torch.no_grad():
        sdpa_fwd = _time_ms(lambda: sdpa(q, k, v, is_causal=True), reps=10,
                            warmup=2)
    library_ms = _time_ms(sdpa_fwd_bwd, reps=10, warmup=2) - sdpa_fwd
    bound_ms, bound_by = _flash_bwd_bound(b, h, hkv, s, s, d, 2)
    per_product = 2.0 * d * b * h * (s * (s + 1) // 2)
    print(f"[22] flash backward at b={b} h={h} s={s} d={d} bf16 causal: "
          f"times (ms, median of CUDA events): kernel {ms:.4f} (dK / dV "
          f"kernel {dkdv_ms:.4f}, dQ kernel {dq_ms:.4f}, delta the rest)  "
          f"plain {plain_ms:.4f}  library(sdpa backward = fwd+bwd - fwd) "
          f"{library_ms:.4f}  bound {bound_ms:.4f} ({bound_by}); TFLOP/s "
          f"over the kept pairs: "
          + ", ".join(f"{per_product * n / ms / 1e9:.3f} on {n} products"
                      for n in (5, 7, 10))
          + f" (5: the bound's; 7: with S and dP recomputed by both "
          f"kernels; 10: as issued, P and dS as bf16 hi + lo); "
          f"{ms / bound_ms:.1f}x the bound, {ms / library_ms:.2f}x SDPA's "
          f"backward; TMA copies {copies}", flush=True)
    for row in _ptxas_kernels(ptxas_log, (
            "flash_bwd_dkdv_bf16_kernel", "flash_bwd_dq_bf16_kernel",
            "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
            "flash_bwd_delta_kernel")):
        print(f"[22]   ptxas {row}", flush=True)
    if copies:
        raise AssertionError(f"the backward copied {copies} inputs for TMA")
    del q, k, v, do, out, plse, live
    torch.cuda.empty_cache()
    return dict(bwd_ms=ms, bwd_plain_ms=plain_ms, bwd_bound_ms=bound_ms,
                bwd_library_ms=library_ms, bwd_max_abs_err=worst,
                bwd_dkdv_ms=dkdv_ms, bwd_dq_ms=dq_ms)


# phase 23: one training step of reduced models (f32) on the card against
# the same step on the CPU; gemma2 adds the window, both softcaps and the
# post-norms
TRAIN_ARCHS = ("olmo-1b", "gemma2-27b")
TRAIN_TOL = 1e-4
# AdamW's first step moves an entry by lr * g / (|g| + eps): where |g| is
# f32 rounding noise (below 1e-6, a hundred times eps) two summation
# orders may move it differently, by up to 2 lr (tests/test_torch_cuda.py)
NOISE_RMS = 1e-6


def train_state_close(torch, got, want, lr: float, b2: float,
                      tol: float = TRAIN_TOL) -> tuple[bool, dict]:
    """(params, opt_state) after one step against another run's: mu and nu
    within tol (+ tol relative), params too except entries whose gradient
    RMS sqrt(nu_hat) is below NOISE_RMS, held to 2 lr; the worst error of
    each tree."""
    from repro_torch.optim.tree import leaves

    (gp, gs), (wp, ws) = got, want
    t = int(ws["step"])
    worst, ok = {"params": 0.0, "mu": 0.0, "nu": 0.0}, True
    for name, gt, wt in (("mu", gs["mu"], ws["mu"]),
                         ("nu", gs["nu"], ws["nu"])):
        for g, w in zip(leaves(gt), leaves(wt)):
            d = (g.float().cpu() - w.float().cpu()).abs()
            worst[name] = max(worst[name], float(d.max()))
            ok &= bool((d <= tol + tol * w.float().cpu().abs()).all())
    for g, w, nu in zip(leaves(gp), leaves(wp), leaves(ws["nu"])):
        w = w.float().cpu()
        d = (g.float().cpu() - w).abs()
        noisy = torch.sqrt(nu.float().cpu() / (1 - b2**t)) < NOISE_RMS
        limit = torch.where(noisy, 2 * lr * t, tol + tol * w.abs())
        worst["params"] = max(worst["params"],
                              float(torch.where(noisy, 0.0, d).max()))
        ok &= bool((d <= limit).all())
    return ok, worst


def phase_train_cuda_vs_cpu(torch, np, T, FA, get_arch) -> None:
    """Phase 23: reduced olmo-1b and gemma2-27b (f32), one step of
    ``launch.steps.build_train_step`` from the same parameters and batch
    on the card and on the CPU, under remat none, full and dots: loss and
    grad norm within 1e-4, every leaf of params, mu and nu within
    ``train_state_close``; flash launches per attention layer 1 (none) or
    2 (full, dots: the recompute runs the kernel again; dots keeps only
    the 2-D matmuls), backward launches BWD_KERNELS a layer."""
    from repro_torch.config import ShapeConfig
    from repro_torch.data import DataConfig, SyntheticLMData, make_global_batch
    from repro_torch.launch import steps as ST
    from repro_torch.optim import AdamWConfig

    opt = AdamWConfig(lr=3e-3)
    seq, batch = 192, 2
    for arch in TRAIN_ARCHS:
        cfg = get_arch(arch).reduced()
        p_cpu = T.init_params(cfg, SEED, device="cpu")
        data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                          global_batch=batch, seed=SEED))
        n_attn = sum(k["mixer"] == "attention" for k in T.layer_kinds(cfg))
        for remat in ("none", "full", "dots"):
            options = ST.StepOptions(remat=remat, loss_chunk=64)
            shape = ShapeConfig("train", seq, batch, "train")
            runs = {}
            for dev in ("cpu", "cuda"):
                params = _tree_to(p_cpu, dev)
                state = ST.init_opt_state(params, opt, options)
                step = ST.build_train_step(cfg, shape, opt=opt,
                                           options=options, device=dev)
                before = (FA.launches, FA.bwd_launches)
                p, st, m = step(params, state,
                                make_global_batch(data, 0, dev))
                runs[dev] = (p, st, m, FA.launches - before[0],
                             FA.bwd_launches - before[1])
            pc, sc, mc, *_ = runs["cpu"]
            pd, sd, md, fwd, bwd = runs["cuda"]
            ok, worst = train_state_close(torch, (pd, sd), (pc, sc), opt.lr,
                                          opt.b2)
            m_err = max(abs(float(md[n]) - float(mc[n]))
                        for n in ("loss", "grad_norm"))
            want = (n_attn * (1 if remat == "none" else 2),
                    n_attn * FA.BWD_KERNELS)
            print(f"[23] reduced {arch} f32 ({cfg.n_layers} layers, "
                  f"{batch} x {seq} tokens), remat {remat}: one step cuda "
                  f"vs cpu, loss {float(md['loss']):.6f} vs "
                  f"{float(mc['loss']):.6f}, max |loss, grad_norm err| "
                  f"{m_err:.3e}, max |err| params {worst['params']:.3e} "
                  f"mu {worst['mu']:.3e} nu {worst['nu']:.3e} (tolerance "
                  f"{TRAIN_TOL}); flash launches forward {fwd} backward "
                  f"{bwd} (want {want[0]}, {want[1]})", flush=True)
            if not (ok and m_err <= TRAIN_TOL) or (fwd, bwd) != want:
                raise AssertionError(f"{arch} remat {remat}: training step "
                                     f"on cuda vs cpu, {worst}, {m_err}, "
                                     f"launches {(fwd, bwd)}")
            del runs, pc, sc, pd, sd


# phase 24: olmo-1b at full width and depth trained through the entry
# point, bf16, 10 steps of 8 x 2,048 tokens at the reference's defaults
TRAIN_STEPS = 10
TRAIN_ARGV = ["--arch", "olmo-1b", "--seq-len", "2048", "--global-batch",
              "8", "--steps", str(TRAIN_STEPS), "--remat", "full",
              "--log-every", "1", "--seed", str(SEED)]
RESUME_ARGV = ["--arch", "olmo-1b", "--reduced", "--seq-len", "128",
               "--global-batch", "4", "--log-every", "4", "--seed",
               str(SEED)]


def phase_train(torch, np, T, FA, get_arch, card: str) -> dict:
    """Phase 24: (a) ``repro_torch.launch.train.run`` on full olmo-1b, the
    flash counts set to 0 just before and read just after: finite losses,
    the last below the first, flash forward launches 16 x 2 x 10 (remat
    full runs each layer's forward twice), backward launches 16 x
    BWD_KERNELS x 10, no TMA copy; step time (median of steps 2-10),
    tokens/s, peak memory and the model-FLOP share.  (b) one step of the
    same model under torch.profiler, device time by group and the idle
    share.  (c) resume at the reduced size: 4 steps with a checkpoint,
    then a second launch to 8, against one 8-step run within 1e-6."""
    import tempfile

    from repro_torch.config import ShapeConfig
    from repro_torch.data import DataConfig, SyntheticLMData, make_global_batch
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train
    from repro_torch.models import layers as L
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.tree import leaves

    cfg = get_arch("olmo-1b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    FA.launches = FA.bwd_launches = FA.copies = 0
    run = train.run(TRAIN_ARGV)
    fwd, bwd, copies = FA.launches, FA.bwd_launches, FA.copies
    peak = torch.cuda.max_memory_allocated()
    losses = run["losses"]
    want = (cfg.n_layers * 2 * TRAIN_STEPS,
            cfg.n_layers * FA.BWD_KERNELS * TRAIN_STEPS)
    step_ms = 1e3 * statistics.median(run["step_s"][1:])
    b, s = 8, 2048
    print(f"[24] olmo-1b full width and depth ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, bf16, AdamW f32 moments, lr 3e-3, remat "
          f"full), {TRAIN_STEPS} steps of {b} x {s} tokens through "
          f"launch.train: losses " + ", ".join(f"{x:.4f}" for x in losses)
          + "; grad norms " + ", ".join(f"{x:.3f}" for x in run["grad_norms"])
          + f"; flash launches forward {fwd} backward {bwd} (want "
          f"{want[0]}, {want[1]}), TMA copies {copies}", flush=True)
    if not (run["rc"] == 0 and len(losses) == TRAIN_STEPS
            and all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"olmo-1b training: rc {run['rc']}, losses "
                             f"{losses}")
    if (fwd, bwd) != want or copies:
        raise AssertionError(f"olmo-1b training launched flash {fwd} / "
                             f"{bwd} times (want {want}), {copies} copies")
    run_first_s = run["step_s"][0]
    del run

    # (b) one step under the profiler, on the same model and data
    opt = AdamWConfig(lr=3e-3)
    options = ST.StepOptions(remat="full", loss_chunk=512)
    step = ST.build_train_step(cfg, ShapeConfig("train", s, b, "train"),
                               opt=opt, options=options, device="cuda")
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                           device="cuda")
    n_params = sum(t.numel() for t in leaves(params))
    pairs = b * cfg.n_heads * (s * (s + 1) // 2)
    model_flops = (6.0 * n_params * b * s
                   + 3 * 4.0 * cfg.hd * pairs * cfg.n_layers)
    mfu = model_flops / (step_ms / 1e3) / PEAK_BF16_FLOPS
    print(f"[24] on {card}: {n_params / 1e9:.4f} B parameters; step ms "
          f"median (steps "
          f"2-{TRAIN_STEPS}) {step_ms:.2f}, first step "
          f"{1e3 * run_first_s:.2f} ms; {b * s / step_ms * 1e3:.1f} "
          f"tokens/s; peak memory {peak / 2**30:.2f} GiB; model FLOPs a "
          f"step {model_flops:.4e} (6 N T + 3 x attention's 4 d per kept "
          f"pair; remat's recompute not counted), share of "
          f"{PEAK_BF16_FLOPS:.3e} FLOP/s {mfu:.4f}", flush=True)
    state = ST.init_opt_state(params, opt, options)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=s,
                                      global_batch=b, seed=SEED))
    box = {"p": params, "s": state}
    del params, state

    def one(i):
        box["p"], box["s"], m = step(box["p"], box["s"],
                                     make_global_batch(data, i, "cuda"))
        float(m["loss"])

    one(0)
    spans = {"cross_entropy": "cross_entropy", "adamw": "adamw"}
    with _Spans(torch, [(L, "_ce_chunk", "cross_entropy"),
                        (ST, "adamw_update", "adamw")]):
        wall, groups, n_kernels = _span_profile(torch, lambda: one(1),
                                                spans)
    busy = sum(groups.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time in a step")
    print(f"[24] one step under torch.profiler: wall {wall:.2f} ms, device "
          f"busy {busy:.2f} ms, idle share {1 - busy / wall:.4f}, "
          f"{n_kernels} kernels; device ms by group: "
          + ", ".join(f"{k} {v:.2f}" for k, v in groups.items())
          + " (matmul: every cuBLAS GEMM, the logits' too; flash / flash_bwd:"
          " the kernels; cross_entropy: the chunks' non-GEMM forward and "
          "recompute; adamw: the update; other: the rest, the chunks' "
          "backward included)", flush=True)
    del box, step
    torch.cuda.empty_cache()

    # (c) resume equals an uninterrupted run, at the reduced size
    with tempfile.TemporaryDirectory() as tmp:
        whole = train.run([*RESUME_ARGV, "--steps", "8"])
        first = train.run([*RESUME_ARGV, "--steps", "4", "--ckpt-dir", tmp,
                           "--ckpt-every", "2"])
        second = train.run([*RESUME_ARGV, "--steps", "8", "--ckpt-dir",
                            tmp])
    resumed = first["losses"] + second["losses"]
    err = max(abs(x - y) for x, y in zip(resumed, whole["losses"]))
    print(f"[24] resume (reduced olmo-1b f32 on the card, 4 x 128 tokens): "
          f"4 steps, checkpoint, resume from step {second['start_step']} to "
          f"8; max |loss - uninterrupted| {err:.3e} (limit 1e-6)",
          flush=True)
    if not (second["start_step"] == 4 and len(resumed) == 8
            and err <= 1e-6):
        raise AssertionError(f"resume differs: {resumed} vs "
                             f"{whole['losses']}")
    return dict(fwd_launches=fwd, bwd_launches=bwd, step_ms=step_ms,
                losses=losses, mfu=mfu, tokens_s=b * s / step_ms * 1e3)


# phase 25: sharded training on meshes of ranks on the one card
SHARD_CASES = (  # (arch, mesh, options) for (a), reduced, f32
    ("olmo-1b", (2, 2), dict(remat="none")),
    ("olmo-1b", (2, 2), dict(remat="full")),
    ("gemma2-27b", (2, 2), dict(remat="dots")),
    ("qwen1.5-4b", (2, 2), dict(remat="full")),
    ("olmo-1b", (2, 1, 2), dict(remat="full", head_2p5d=True)),
    ("gemma2-27b", (2, 1, 2), dict(remat="none", head_2p5d=True)),
    ("olmo-1b", (2, 2), dict(remat="full", zero1=True)),
    ("olmo-1b", (2, 2), dict(remat="full", microbatch=2)),
    ("olmo-1b", (2, 2), dict(remat="full", compress_grads=True)),
    ("gemma2-27b", (2, 2), dict(remat="full", seq_parallel=True)),
)
SHARD_ARGV = [*TRAIN_ARGV, "--mesh", "2x2"]
SHARD_RESUME_ARGV = ["--arch", "olmo-1b", "--reduced", "--seq-len", "128",
                     "--global-batch", "4", "--log-every", "4", "--seed",
                     str(SEED)]
HEAD_SHAPE = dict(t=16384, d=2048, v=50304)  # olmo's LM head, 8 x 2,048


def _mesh_of(mesh_mod, dims, device="cuda"):
    names = ("pod", "data", "model") if len(dims) == 3 else ("data",
                                                              "model")
    return mesh_mod.make_mesh(dims, names, device)


def _state_bytes(torch, SH, mesh, shapes, specs) -> float:
    """Bytes the sharded state takes on the card: every distinct shard
    of every leaf once (replicas on one device share it)."""
    from repro_torch.optim.tree import leaves

    total = 0.0
    for leaf, spec in zip(leaves(shapes), leaves(specs)):
        n = {SH.chunk_index(mesh, spec, r) for r in range(mesh.size)}
        item = torch.empty((), dtype=leaf.dtype).element_size()
        total += len(n) * item * math.prod(SH.local_shape(leaf.shape,
                                                          spec, mesh))
    return total


def phase_sharded_train(torch, np, T, FA, get_arch, mesh_mod, card: str,
                        first_loss: float) -> dict:
    """Phase 25 (see the module docstring): (a) the sharded step against
    the one-device step on the card, (b) olmo-1b at full width and depth
    through ``launch.train.run`` on a 2 x 2 mesh of ranks, (c) the 2.5D
    LM head.  Returns (b)'s numbers and launch counts."""
    import tempfile

    from repro_torch.config import ShapeConfig
    from repro_torch.core import transport as TR
    from repro_torch.data import DataConfig, SyntheticLMData, make_global_batch
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.tree import leaves
    from repro_torch.parallel import runtime as RT
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.matmul_2p5d import (
        gather_2p5d,
        matmul_2p5d,
        place_2p5d,
        plan_2p5d,
    )

    # (a) the sharded step against the one-device step, reduced, f32
    opt = AdamWConfig(lr=3e-3)
    seq, batch = 192, 4
    shape = ShapeConfig("train", seq, batch, "train")
    for arch, dims, kw in SHARD_CASES:
        cfg = get_arch(arch).reduced()
        mesh = _mesh_of(mesh_mod, dims)
        options = ST.StepOptions(loss_chunk=64, **kw)
        params = T.init_params(cfg, SEED, device="cuda")
        data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                          global_batch=batch, seed=SEED))
        one = ST.build_train_step(cfg, shape, opt=opt, options=options,
                                  device="cuda")
        p1, s1, m1 = one(params, ST.init_opt_state(params, opt, options),
                         make_global_batch(data, 0, "cuda"))
        step = ST.build_train_step(cfg, shape, opt=opt, options=options,
                                   device="cuda", mesh=mesh)
        p2, s2 = ST.init_sharded(cfg, mesh, params, opt, options)
        _, _, p_spec, o_spec = ST.abstract_state(cfg, mesh, opt, options)
        FA.launches = FA.bwd_launches = 0
        TR.reset_bytes()
        p2, s2, m2 = step(p2, s2, make_global_batch(data, 0, mesh))
        moved, fwd, bwd = TR.bytes_moved(), FA.launches, FA.bwd_launches
        count = ST.step_bytes(cfg, mesh, shape, options, opt)
        got = (SH.unshard_tree(mesh, p2, p_spec),
               {"mu": SH.unshard_tree(mesh, s2["mu"], o_spec["mu"]),
                "nu": SH.unshard_tree(mesh, s2["nu"], o_spec["nu"]),
                "step": s2["step"]})
        ok, worst = train_state_close(torch, got, (p1, s1), opt.lr, opt.b2)
        m_err = max(abs(float(m2[n]) - float(m1[n]))
                    for n in ("loss", "grad_norm"))
        n_attn = sum(k["mixer"] == "attention" for k in T.layer_kinds(cfg))
        k = options.microbatch
        want = (mesh.size * k * n_attn * (1 if options.remat == "none"
                                          else 2),
                mesh.size * k * n_attn * FA.BWD_KERNELS)
        flags = ", ".join(f"{a}={v}" for a, v in kw.items())
        print(f"[25a] reduced {arch} f32 on {dict(mesh.shape)} ({flags}): "
              f"loss {float(m2['loss']):.6f} vs one device "
              f"{float(m1['loss']):.6f}, max |loss, grad_norm err| "
              f"{m_err:.3e}, max |err| params {worst['params']:.3e} mu "
              f"{worst['mu']:.3e} nu {worst['nu']:.3e} (tolerance "
              f"{TRAIN_TOL}); bytes per rank {moved:.0f} (count from the "
              f"specs {count:.0f}); flash launches forward {fwd} backward "
              f"{bwd} (want {want[0]}, {want[1]})", flush=True)
        if not (ok and m_err <= TRAIN_TOL) or moved != count or (
                fwd, bwd) != want:
            raise AssertionError(f"sharded {arch} {dims} {kw}: {worst}, "
                                 f"{m_err}, bytes {moved} vs {count}, "
                                 f"launches {(fwd, bwd)} vs {want}")
        del p1, s1, p2, s2, got, params
    torch.cuda.empty_cache()

    # (b) olmo-1b at full width and depth on a 2 x 2 mesh of ranks
    cfg = get_arch("olmo-1b")
    b, s = 8, 2048
    mesh = _mesh_of(mesh_mod, (2, 2))
    options = ST.StepOptions(remat="full", loss_chunk=512)
    shape = ShapeConfig("train", s, b, "train")
    opt = AdamWConfig(lr=3e-3)
    p_shape, o_shape, p_spec, o_spec = ST.abstract_state(cfg, mesh, opt,
                                                         options)
    state = sum(_state_bytes(torch, SH, mesh, sh, sp) for sh, sp in (
        (p_shape, p_spec), (o_shape["mu"], o_spec["mu"]),
        (o_shape["nu"], o_spec["nu"])))
    count = ST.step_bytes(cfg, mesh, shape, options, opt)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    FA.launches = FA.bwd_launches = FA.copies = 0
    TR.reset_bytes()
    run = train.run(SHARD_ARGV)
    fwd, bwd, copies = FA.launches, FA.bwd_launches, FA.copies
    moved = TR.bytes_moved() / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = run["losses"]
    want = (mesh.size * cfg.n_layers * 2 * TRAIN_STEPS,
            mesh.size * cfg.n_layers * FA.BWD_KERNELS * TRAIN_STEPS)
    step_ms = 1e3 * statistics.median(run["step_s"][1:])
    n_params = cfg.param_count()
    pairs = b * cfg.n_heads * (s * (s + 1) // 2)
    model_flops = (6.0 * n_params * b * s
                   + 3 * 4.0 * cfg.hd * pairs * cfg.n_layers)
    mfu = model_flops / (step_ms / 1e3) / PEAK_BF16_FLOPS
    print(f"[25b] olmo-1b full width and depth on {dict(mesh.shape)} "
          f"ranks of one card (bf16, remat full, lr 3e-3), {TRAIN_STEPS} "
          f"steps of {b} x {s} tokens through launch.train --mesh 2x2: "
          "losses " + ", ".join(f"{x:.4f}" for x in losses)
          + "; grad norms " + ", ".join(f"{x:.3f}" for x in run["grad_norms"])
          + f"; step 1's loss vs phase 24's {first_loss:.4f}: |diff| "
          f"{abs(losses[0] - first_loss):.3e} (limit 1e-2); flash launches "
          f"forward {fwd} backward {bwd} (want {want[0]}, {want[1]}), TMA "
          f"copies {copies}", flush=True)
    print(f"[25b] on {card}: step ms median (steps 2-{TRAIN_STEPS}) "
          f"{step_ms:.2f}, first step {1e3 * run['step_s'][0]:.2f} ms; "
          f"{b * s / step_ms * 1e3:.1f} tokens/s; model-FLOP share "
          f"{mfu:.4f} (phase 24's formula); peak memory "
          f"{peak / 2**30:.2f} GiB, the state the specs place (params, mu, "
          f"nu; each distinct shard once) {state / 2**30:.2f} GiB; bytes "
          f"per rank per step {moved:.0f} (count from the specs "
          f"{count:.0f})", flush=True)
    if not (run["rc"] == 0 and len(losses) == TRAIN_STEPS
            and all(np.isfinite(losses)) and losses[-1] < losses[0]
            and abs(losses[0] - first_loss) <= 1e-2):
        raise AssertionError(f"sharded olmo-1b training: rc {run['rc']}, "
                             f"losses {losses} (phase 24: {first_loss})")
    if (fwd, bwd) != want or copies or moved != count:
        raise AssertionError(f"sharded olmo-1b: flash {fwd} / {bwd} (want "
                             f"{want}), {copies} copies, bytes {moved} vs "
                             f"{count}")
    del run

    # one step under the profiler, by group, the collectives their own
    step = ST.build_train_step(cfg, shape, opt=opt, options=options,
                               device="cuda", mesh=mesh)
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                           device="cuda")
    box = dict(zip("ps", ST.init_sharded(cfg, mesh, params, opt, options)))
    del params
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=s,
                                      global_batch=b, seed=SEED))

    def one(i):
        box["p"], box["s"], m = step(box["p"], box["s"],
                                     make_global_batch(data, i, mesh))
        float(m["loss"])

    one(0)
    spans = {"cross_entropy": "cross_entropy", "adamw": "adamw",
             "collectives": "collectives"}
    targets = [(RT.DecoderRuntime, "_ce_chunk", "cross_entropy"),
               (ST, "adamw_update", "adamw")]
    targets += [(TR, n, "collectives") for n in
                ("psum", "psum_scatter", "all_gather", "all_to_all", "pmax")]
    with _Spans(torch, targets):
        wall, groups, n_kernels = _span_profile(torch, lambda: one(1), spans)
    busy = sum(groups.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time in a step")
    print(f"[25b] one sharded step under torch.profiler: wall {wall:.2f} "
          f"ms, device busy {busy:.2f} ms, idle share {1 - busy / wall:.4f}"
          f", {n_kernels} kernels; device ms by group: "
          + ", ".join(f"{k} {v:.2f}" for k, v in groups.items())
          + " (collectives: the copies and sums of the psums, gathers and "
          "scatters between the ranks' tensors)", flush=True)
    del box, step
    torch.cuda.empty_cache()

    # a 2 x 2 checkpoint resumed on 1 x 1, against the same run without
    # the round trip through the disk, at the reduced size
    rcfg = get_arch("olmo-1b").reduced()
    rshape = ShapeConfig("train", 128, 4, "train")
    ropts = ST.StepOptions(remat="full", loss_chunk=128)
    rmesh = _mesh_of(mesh_mod, (2, 2))
    rdata = SyntheticLMData(DataConfig(vocab=rcfg.vocab, seq_len=128,
                                       global_batch=4, seed=SEED))
    p = T.init_params(rcfg, torch.Generator("cuda").manual_seed(SEED),
                      device="cuda")
    p, st = ST.init_sharded(rcfg, rmesh, p, opt, ropts)
    sharded = ST.build_train_step(rcfg, rshape, opt=opt, options=ropts,
                                  device="cuda", mesh=rmesh)
    single = ST.build_train_step(rcfg, rshape, opt=opt, options=ropts,
                                 device="cuda")
    _, _, rp_spec, ro_spec = ST.abstract_state(rcfg, rmesh, opt, ropts)
    mem = []
    for i in range(4):
        p, st, m = sharded(p, st, make_global_batch(rdata, i, rmesh))
        mem.append(float(m["loss"]))
    p, st = SH.unshard_tree(rmesh, p, rp_spec), SH.unshard_tree(
        rmesh, st, ro_spec)
    for i in range(4, 8):
        p, st, m = single(p, st, make_global_batch(rdata, i, "cuda"))
        mem.append(float(m["loss"]))
    with tempfile.TemporaryDirectory() as tmp:
        first = train.run([*SHARD_RESUME_ARGV, "--mesh", "2x2", "--steps",
                           "4", "--ckpt-dir", tmp, "--ckpt-every", "4"])
        second = train.run([*SHARD_RESUME_ARGV, "--steps", "8",
                            "--ckpt-dir", tmp])
    resumed = first["losses"] + second["losses"]
    err = max(abs(x - y) for x, y in zip(resumed, mem))
    print(f"[25b] elastic restart (reduced olmo-1b f32, 4 x 128 tokens): 4 "
          f"steps on 2 x 2, checkpoint, resume on 1 x 1 from step "
          f"{second['start_step']} to 8; max |loss - the same run without "
          f"the round trip| {err:.3e} (limit 1e-6)", flush=True)
    if not (second["start_step"] == 4 and len(resumed) == 8
            and err <= 1e-6):
        raise AssertionError(f"2x2 -> 1x1 resume differs: {resumed} vs "
                             f"{mem}")

    # (c) the 2.5D LM head at olmo's training shape, bf16
    t, d, v = HEAD_SHAPE["t"], HEAD_SHAPE["d"], HEAD_SHAPE["v"]
    hmesh = mesh_mod.make_mesh((2, 2), ("pod", "model"), "cuda")
    g = torch.Generator("cuda").manual_seed(SEED)
    x = torch.randn((t, d), generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn((d, v), generator=g, device="cuda") * d**-0.5).to(
        torch.bfloat16)
    xs, ws = place_2p5d(hmesh, x, w)
    TR.reset_bytes()
    with torch.no_grad():
        out = matmul_2p5d(hmesh, xs, ws, reduce="scatter")
    moved = TR.bytes_moved()
    plan = plan_2p5d(tokens=t, d_model=d, vocab=v, l=2, tp=2,
                     bytes_per_el=2)
    full = x @ w
    ok, err = _close(gather_2p5d(hmesh, out, reduce="scatter"), full,
                     TOL["bfloat16"])
    del out
    # baseline: each (pod, model) rank all-gathers its d-sharded weight
    # block over pod and multiplies its own token rows by it
    rows = place_2p5d(hmesh, x, w)[1]
    x_rows = [x.chunk(2, dim=0)[hmesh.coords(r)[0]] for r in range(4)]

    def base():
        wf = TR.all_gather(hmesh, rows, "pod", dim=0)
        return [a @ b for a, b in zip(x_rows, wf)]

    def ours():
        return matmul_2p5d(hmesh, xs, ws, reduce="scatter")

    with torch.no_grad():
        ms_2p5d = _time_ms(ours, reps=5)
        ms_base = _time_ms(base, reps=5)
        ms_mm = _time_ms(lambda: x @ w, reps=5)
    print(f"[25c] 2.5D LM head (T {t}, d {d}, V {v}, bf16) on "
          f"{dict(hmesh.shape)} ranks of one card: max |err| vs one "
          f"torch.matmul {err:.3e} (limit {TOL['bfloat16']} + "
          f"{TOL['bfloat16']} |ref|); bytes per rank {moved:.0f} (plan_2p5d "
          f"{plan.bytes_2p5d:.0f}; the weight all-gather baseline's plan "
          f"{plan.bytes_baseline:.0f}); on {card}: 2.5D {ms_2p5d:.3f} ms "
          f"(4 ranks' partial products and the psum-scatter, in turn), "
          f"all-gather baseline {ms_base:.3f} ms, one torch.matmul "
          f"{ms_mm:.3f} ms", flush=True)
    if not ok or moved != plan.bytes_2p5d:
        raise AssertionError(f"2.5D head: err {err}, bytes {moved} vs "
                             f"{plan.bytes_2p5d}")
    del x, w, xs, ws, full, rows, x_rows
    torch.cuda.empty_cache()
    return dict(fwd_launches=fwd, bwd_launches=bwd, step_ms=step_ms,
                tokens_s=b * s / step_ms * 1e3, mfu=mfu, peak=peak)


# phase 26: the dry run — sharded serving, the tracer against the card, and
# run_cell on the production mesh
SHARD_SERVE = dict(batch=8, prompt=2048, new=32)
# sharded vs one-device logits in bf16: the reference's bf16 tolerance,
# relative to the largest logit (the CPU tests' rule)
SHARD_SERVE_TOL = 3e-2
SHARD_SERVE_GREEDY = 0.90  # the least share of greedy tokens equal
SHARD_F32_TOL = 1e-4  # the same comparison with f32 weights and steps
DRYRUN_CELLS = ("decode_32k", "prefill_32k", "train_4k")


def _unshard_logits(torch, SH, mesh, shards, batch, vocab):
    return SH.unshard(mesh, shards, SH.batch_spec(mesh, batch, 1, vocab))


# the dry run's cells of phase 26 (c), traced in a process of their own
# (host work on ``meta`` tensors; no card): one cell's record per line
DRYRUN_SCRIPT = """
import json, sys, time
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun as DR
t0 = time.perf_counter()
for shape_id in sys.argv[1:]:
    rec = DR.run_cell("olmo_1b", shape_id, "single", DR.parse_options([]),
                      verbose=False)
    print(json.dumps(rec), flush=True)
print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
"""


def start_dryrun_cells() -> subprocess.Popen:
    """Phase 26 (c)'s cells started in a process beside the run (its one
    core of host work overlaps the device-bound phases 17 and 18 instead
    of adding a minute to the command); ``phase_dryrun`` reads them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", DRYRUN_SCRIPT,
                             *DRYRUN_CELLS], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, text=True)


def phase_dryrun(torch, np, T, FA, get_arch, mesh_mod, card: str,
                 trained: dict, sharded_train: dict,
                 cells: subprocess.Popen | None = None) -> dict:
    """Phase 26 (see the module docstring): (a) sharded serving of olmo-1b
    on 2 x 2 ranks against the one-device steps, (b) the dry run's tracer
    against the card on phase 24's and phase 25's steps, (c) the dry run's
    cells of olmo-1b on the single-pod mesh (``cells``: the process
    ``start_dryrun_cells`` started, else started here).  Returns (a)'s
    flash launches."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import roofline as RL
    from repro_torch.config import ShapeConfig
    from repro_torch.core import transport as TR
    from repro_torch.data import DataConfig, SyntheticLMData, make_global_batch
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import steps as ST
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.tree import tree_map
    from repro_torch.parallel import sharding as SH

    # (a) sharded serving: 8 x 2,048-token prompts, then 32 decode steps
    cfg = get_arch("olmo-1b")
    b, s, new = SHARD_SERVE["batch"], SHARD_SERVE["prompt"], SHARD_SERVE["new"]
    depth = s + new
    mesh = _mesh_of(mesh_mod, (2, 2))
    shape = ShapeConfig("serve", depth, b, "prefill")
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                           device="cuda")
    pre1, _ = ST.build_prefill_step(cfg, shape, device="cuda")
    dec1, _ = ST.build_serve_step(cfg, shape, device="cuda")
    pre, (p_sds, _, _) = ST.build_prefill_step(cfg, shape, device="cuda",
                                               mesh=mesh)
    dec, _ = ST.build_serve_step(cfg, shape, device="cuda", mesh=mesh)
    sharded = SH.shard_tree(mesh, params, tree_map(lambda x: x.spec, p_sds))
    cache1 = T.init_cache(cfg, b, depth, device="cuda")
    cache = ST.init_sharded_cache(cfg, mesh, b, depth)
    g = torch.Generator("cuda").manual_seed(SEED + 26)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=g, device="cuda")

    def limit_ok(got, want):
        d = float((got.float() - want.float()).abs().max())
        return d <= SHARD_SERVE_TOL * max(1.0, float(want.float().abs()
                                                     .max())), d

    with torch.no_grad():
        FA.launches = 0
        want, cache1 = pre1(params, cache1, {"tokens": toks})
        one_launches = FA.launches
        torch.cuda.synchronize()
        FA.launches = FA.copies = 0
        t0 = time.perf_counter()
        got, cache = pre(sharded, cache, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches, copies = FA.launches, FA.copies
        ok, err = limit_ok(_unshard_logits(torch, SH, mesh, got, b,
                                           cfg.vocab), want)
        worst, same, total = err, 0, 0
        dec_ms, dec1_ms = [], []
        for i in range(new):
            nxt = torch.argmax(want[:, -1], -1)[:, None]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want, cache1 = dec1(params, cache1, nxt, s + i)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got, cache = dec(sharded, cache, nxt, s + i)
            torch.cuda.synchronize()
            dec1_ms.append(1e3 * (t1 - t0))
            dec_ms.append(1e3 * (time.perf_counter() - t1))
            full = _unshard_logits(torch, SH, mesh, got, b, cfg.vocab)
            ok_i, err_i = limit_ok(full, want)
            ok, worst = ok and ok_i, max(worst, err_i)
            same += int((full[:, -1].argmax(-1) == want[:, -1].argmax(-1))
                        .sum())
            total += b
    want_launches = mesh.size * cfg.n_layers
    print(f"[26a] olmo-1b full width and depth (bf16) served on "
          f"{dict(mesh.shape)} ranks of one card, {b} prompts x {s} tokens "
          f"then {new} decode steps, against the one-device steps on the "
          f"same parameters and tokens: max |logits err| {worst:.3e} "
          f"(limit {SHARD_SERVE_TOL} x max(1, max |logit|)); greedy tokens "
          f"equal {same} of {total} ({same / total:.4f}); flash launches "
          f"{launches} (want {want_launches}: one per rank and layer), "
          f"one-device {one_launches}, TMA copies {copies}", flush=True)
    print(f"[26a] on {card}: sharded prefill {prefill_s:.3f} s, decode "
          f"{statistics.median(dec_ms):.2f} ms a step (median of {new}); "
          f"one device decode {statistics.median(dec1_ms):.2f} ms a step",
          flush=True)
    if not ok or launches != want_launches or copies:
        raise AssertionError(f"sharded serving: err {worst}, launches "
                             f"{launches} (want {want_launches}), copies "
                             f"{copies}")
    del params, sharded, cache, cache1, got, want
    torch.cuda.empty_cache()

    # (b) the tracer against the card: phase 24's 1 x 1 step, phase 25's
    # 2 x 2 step (olmo-1b, 8 x 2,048 tokens, remat full)
    shape = ShapeConfig("train", 2048, 8, "train")
    options = ST.StepOptions(remat="full", loss_chunk=512)
    opt = AdamWConfig(lr=3e-3)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=2048,
                                      global_batch=8, seed=SEED))
    for tag, dims, ms in (("1 x 1", None, trained["step_ms"]),
                          ("2 x 2", (2, 2), sharded_train["step_ms"])):
        mesh = None if dims is None else _mesh_of(mesh_mod, dims)
        # the same ranks on one meta device: replicas shared as on the card
        meta = None if mesh is None else mesh_mod.Mesh(
            mesh.axis_names, mesh.sizes, (torch.device("meta"),) * mesh.size)
        t0 = time.perf_counter()
        cost = DR.trace_cell(cfg, shape, meta, options)
        trace_s = time.perf_counter() - t0
        count = 0.0 if mesh is None else ST.step_bytes(cfg, mesh, shape,
                                                        options, opt)
        report = RL.analyze(cost, n_chips=1,
                            model_flops_total=RL.model_flops(cfg, shape))
        params = T.init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                               device="cuda")
        step = ST.build_train_step(cfg, shape, opt=opt, options=options,
                                   device="cuda", mesh=mesh)
        if mesh is None:
            state = ST.init_opt_state(params, opt, options)
            batch = make_global_batch(data, 0, "cuda")
        else:
            params, state = ST.init_sharded(cfg, mesh, params, opt, options)
            batch = make_global_batch(data, 0, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        TR.reset_bytes()
        with FlopCounterMode(display=False) as fc:
            out = step(params, state, batch)
            float(out[2]["loss"])
        peak = torch.cuda.max_memory_allocated()
        moved = TR.bytes_moved()
        flops = fc.get_total_flops()
        print(f"[26b] olmo-1b training step on {tag} ranks of the card: "
              f"traced FLOPs {cost.flops:.6e} (FlopCounterMode over the "
              f"step on the card {flops:.6e}); traced wire bytes per rank "
              f"{cost.collective_wire_bytes:.0f} (step_bytes {count:.0f}, "
              f"measured {moved:.0f}); traced HBM bytes "
              f"{cost.hbm_bytes:.4e}; traced peak {cost.peak_bytes / 2**30:.2f}"
              f" GiB (arguments {cost.argument_bytes / 2**30:.2f}) beside "
              f"max_memory_allocated {peak / 2**30:.2f} GiB; trace "
              f"{trace_s:.1f} s of host time", flush=True)
        print(f"[26b] on {card}: the roofline of that step on one H100 "
              f"(data-sheet peaks): compute {1e3 * report.compute_s:.2f} ms, "
              f"memory {1e3 * report.memory_s:.2f} ms, collective "
              f"{1e3 * report.collective_s:.2f} ms, bound "
              f"{1e3 * report.bound_s:.2f} ms ({report.dominant}) beside "
              f"the measured step {ms:.2f} ms", flush=True)
        if cost.flops != flops or not (cost.collective_wire_bytes == count
                                       == moved):
            raise AssertionError(f"tracer vs the card on {tag}: FLOPs "
                                 f"{cost.flops} vs {flops}, bytes "
                                 f"{cost.collective_wire_bytes} vs {count} "
                                 f"vs {moved}")
        del params, state, batch, out, step
        torch.cuda.empty_cache()

    # (c) the dry run's olmo-1b cells on the abstract single-pod mesh: host
    # work on ``meta`` tensors, in a process of its own
    t0 = time.perf_counter()
    if cells is None:
        cells = start_dryrun_cells()
    try:
        out, _ = cells.communicate(timeout=600)
    finally:
        cells.kill()
    recs = [json.loads(line) for line in out.splitlines() if line.strip()]
    if cells.returncode or len(recs) != len(DRYRUN_CELLS) + 1:
        raise AssertionError(f"the dry run's process: rc {cells.returncode}"
                             f", {len(recs)} records")
    for shape_id, rec in zip(DRYRUN_CELLS, recs):
        if not rec.get("ok") or rec.get("shape") != shape_id:
            raise AssertionError(f"dry run olmo-1b {shape_id}: {rec}")
        rl = rec["roofline"]
        mem = rl["memory"]
        print(f"[26c] dry run olmo-1b {shape_id} on {rec['mesh_shape']} "
              f"(abstract ranks, H100 data-sheet peaks): trace_s "
              f"{rec['trace_s']}; per device FLOPs "
              f"{rl['flops_per_device']:.4e}, HBM bytes "
              f"{rl['hbm_bytes_per_device']:.4e}, wire bytes "
              f"{rl['collective_bytes_per_device']:.4e}; compute "
              f"{1e3 * rl['compute_s']:.3f} ms, memory "
              f"{1e3 * rl['memory_s']:.3f} ms, collective "
              f"{1e3 * rl['collective_s']:.3f} ms, dominant "
              f"{rl['dominant']}; memory per device: arguments "
              f"{mem['argument_bytes'] / 2**30:.3f} GiB, temporaries "
              f"{mem['temp_bytes'] / 2**30:.3f} GiB, peak "
              f"{mem['peak_bytes'] / 2**30:.3f} GiB of 80", flush=True)
    print(f"[26c] the three cells took {recs[-1]['seconds']:.1f} s in their "
          f"own process; phase 26 waited {time.perf_counter() - t0:.1f} s "
          f"for them", flush=True)
    return dict(fwd_launches=launches + one_launches,
                sharded_launches=launches, one_launches=one_launches,
                prefill_s=prefill_s, decode_ms=statistics.median(dec_ms))


# phase 27: the MoE and hybrid families on 2 x 2 ranks of the card
FAMILY_CASES = (  # (a): (name, arch, MoE impl, layers), reduced, f32
    ("deepseek-moe-16b tp", "deepseek-moe-16b", "tp", None),
    ("deepseek-moe-16b ep", "deepseek-moe-16b", "ep", None),
    ("jamba-v0.1-52b", "jamba-v0.1-52b", "tp", 8),
)
# (b): full width through launch.train --mesh 2x2, depth cut so that the
# AdamW state fits the card (deepseek's 28 layers: 16.9 B parameters, ~200
# GB of weights, gradients and f32 moments; jamba's MoE layer alone 2.82 B)
# (arch, layers, global batch of 2,048-token rows, whether the one-device
# training step fits the card): deepseek's 2.77 B parameters train on one
# device (peak 66.31 GiB, measured on one H100), so every sharded step's
# loss is held to the one-device step's; jamba's 3.67 B would need ~88 GiB
# (AdamW's new state beside the old), so its sharded step 1 is held to
# the one-device loss of the same parameters and batch
FAMILY_TRAIN = (
    ("deepseek-moe-16b", 4, 8, True),
    ("jamba-v0.1-52b", 2, 4, False),
)
FAMILY_TRAIN_STEPS = 5
FAMILY_TRAIN_SEQ = 2048
# AdamW at phase 24's 3e-3 sends the cut deepseek's loss up over five
# steps on one device as on 2 x 2 ranks (12.14 -> 14.09 and 14.02,
# measured on one H100): each step moves every weight by ~lr, a seventh
# of its init scale; 3e-4 is the step the falling-loss check needs
FAMILY_TRAIN_LR = 3e-4
# (c): served on 2 x 2 ranks against the one-device steps: 8 x 256-token
# prompts + 16 decode steps; deepseek at full depth, jamba cut to one
# 8-layer pattern (its 32 layers' 95.8 GiB of weights exceed the card)
FAMILY_SERVE = (("deepseek-moe-16b", None), ("jamba-v0.1-52b", 8))
FAMILY_SERVE_SHAPE = dict(batch=8, prompt=256, new=16)


def _one_ulp_(torch, tree, seed: int) -> None:
    """Every non-zero entry of every leaf moved in place by -1, 0 or +1 in
    its last bit (one ulp of its magnitude; seeded)."""
    from repro_torch.optim.tree import leaves

    g = torch.Generator(leaves(tree)[0].device).manual_seed(seed)
    for t in leaves(tree):
        kind = {2: torch.int16, 4: torch.int32}[t.element_size()]
        bits = t.view(kind)
        step = torch.randint(-1, 2, t.shape, generator=g, device=t.device,
                             dtype=kind)
        bits.add_(step * (t != 0).to(kind))


def _upcast_(tree):
    """Every floating leaf of nested dicts / lists in f32, in place (each
    bf16 leaf freed once its copy exists); returns ``tree``."""
    for k, v in list(tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
        if isinstance(v, (dict, list)):
            _upcast_(v)
        elif v.is_floating_point():
            tree[k] = v.float()
    return tree


def _agree(got: list, want: list) -> tuple[float, float]:
    """(max |logits err| / max(1, max |logit|) over the steps, the share
    of greedy tokens equal) of two runs' per-step logits."""
    worst, same, total = 0.0, 0, 0
    for gl, wl in zip(got, want):
        gl = gl.float().cpu()
        worst = max(worst, float((gl - wl).abs().max())
                    / max(1.0, float(wl.abs().max())))
        same += int((gl[:, -1].argmax(-1) == wl[:, -1].argmax(-1)).sum())
        total += wl.shape[0]
    return worst, same / total


def _shard_in_place(mesh, SH, params, spec) -> dict:
    """``params`` (nested dicts / lists) placed on the ranks by ``spec``
    leaf by leaf, each full leaf freed once its shards exist: the card
    never holds the one-device weights and the shards together."""
    if isinstance(params, dict):
        for k in list(params):
            params[k] = _shard_in_place(mesh, SH, params[k], spec[k])
        return params
    if isinstance(params, list):
        for i in range(len(params)):
            params[i] = _shard_in_place(mesh, SH, params[i], spec[i])
        return params
    return SH.shard(mesh, params, spec)


class _Routing:
    """The one-device run's expert choices, recorded call by call
    (``record``; one call per data rank's rows, ``merge``d), and given
    back to another run, each call its rows (``replay_rows``, one
    device; ``replay``, the sharded run's ranks): the run takes its own
    router weights at those choices.  A bf16 sum in another order flips
    a near-tied choice, and a capacity dispatch spreads the flip over its
    row; a run on the recorded choices compares the numerics alone, as
    the decode steps on the recorded greedy tokens do."""

    def __init__(self, torch, MoE, mesh, batch: int):
        self.torch, self.MoE, self.real = torch, MoE, MoE.router_probs
        d = mesh.axis_names.index("data")
        n = mesh.shape["data"]
        self.groups = [(i * batch // n, (i + 1) * batch // n)
                       for i in range(n)]  # each data rank's rows
        self.rows = [self.groups[mesh.coords(r)[d]]
                     for r in range(mesh.size)]
        self.steps, self.i = [], 0  # each call's choices, layer by layer

    @contextlib.contextmanager
    def _with(self, fn):
        self.MoE.router_probs = fn
        try:
            yield
        finally:
            self.MoE.router_probs = self.real

    def merge(self, n: int) -> None:
        """The last ``n`` recorded calls (one per data rank's rows, in
        order) as one call over all the rows."""
        parts, self.steps = self.steps[-n:], self.steps[:-n]
        self.steps.append([self.torch.cat(layer) for layer in zip(*parts)])

    def record(self):
        """The next one-device call (its layers' choices, in order)."""
        calls = []
        self.steps.append(calls)

        def fn(moe, logits):
            out = self.real(moe, logits)
            calls.append(out[1])
            return out

        return self._with(fn)

    def _forced(self, calls, rows):
        """A router on ``calls``' choices: call i takes ``rows(i)``."""
        torch = self.torch
        self.i = 0

        def fn(moe, logits):
            layer, (lo, hi) = rows(self.i)
            self.i += 1
            te = calls[layer][lo:hi]
            probs = torch.softmax(logits, dim=-1)
            tw = probs.gather(-1, te)
            return tw / torch.clamp(tw.sum(-1, keepdim=True), min=1e-9), \
                te, probs

        return fn

    def replay_rows(self, step: int, lo: int, hi: int):
        """A one-device call over rows [lo, hi) on the choices of recorded
        call ``step``."""
        return self._with(self._forced(self.steps[step],
                                       lambda i: (i, (lo, hi))))

    def replay(self, step: int, forced: bool = True):
        """A sharded call on the choices of recorded call ``step`` (or,
        not ``forced``, on the ranks' own): one router call per rank and
        MoE layer, in rank order."""
        size = len(self.rows)
        fn = self._forced(self.steps[step],
                          lambda i: (i // size, self.rows[i % size]))
        return self._with(fn if forced else self.real)


def phase_families(torch, np, T, FA, get_arch, mesh_mod, card: str) -> dict:
    """Phase 27 (see the module docstring): (a) reduced deepseek-moe-16b
    (tp, ep) and jamba on 2 x 2 ranks of the card against the same steps
    on a CPU mesh, (b) full-width training through ``launch.train --mesh
    2x2`` at cut depths, (c) full-width serving on 2 x 2 ranks against the
    one-device steps.  Returns the flash launch counts."""
    import dataclasses

    from repro_torch.config import ShapeConfig
    from repro_torch.core import transport as TR
    from repro_torch.data import DataConfig, SyntheticLMData, make_global_batch
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train
    from repro_torch.models import moe as MoE
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as SH

    fwd_total = bwd_total = 0

    # (a) reduced, f32: the card's ranks against the CPU's
    opt = AdamWConfig(lr=3e-3)
    seq, batch = 64, 4
    shape = ShapeConfig("train", seq, batch, "train")
    serve_shape = ShapeConfig("serve", 24, batch, "prefill")
    for name, arch, impl, layers in FAMILY_CASES:
        cfg = get_arch(arch).reduced()
        if layers is not None:
            cfg = train.cut_depth(cfg, layers)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl=impl))
        n_attn = sum(k["mixer"] == "attention" for k in T.layer_kinds(cfg))
        options = ST.StepOptions(remat="full", loss_chunk=32)
        p_cpu = T.init_params(cfg, SEED, device="cpu")
        data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                          global_batch=batch, seed=SEED))
        toks = torch.randint(0, cfg.vocab, (batch, 16),
                             generator=torch.Generator().manual_seed(SEED))
        runs = {}
        for dev in ("cpu", "cuda"):
            mesh = _mesh_of(mesh_mod, (2, 2), dev)
            step = ST.build_train_step(cfg, shape, opt=opt, options=options,
                                       device=dev, mesh=mesh)
            p, s = ST.init_sharded(cfg, mesh, _tree_to(p_cpu, dev), opt,
                                   options)
            _, _, p_spec, o_spec = ST.abstract_state(cfg, mesh, opt, options)
            before = (FA.launches, FA.bwd_launches)
            TR.reset_bytes()
            p, s, m = step(p, s, make_global_batch(data, 0, mesh))
            moved = TR.bytes_moved()
            launches = (FA.launches - before[0], FA.bwd_launches - before[1])
            got = (SH.unshard_tree(mesh, p, p_spec),
                   {"mu": SH.unshard_tree(mesh, s["mu"], o_spec["mu"]),
                    "nu": SH.unshard_tree(mesh, s["nu"], o_spec["nu"]),
                    "step": s["step"]})
            pre, (p_sds, _, _) = ST.build_prefill_step(
                cfg, serve_shape, device=dev, mesh=mesh)
            dec, _ = ST.build_serve_step(cfg, serve_shape, device=dev,
                                         mesh=mesh)
            sp = SH.shard_tree(mesh, _tree_to(p_cpu, dev), ST.abstract_state(
                cfg, mesh, None, ST.StepOptions())[2])
            cache = ST.init_sharded_cache(cfg, mesh, batch, 24)
            # the CPU run's greedy tokens feed both runs' decode steps
            nxt = runs["cpu"]["tokens"] if dev == "cuda" else []
            logits = []
            with torch.no_grad():
                lg, cache = pre(sp, cache, {"tokens": toks.to(dev)})
                for i in range(5):
                    logits.append(_unshard_logits(torch, SH, mesh, lg, batch,
                                                  cfg.vocab).float().cpu())
                    if i == 4:
                        break
                    if dev == "cpu":
                        nxt.append(logits[-1][:, -1].argmax(-1)[:, None])
                    lg, cache = dec(sp, cache, nxt[i].to(dev), 16 + i)
            if dev == "cuda":  # training and serving
                fwd_total += FA.launches - before[0]
                bwd_total += FA.bwd_launches - before[1]
            runs[dev] = dict(state=got, metrics=m, moved=moved,
                             launches=launches, logits=logits, tokens=nxt,
                             count=ST.step_bytes(cfg, mesh, shape, options,
                                                 opt))
            del p, s, sp, cache
        c, g = runs["cpu"], runs["cuda"]
        ok, worst = train_state_close(torch, g["state"], c["state"], opt.lr,
                                      opt.b2)
        m_err = max(abs(float(g["metrics"][n]) - float(c["metrics"][n]))
                    for n in ("loss", "ce", "moe_aux", "grad_norm"))
        l_err = max(float((a - b).abs().max()) / max(1.0, float(
            b.abs().max())) for a, b in zip(g["logits"], c["logits"]))
        want = (4 * n_attn * 2, 4 * n_attn * FA.BWD_KERNELS)
        print(f"[27a] reduced {name} f32 ({cfg.n_layers} layers) on 2 x 2 "
              f"ranks, card vs CPU: one training step (remat full, {batch} "
              f"x {seq} tokens): loss {float(g['metrics']['loss']):.6f} vs "
              f"{float(c['metrics']['loss']):.6f}, moe_aux "
              f"{float(g['metrics']['moe_aux']):.6f}, max |loss, ce, "
              f"moe_aux, grad_norm err| {m_err:.3e}, max |err| params "
              f"{worst['params']:.3e} mu {worst['mu']:.3e} nu "
              f"{worst['nu']:.3e}; bytes per rank {g['moved']:.0f} (CPU "
              f"{c['moved']:.0f}, step_bytes {g['count']:.0f}); flash "
              f"launches forward {g['launches'][0]} backward "
              f"{g['launches'][1]} (want {want[0]}, {want[1]}); prefill of "
              f"16 tokens + 4 decode steps: max |logits err| / max(1, "
              f"max |logit|) {l_err:.3e} (tolerance {TRAIN_TOL})",
              flush=True)
        if not (ok and m_err <= TRAIN_TOL and l_err <= TRAIN_TOL) or not (
                g["moved"] == c["moved"] == g["count"]) or (
                g["launches"] != want):
            raise AssertionError(f"{name} on 2 x 2 card ranks vs CPU: "
                                 f"{worst}, {m_err}, {l_err}, bytes "
                                 f"{g['moved']} / {c['moved']} / "
                                 f"{g['count']}, launches {g['launches']}")
        del runs, c, g, p_cpu
    torch.cuda.empty_cache()

    # (b) full width through launch.train: one device, then 2 x 2 ranks
    out, seq = {}, FAMILY_TRAIN_SEQ
    for arch, layers, b, one_trains in FAMILY_TRAIN:
        cfg = train.cut_depth(get_arch(arch), layers)
        n_attn = sum(k["mixer"] == "attention" for k in T.layer_kinds(cfg))
        argv = ["--arch", arch, "--layers", str(layers), "--seq-len",
                str(seq), "--global-batch", str(b), "--remat", "full",
                "--lr", str(FAMILY_TRAIN_LR), "--log-every", "1", "--seed",
                str(SEED)]
        t0 = time.perf_counter()
        if one_trains:  # the same steps through launch.train on one device
            one = train.run([*argv, "--steps", str(FAMILY_TRAIN_STEPS)])
            one_rc, one_losses = one["rc"], one["losses"]
            del one
        else:
            # step 1's loss: launch.train's parameters and first batch
            # through ``transformer.loss_fn`` (the step reports the loss
            # before its update)
            params = T.init_params(cfg, torch.Generator("cuda").manual_seed(
                SEED), device="cuda")
            data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                              global_batch=b, seed=SEED))
            with torch.no_grad():
                one_rc, one_losses = 0, [float(T.loss_fn(
                    cfg, params, make_global_batch(data, 0, "cuda"),
                    loss_chunk=min(512, seq))[0])]
            del params
        torch.cuda.empty_cache()
        mesh = _mesh_of(mesh_mod, (2, 2))
        options = ST.StepOptions(remat="full", loss_chunk=min(512, seq))
        shape = ShapeConfig("train", seq, b, "train")
        topt = AdamWConfig(lr=FAMILY_TRAIN_LR,
                           moment_dtype=cfg.opt_state_dtype)
        count = ST.step_bytes(cfg, mesh, shape, options, topt)
        torch.cuda.reset_peak_memory_stats()
        FA.launches = FA.bwd_launches = FA.copies = 0
        TR.reset_bytes()
        run = train.run([*argv, "--steps", str(FAMILY_TRAIN_STEPS),
                         "--mesh", "2x2"])
        fwd, bwd, copies = FA.launches, FA.bwd_launches, FA.copies
        moved = TR.bytes_moved() / FAMILY_TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated()
        fwd_total += fwd
        bwd_total += bwd
        losses = run["losses"]
        want = (4 * n_attn * 2 * FAMILY_TRAIN_STEPS,
                4 * n_attn * FA.BWD_KERNELS * FAMILY_TRAIN_STEPS)
        step_ms = 1e3 * statistics.median(run["step_s"][1:])
        diff = max((abs(x - y) for x, y in zip(losses, one_losses)),
                   default=math.inf)
        print(f"[27b] {arch} at full width cut to {layers} of "
              f"{get_arch(arch).n_layers} layers "
              f"({cfg.param_count() / 1e9:.3f} B parameters, bf16, AdamW "
              f"f32 moments: the full depth's "
              f"state exceeds the card) trained through launch.train "
              f"--mesh 2x2, {FAMILY_TRAIN_STEPS} steps of {b} x {seq} tokens "
              f"(remat full, lr {FAMILY_TRAIN_LR}): losses "
              + ", ".join(f"{x:.4f}" for x in losses)
              + f"; the one-device steps at this cut (the same parameters "
              f"and batches): " + ", ".join(f"{x:.4f}" for x in one_losses)
              + f", max |diff| {diff:.3e} (limit 1e-2); moe_aux "
              + ", ".join(f"{x:.4f}" for x in run["moe_aux"]) + "; "
              f"flash launches forward {fwd} backward {bwd} (want "
              f"{want[0]}, {want[1]}), TMA copies {copies}; bytes per rank "
              f"per step {moved:.0f} (step_bytes {count:.0f})", flush=True)
        print(f"[27b] on {card}: step ms median (steps 2-"
              f"{FAMILY_TRAIN_STEPS}) {step_ms:.2f}, first step "
              f"{1e3 * run['step_s'][0]:.2f} ms; {b * seq / step_ms * 1e3:.1f}"
              f" tokens/s; peak memory {peak / 2**30:.2f} GiB of 80 GiB; "
              f"the one-device run and the mesh run took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        n_one = FAMILY_TRAIN_STEPS if one_trains else 1
        if not (run["rc"] == one_rc == 0 and len(losses) == FAMILY_TRAIN_STEPS
                and all(np.isfinite(losses)) and losses[-1] < losses[0]
                and all(np.isfinite(run["moe_aux"]))
                and len(one_losses) == n_one and diff <= 1e-2):
            raise AssertionError(f"{arch} sharded training: rc {run['rc']}, "
                                 f"losses {losses}, moe_aux "
                                 f"{run['moe_aux']}, one device rc {one_rc}, "
                                 f"losses {one_losses}")
        if (fwd, bwd) != want or copies or moved != count:
            raise AssertionError(f"{arch} sharded training: flash {fwd} / "
                                 f"{bwd} (want {want}), {copies} copies, "
                                 f"bytes {moved} vs {count}")
        out[arch] = dict(step_ms=step_ms, peak=peak)
        del run
        torch.cuda.empty_cache()

    # (c) serving on 2 x 2 ranks against the one-device steps
    b, s, new = (FAMILY_SERVE_SHAPE[k] for k in ("batch", "prompt", "new"))
    depth = s + new
    shape = ShapeConfig("serve", depth, b, "prefill")
    for arch, layers in FAMILY_SERVE:
        cfg = get_arch(arch)
        if layers is not None:
            cfg = train.cut_depth(cfg, layers)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        n_attn = sum(k["mixer"] == "attention" for k in T.layer_kinds(cfg))
        mesh = _mesh_of(mesh_mod, (2, 2))
        routing = _Routing(torch, MoE, mesh, b)
        g = torch.Generator("cuda").manual_seed(SEED + 27)
        toks = torch.randint(0, cfg.vocab, (b, s), generator=g, device="cuda")
        # the one-device steps batched as the data ranks batch the rows
        # (rows are independent; a GEMM's kernel, and so its order of
        # sums, follows its row count)
        groups = routing.groups
        nxt = []

        def weights(c):
            """The seed's bf16 weights, in f32 for ``cfg32`` (exact)."""
            p = T.init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                              device="cuda")
            return _upcast_(p) if c is cfg32 else p

        def one_device(c, params, mode: str) -> tuple[list, dict]:
            """Every step's logits and the prefill's drops of the
            one-device steps at ``c``: recording the expert choices and
            greedy tokens ("record"), or on those tokens and on the
            recorded choices ("forced") or their own ("free")."""
            pre1, _ = ST.build_prefill_step(c, shape, device="cuda")
            dec1, _ = ST.build_serve_step(c, shape, device="cuda")
            caches = [T.init_cache(c, hi - lo, depth, device="cuda")
                      for lo, hi in groups]
            MoE.reset_drop_counts()
            out = []
            for i in range(new + 1):
                lg = []
                for (lo, hi), c1 in zip(groups, caches):
                    with (routing.record() if mode == "record" else
                          routing.replay_rows(i, lo, hi) if mode == "forced"
                          else contextlib.nullcontext()):
                        lg.append((pre1(params, c1, {"tokens": toks[lo:hi]})
                                   if i == 0 else dec1(params, c1,
                                                       nxt[i - 1][lo:hi],
                                                       s + i - 1))[0])
                if mode == "record":
                    routing.merge(len(groups))
                if i == 0:
                    drops = MoE.drop_counts()
                lg = torch.cat(lg)
                out.append(lg.float().cpu())
                if mode == "record" and i < new:
                    nxt.append(lg[:, -1].argmax(-1)[:, None])
            return out, drops

        with torch.no_grad():
            params = weights(cfg)
            FA.launches = 0
            want, one_drops = one_device(cfg, params, "record")
            one_launches = FA.launches
            # the one-device steps' own spread on their own expert choices:
            # the same run from weights one ulp off, on the same tokens
            _one_ulp_(torch, params, SEED + 1)
            ulp, ulp_drops = one_device(cfg, params, "free")
            spread = _agree(ulp, want)
            del params, ulp
            torch.cuda.empty_cache()
            # what bf16 itself moves them: the same weights in f32 on the
            # recorded choices and tokens
            params = weights(cfg32)
            want32, _ = one_device(cfg32, params, "forced")
            exact = _agree(want32, want)
            del params
            torch.cuda.empty_cache()
        runs = {}
        # "forced": the ranks take the one-device run's expert choices (as
        # the decode steps take its greedy tokens); "free": their own
        for c, modes in ((cfg, ("forced", "free")), (cfg32, ("forced",))):
            pre, _ = ST.build_prefill_step(c, shape, device="cuda", mesh=mesh)
            dec, _ = ST.build_serve_step(c, shape, device="cuda", mesh=mesh)
            spec = ST.abstract_state(c, mesh, None, ST.StepOptions())[2]
            sharded = _shard_in_place(mesh, SH, weights(c), spec)
            for mode in modes:
                cache = ST.init_sharded_cache(c, mesh, b, depth)
                with torch.no_grad():
                    MoE.reset_drop_counts()
                    FA.launches = FA.copies = 0
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with routing.replay(0, mode == "forced"):
                        lg, cache = pre(sharded, cache, {"tokens": toks})
                    torch.cuda.synchronize()
                    prefill_s = time.perf_counter() - t0
                    launches, copies = FA.launches, FA.copies
                    drops = MoE.drop_counts()
                    got = [_unshard_logits(torch, SH, mesh, lg, b, cfg.vocab)]
                    dec_ms = []
                    for i in range(new):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        with routing.replay(i + 1, mode == "forced"):
                            lg, cache = dec(sharded, cache, nxt[i], s + i)
                        torch.cuda.synchronize()
                        dec_ms.append(1e3 * (time.perf_counter() - t0))
                        got.append(_unshard_logits(torch, SH, mesh, lg, b,
                                                   cfg.vocab))
                worst, share = _agree(got, want32 if c is cfg32 else want)
                runs[c.dtype, mode] = dict(
                    worst=worst, share=share, launches=launches,
                    copies=copies, drops=drops, prefill_s=prefill_s,
                    dec_ms=statistics.median(dec_ms))
                fwd_total += launches
                del cache, got
            del sharded
            torch.cuda.empty_cache()
        fwd_total += one_launches
        f, r = runs["bfloat16", "forced"], runs["bfloat16", "free"]
        x = runs["float32", "forced"]
        # on the ranks' own choices: phase 26 (a)'s limits, or twice what
        # weights one ulp off move the one-device steps on their own
        # choices where that is more (a capacity dispatch is not
        # continuous: a near-tied choice flipped by a sum in another order
        # moves its row's dropped tokens)
        lim_err = max(SHARD_SERVE_TOL, 2 * spread[0])
        lim_share = min(SHARD_SERVE_GREEDY, 1 - 2 * (1 - spread[1]))
        # on the recorded choices: phase 26 (a)'s limits, or no farther
        # from the one-device steps than their f32 twin is where that is
        # farther (bf16's own rounding); in f32, the f32 tolerance
        lim_f_err = max(SHARD_SERVE_TOL, exact[0])
        lim_f_share = min(SHARD_SERVE_GREEDY, exact[1])
        print(f"[27c] {arch} at full width, {cfg.n_layers} layers (bf16, "
              f"tp) served on 2 x 2 ranks of the card, {b} prompts x {s} "
              f"tokens then {new} decode steps on the one-device run's "
              f"greedy tokens, against the one-device steps: max |logits "
              f"err| / max(1, max |logit|) {r['worst']:.3e} (limit "
              f"{lim_err:.3e}: {SHARD_SERVE_TOL} or twice the one-device "
              f"steps' from weights one ulp off, {spread[0]:.3e}), greedy "
              f"tokens equal {r['share']:.4f} (limit {lim_share:.4f}: "
              f"{SHARD_SERVE_GREEDY} or twice the one-ulp run's unequal "
              f"share, its equal share {spread[1]:.4f}), prefill dropped / "
              f"routed {r['drops']['dropped']} / {r['drops']['routed']} "
              f"(one device {one_drops['dropped']} / "
              f"{one_drops['routed']}, one ulp off "
              f"{ulp_drops['dropped']}); on the one-device run's expert "
              f"choices: {f['worst']:.3e} (limit {lim_f_err:.3e}: "
              f"{SHARD_SERVE_TOL} or the one-device steps' f32 twin's, "
              f"{exact[0]:.3e}), greedy {f['share']:.4f} (limit "
              f"{lim_f_share:.4f}: the twin's {exact[1]:.4f}), dropped "
              f"{f['drops']['dropped']}; in f32 on them, against the "
              f"one-device f32 steps: {x['worst']:.3e} (limit "
              f"{SHARD_F32_TOL}), greedy {x['share']:.4f}; flash launches "
              f"{r['launches']}, {f['launches']} and {x['launches']} (want "
              f"{4 * n_attn}: one per rank and attention layer), one device "
              f"{one_launches} (a prefill per data rank's rows), TMA copies "
              f"{f['copies'] + r['copies'] + x['copies']}", flush=True)
        print(f"[27c] on {card}: sharded prefill {r['prefill_s']:.3f} s, "
              f"decode {r['dec_ms']:.2f} ms a step (median of {new})",
              flush=True)
        if (r["worst"] > lim_err or r["share"] < lim_share
                or f["worst"] > lim_f_err or f["share"] < lim_f_share
                or x["worst"] > SHARD_F32_TOL or x["share"] < 1.0
                or f["drops"] != one_drops or x["drops"] != one_drops
                or any(v["launches"] != 4 * n_attn or v["copies"]
                       for v in runs.values())
                or one_launches != len(groups) * n_attn):
            raise AssertionError(f"{arch} sharded serving: {runs}, one "
                                 f"device launches {one_launches}, drops "
                                 f"{one_drops}, one-ulp spread {spread}, "
                                 f"f32 twin {exact}")
        del want, want32, nxt, routing
        torch.cuda.empty_cache()
    return dict(fwd_launches=fwd_total, bwd_launches=bwd_total, train=out)


# phase 28: the ssm, audio and vlm families on 2 x 2 ranks of the card.
# (a) reduced, f32, the card's ranks against a CPU mesh's
FAMILY2_CASES = ("rwkv6-7b", "whisper-large-v3", "pixtral-12b")
# (b) full width, three sharded training steps each: (arch, layers, rows,
# tokens a row).  rwkv6 at 4 of 32 layers (1.41 B parameters, ~17 GB of
# bf16 weights, bf16 gradients and f32 moments), whisper at full depth
# (32 + 32 layers, 1.55 B; 1,500 frames a row), pixtral at 4 of 40 layers
# (2.43 B, ~29 GB; 256 patches in front of 1,792 tokens)
FAMILY2_TRAIN = (("rwkv6-7b", 4, 8, 1024), ("whisper-large-v3", None, 8,
                                             448),
                 ("pixtral-12b", 4, 8, 2048))
FAMILY2_TRAIN_STEPS = 3
FAMILY2_TRAIN_LR = 3e-4
# (c) served at full width and depth: (arch, rows, prompt tokens, new
# tokens); whisper's prompt after 1,500 frames, pixtral's 1,024 tokens
# the first 256 of which are patches
FAMILY2_SERVE = (("rwkv6-7b", 8, 256, 16), ("whisper-large-v3", 8, 32, 32),
                 ("pixtral-12b", 8, 1024, 16))


def phase_families2(torch, np, T, FA, get_arch, mesh_mod, card: str) -> dict:
    """Phase 28 (see the module docstring): the ssm (rwkv6-7b), audio
    (whisper-large-v3, frames through the encoder) and vlm (pixtral-12b,
    patches in front) families on 2 x 2 ranks of the card: (a) reduced
    against a CPU mesh, (b) full-width training against the one-device
    loss, (c) full-width serving against the one-device steps.  Returns
    the flash launch counts."""
    import dataclasses

    from repro_torch.config import ShapeConfig
    from repro_torch.core import transport as TR
    from repro_torch.data import DataConfig, SyntheticLMData, make_global_batch
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as SH

    fwd_total = bwd_total = 0

    def embeds(cfg, rows, seed, dev, dtype=None):
        """The arch's stub frontend input (frames / patches) on ``dev``."""
        return {k: v.to(dev) for k, v in _stub_embeds(
            torch, np, cfg, rows, seed, dtype).items()}

    # (a) reduced, f32: the card's ranks against the CPU's
    opt = AdamWConfig(lr=3e-3)
    seq, batch = 64, 4
    shape = ShapeConfig("train", seq, batch, "train")
    serve_shape = ShapeConfig("serve", 24, batch, "prefill")
    for arch in FAMILY2_CASES:
        cfg = get_arch(arch).reduced()
        n_attn = _flash_per_prefill(T, cfg)
        options = ST.StepOptions(remat="full", loss_chunk=32)
        p_cpu = T.init_params(cfg, SEED, device="cpu")
        data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                          global_batch=batch, seed=SEED))
        toks = torch.randint(0, cfg.vocab, (batch, 16),
                             generator=torch.Generator().manual_seed(SEED))
        extra = embeds(cfg, batch, SEED, "cpu", torch.float32)
        runs = {}
        for dev in ("cpu", "cuda"):
            mesh = _mesh_of(mesh_mod, (2, 2), dev)
            step = ST.build_train_step(cfg, shape, opt=opt, options=options,
                                       device=dev, mesh=mesh)
            p, s = ST.init_sharded(cfg, mesh, _tree_to(p_cpu, dev), opt,
                                   options)
            _, _, p_spec, o_spec = ST.abstract_state(cfg, mesh, opt, options)
            ins = {k: v.to(dev) for k, v in extra.items()}
            before = (FA.launches, FA.bwd_launches)
            TR.reset_bytes()
            p, s, m = step(p, s, dict(make_global_batch(data, 0, mesh),
                                      **ins))
            moved = TR.bytes_moved()
            launches = (FA.launches - before[0], FA.bwd_launches - before[1])
            got = (SH.unshard_tree(mesh, p, p_spec),
                   {"mu": SH.unshard_tree(mesh, s["mu"], o_spec["mu"]),
                    "nu": SH.unshard_tree(mesh, s["nu"], o_spec["nu"]),
                    "step": s["step"]})
            pre, _ = ST.build_prefill_step(cfg, serve_shape, device=dev,
                                           mesh=mesh)
            dec, _ = ST.build_serve_step(cfg, serve_shape, device=dev,
                                         mesh=mesh)
            sp = SH.shard_tree(mesh, _tree_to(p_cpu, dev), ST.abstract_state(
                cfg, mesh, None, ST.StepOptions())[2])
            cache = ST.init_sharded_cache(cfg, mesh, batch, 24)
            # the CPU run's greedy tokens feed both runs' decode steps
            nxt = runs["cpu"]["tokens"] if dev == "cuda" else []
            logits = []
            serve_before = FA.launches
            with torch.no_grad():
                lg, cache = pre(sp, cache, dict(tokens=toks.to(dev), **ins))
                for i in range(5):
                    logits.append(_unshard_logits(torch, SH, mesh, lg, batch,
                                                  cfg.vocab).float().cpu())
                    if i == 4:
                        break
                    if dev == "cpu":
                        nxt.append(logits[-1][:, -1].argmax(-1)[:, None])
                    lg, cache = dec(sp, cache, nxt[i].to(dev), 16 + i)
            serve_launches = FA.launches - serve_before
            if dev == "cuda":
                fwd_total += FA.launches - before[0]
                bwd_total += FA.bwd_launches - before[1]
            runs[dev] = dict(state=got, metrics=m, moved=moved,
                             launches=launches, logits=logits, tokens=nxt,
                             serve_launches=serve_launches,
                             count=ST.step_bytes(cfg, mesh, shape, options,
                                                 opt))
            del p, s, sp, cache
        c, g = runs["cpu"], runs["cuda"]
        ok, worst = train_state_close(torch, g["state"], c["state"], opt.lr,
                                      opt.b2)
        m_err = max(abs(float(g["metrics"][n]) - float(c["metrics"][n]))
                    for n in ("loss", "ce", "grad_norm"))
        l_err = max(float((a - b).abs().max()) / max(1.0, float(
            b.abs().max())) for a, b in zip(g["logits"], c["logits"]))
        want = (4 * n_attn * 2, 4 * n_attn * FA.BWD_KERNELS)
        print(f"[28a] reduced {arch} f32 ({cfg.n_layers} layers"
              + (f", {cfg.encoder.n_layers} encoder layers, "
                 f"{cfg.encoder.n_frames} frames" if cfg.encoder else "")
              + (f", {cfg.n_patches} patches" if cfg.frontend == "vision"
                 else "") + f") on 2 x 2 ranks, card vs CPU: one training "
              f"step (remat full, {batch} x {seq} tokens): loss "
              f"{float(g['metrics']['loss']):.6f} vs "
              f"{float(c['metrics']['loss']):.6f}, max |loss, ce, "
              f"grad_norm err| {m_err:.3e}, max |err| params "
              f"{worst['params']:.3e} mu {worst['mu']:.3e} nu "
              f"{worst['nu']:.3e}; bytes per rank {g['moved']:.0f} (CPU "
              f"{c['moved']:.0f}, step_bytes {g['count']:.0f}); flash "
              f"launches forward {g['launches'][0]} backward "
              f"{g['launches'][1]} (want {want[0]}, {want[1]}); prefill of "
              f"16 tokens + 4 decode steps: max |logits err| / max(1, "
              f"max |logit|) {l_err:.3e} (tolerance {TRAIN_TOL}), flash "
              f"launches {g['serve_launches']} (want {4 * n_attn})",
              flush=True)
        if not (ok and m_err <= TRAIN_TOL and l_err <= TRAIN_TOL) or not (
                g["moved"] == c["moved"] == g["count"]) or (
                g["launches"] != want) or g["serve_launches"] != 4 * n_attn:
            raise AssertionError(f"{arch} on 2 x 2 card ranks vs CPU: "
                                 f"{worst}, {m_err}, {l_err}, bytes "
                                 f"{g['moved']} / {c['moved']} / "
                                 f"{g['count']}, launches {g['launches']}, "
                                 f"{g['serve_launches']}")
        del runs, c, g, p_cpu
    torch.cuda.empty_cache()

    # (b) full width: the one-device loss of step 1, then three sharded
    # steps on 2 x 2 ranks
    for arch, layers, rows, seq in FAMILY2_TRAIN:
        cfg = get_arch(arch)
        if layers is not None:
            cfg = train.cut_depth(cfg, layers)
        n_attn = _flash_per_prefill(T, cfg)
        shape = ShapeConfig("train", seq, rows, "train")
        topt = AdamWConfig(lr=FAMILY2_TRAIN_LR,
                           moment_dtype=cfg.opt_state_dtype)
        options = ST.StepOptions(remat="full", loss_chunk=min(512, seq))
        data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                          global_batch=rows, seed=SEED))
        batches = [dict(make_global_batch(data, i, "cuda"),
                        **embeds(cfg, rows, SEED + i, "cuda"))
                   for i in range(FAMILY2_TRAIN_STEPS)]

        def weights():
            return T.init_params(cfg, torch.Generator("cuda").manual_seed(
                SEED), device="cuda")

        t0 = time.perf_counter()
        params = weights()
        # the loss the one-device step reports at step 1 (before its
        # update): the same parameters and batch through ``loss_fn``
        with torch.no_grad():
            one_loss = float(T.loss_fn(cfg, params, batches[0],
                                       loss_chunk=options.loss_chunk)[0])
        mesh = _mesh_of(mesh_mod, (2, 2))
        step = ST.build_train_step(cfg, shape, opt=topt, options=options,
                                   device="cuda", mesh=mesh)
        p, s = ST.init_sharded(cfg, mesh, params, topt, options)
        del params
        torch.cuda.empty_cache()
        count = ST.step_bytes(cfg, mesh, shape, options, topt)
        torch.cuda.reset_peak_memory_stats()
        FA.launches = FA.bwd_launches = FA.copies = 0
        losses, step_s, moved = [], [], []
        for b in batches:
            TR.reset_bytes()
            torch.cuda.synchronize()
            ts = time.perf_counter()
            p, s, m = step(p, s, b)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - ts)
            moved.append(TR.bytes_moved())
        fwd, bwd, copies = FA.launches, FA.bwd_launches, FA.copies
        peak = torch.cuda.max_memory_allocated()
        fwd_total += fwd
        bwd_total += bwd
        want = (4 * n_attn * 2 * FAMILY2_TRAIN_STEPS,
                4 * n_attn * FA.BWD_KERNELS * FAMILY2_TRAIN_STEPS)
        step_ms = 1e3 * statistics.median(step_s[1:])
        tokens = rows * seq
        diff = abs(losses[0] - one_loss)
        print(f"[28b] {arch} at full width"
              + (f", {cfg.n_layers} of {get_arch(arch).n_layers} layers"
                 if layers else f", {cfg.n_layers} layers")
              + f" ({cfg.param_count() / 1e9:.3f} B parameters, bf16, AdamW"
              f" f32 moments), {FAMILY2_TRAIN_STEPS} sharded steps on 2 x 2"
              f" ranks of {rows} x {seq} tokens"
              + (f" after {cfg.encoder.n_frames} frames" if cfg.encoder
                 else "")
              + (f" ({cfg.n_patches} of them patches)"
                 if cfg.frontend == "vision" else "")
              + f" (remat full, lr {FAMILY2_TRAIN_LR}): losses "
              + ", ".join(f"{x:.4f}" for x in losses)
              + f"; the one-device loss at step 1 {one_loss:.4f}, |diff| "
              f"{diff:.3e} (limit 1e-2); flash launches forward {fwd} "
              f"backward {bwd} (want {want[0]}, {want[1]}), TMA copies "
              f"{copies}; bytes per rank per step "
              + ", ".join(f"{x:.0f}" for x in moved)
              + f" (step_bytes {count:.0f})", flush=True)
        print(f"[28b] on {card}: step ms median (steps 2-"
              f"{FAMILY2_TRAIN_STEPS}) {step_ms:.2f}, first step "
              f"{1e3 * step_s[0]:.2f} ms; {tokens / step_ms * 1e3:.1f} "
              f"tokens/s; peak memory {peak / 2**30:.2f} GiB of 80 GiB; "
              f"{time.perf_counter() - t0:.1f} s in all", flush=True)
        if not (all(np.isfinite(losses)) and diff <= 1e-2):
            raise AssertionError(f"{arch} sharded training: losses "
                                 f"{losses}, one device {one_loss}")
        if (fwd, bwd) != want or copies or any(x != count for x in moved):
            raise AssertionError(f"{arch} sharded training: flash {fwd} / "
                                 f"{bwd} (want {want}), {copies} copies, "
                                 f"bytes {moved} vs {count}")
        del p, s, step, batches
        torch.cuda.empty_cache()

    # (c) serving at full width and depth against the one-device steps:
    # bf16 (the ranks' partial sums in f32), and the same weights in f32
    for arch, rows, s_len, new in FAMILY2_SERVE:
        cfg = get_arch(arch)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        depth = s_len + new
        shape = ShapeConfig("serve", depth, rows, "prefill")
        n_attn = _flash_per_prefill(T, cfg)
        g = torch.Generator("cuda").manual_seed(SEED + 28)
        toks = torch.randint(0, cfg.vocab, (rows, s_len), generator=g,
                             device="cuda")
        ins = dict(tokens=toks, **embeds(cfg, rows, SEED + 28, "cuda"))
        nxt = []  # the one-device bf16 run's greedy tokens feed every run

        def weights(c):
            """The seed's bf16 weights, in f32 for ``cfg32`` (exact)."""
            p = T.init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                              device="cuda")
            return _upcast_(p) if c is cfg32 else p

        def inputs(c):
            return ins if c is cfg else {k: v.float() if v.is_floating_point()
                                         else v for k, v in ins.items()}

        def one_device(c, params) -> list:
            pre1, _ = ST.build_prefill_step(c, shape, device="cuda")
            dec1, _ = ST.build_serve_step(c, shape, device="cuda")
            cache = T.init_cache(c, rows, depth, device="cuda")
            lg, cache = pre1(params, cache, inputs(c))
            out = []
            for i in range(new + 1):
                out.append(lg.float().cpu())
                if i == new:
                    break
                if len(nxt) == i:
                    nxt.append(lg[:, -1].argmax(-1)[:, None])
                lg, cache = dec1(params, cache, nxt[i], s_len + i)
            return out

        def ranks(c, params) -> tuple[list, dict]:
            """Every step's logits on 2 x 2 ranks (the weights sharded in
            place), the prefill s, decode ms, flash launches, copies."""
            mesh = _mesh_of(mesh_mod, (2, 2))
            pre, _ = ST.build_prefill_step(c, shape, device="cuda",
                                           mesh=mesh)
            dec, _ = ST.build_serve_step(c, shape, device="cuda", mesh=mesh)
            spec = ST.abstract_state(c, mesh, None, ST.StepOptions())[2]
            sharded = _shard_in_place(mesh, SH, params, spec)
            torch.cuda.empty_cache()
            cache = ST.init_sharded_cache(c, mesh, rows, depth)
            FA.launches = FA.copies = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = pre(sharded, cache, inputs(c))
            torch.cuda.synchronize()
            run = dict(prefill_s=time.perf_counter() - t0,
                       launches=FA.launches, copies=FA.copies)
            got = [_unshard_logits(torch, SH, mesh, lg, rows, cfg.vocab)]
            dec_ms = []
            for i in range(new):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, cache = dec(sharded, cache, nxt[i], s_len + i)
                torch.cuda.synchronize()
                dec_ms.append(1e3 * (time.perf_counter() - t0))
                got.append(_unshard_logits(torch, SH, mesh, lg, rows,
                                           cfg.vocab))
            run["decode_ms"] = statistics.median(dec_ms)
            return got, run

        with torch.no_grad():
            FA.launches = 0
            want = one_device(cfg, weights(cfg))
            one_launches = FA.launches
            torch.cuda.empty_cache()
            got, run = ranks(cfg, weights(cfg))
            torch.cuda.empty_cache()
        fwd_total += one_launches + run["launches"]
        worst, share = _agree(got, want)
        ok = worst <= SHARD_SERVE_TOL and share >= SHARD_SERVE_GREEDY
        print(f"[28c] {arch} at full width and depth (bf16, f32 partial "
              f"sums) served on 2 x 2 ranks of the card, {rows} prompts x "
              f"{s_len} tokens"
              + (f" after {cfg.encoder.n_frames} frames" if cfg.encoder
                 else "")
              + (f" ({cfg.n_patches} of them patches)"
                 if cfg.frontend == "vision" else "")
              + f" then {new} decode steps on the one-device run's greedy "
              f"tokens, against the one-device steps: max |logits err| / "
              f"max(1, max |logit|) {worst:.3e} (limit {SHARD_SERVE_TOL}), "
              f"greedy tokens equal {share:.4f} (limit "
              f"{SHARD_SERVE_GREEDY}); flash launches {run['launches']} "
              f"(want {4 * n_attn}: one per rank and attention call), one "
              f"device {one_launches} (want {n_attn}), TMA copies "
              f"{run['copies']}", flush=True)
        print(f"[28c] on {card}: sharded prefill {run['prefill_s']:.3f} s, "
              f"decode {run['decode_ms']:.2f} ms a step (median of {new})",
              flush=True)
        if (run["launches"] != 4 * n_attn or one_launches != n_attn
                or run["copies"]):
            raise AssertionError(f"{arch} sharded serving: {run}, one "
                                 f"device launches {one_launches}")
        if not ok:
            # what bf16 itself moves the one-device steps: the same
            # weights in f32 (the twin); and the ranks in f32 against the
            # twin, beside what weights one ulp off move the twin
            with torch.no_grad():
                params = weights(cfg32)
                want32 = one_device(cfg32, params)
                got32, run32 = ranks(cfg32, params)
                del params
                params = weights(cfg32)
                _one_ulp_(torch, params, SEED + 1)
                ulp32 = one_device(cfg32, params)
                del params
                torch.cuda.empty_cache()
            fwd_total += run32["launches"] + 2 * n_attn
            # bf16's error of each path: its distance from the twin
            exact, mine = _agree(want, want32), _agree(got, want32)
            x32, spread = _agree(got32, want32), _agree(ulp32, want32)
            lim_err = max(SHARD_SERVE_TOL, 2 * exact[0])
            lim_share = min(SHARD_SERVE_GREEDY, 1 - 2 * (1 - exact[1]))
            lim32 = max(SHARD_F32_TOL, 2 * spread[0])
            lim32_share = min(1.0, 1 - 2 * (1 - spread[1]))
            print(f"[28c] {arch}: over {SHARD_SERVE_TOL} / "
                  f"{SHARD_SERVE_GREEDY}, so each bf16 path is held to the "
                  f"one-device steps' f32 twin (the same weights in f32): "
                  f"the ranks {mine[0]:.3e} / greedy {mine[1]:.4f} from it "
                  f"(limit {lim_err:.3e} / {lim_share:.4f}: "
                  f"{SHARD_SERVE_TOL} / {SHARD_SERVE_GREEDY} or twice the "
                  f"one-device steps' own bf16 error, {exact[0]:.3e} / "
                  f"greedy {exact[1]:.4f}); the ranks in f32 against the "
                  f"twin {x32[0]:.3e} / greedy {x32[1]:.4f} (limit "
                  f"{lim32:.3e} / {lim32_share:.4f}: {SHARD_F32_TOL} or "
                  f"twice what weights one ulp off move the twin, "
                  f"{spread[0]:.3e} / {spread[1]:.4f}); in f32 on {card}: "
                  f"prefill {run32['prefill_s']:.3f} s, decode "
                  f"{run32['decode_ms']:.2f} ms, flash launches "
                  f"{run32['launches']}", flush=True)
            if not (mine[0] <= lim_err and mine[1] >= lim_share
                    and x32[0] <= lim32 and x32[1] >= lim32_share
                    and run32["launches"] == 4 * n_attn
                    and not run32["copies"]):
                raise AssertionError(f"{arch} sharded serving: {mine} "
                                     f"(one device {exact}), f32 {x32} "
                                     f"(one ulp {spread}), {run32}")
            del want32, got32, ulp32
        del want, got, nxt
        torch.cuda.empty_cache()
    return dict(fwd_launches=fwd_total, bwd_launches=bwd_total)


# phase 29's train_lm steps: the fewest at which the example's learning
# check passes on the H100 (losses 10.5672, 9.8002, 8.9875 against the
# check's 9.5672; ``scripts/train_lm_steps.py``).  Its default of 200
# steps adds about 70 s of host-bound steps, which a slower host does not
# leave room for in this run's time budget.
TRAIN_LM_STEPS = 3


def phase_examples(torch, K, FA, plan) -> dict:
    """Phase 29 (see the module docstring): each example twin's ``main``
    at its defaults (``train_lm`` at ``TRAIN_LM_STEPS`` steps), both
    kernels' counts set to 0 just before each call and read just after;
    returns the launches of all the calls and each call's seconds."""
    import tempfile

    from repro_torch.examples import (
        linear_scaling_dft,
        quickstart,
        serve_batch,
        tensor_contraction,
        train_lm,
    )

    out = dict(spgemm_launches=0, fwd_launches=0, bwd_launches=0, s={})

    def call(label, mod, argv=()):
        K.launches = FA.launches = FA.bwd_launches = FA.copies = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = mod.main(list(argv))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n = dict(spgemm=K.launches, fwd=FA.launches, bwd=FA.bwd_launches,
                 copies=FA.copies)
        print(f"[29] {label}: {sec:.2f} s, block_spgemm launches "
              f"{n['spgemm']}, flash forward {n['fwd']}, backward "
              f"{n['bwd']}, flash input copies {n['copies']}", flush=True)
        if rc != 0 or n["copies"]:
            raise AssertionError(f"{label}: exit {rc}, {n['copies']} copies")
        out["s"][label] = sec
        out["spgemm_launches"] += n["spgemm"]
        out["fwd_launches"] += n["fwd"]
        out["bwd_launches"] += n["bwd"]
        return n

    with tempfile.TemporaryDirectory() as tmp:
        # the checkpoints train_lm writes into a fresh temporary directory
        # go with this one
        saved, tempfile.tempdir = tempfile.tempdir, tmp
        try:
            call("linear_scaling_dft", linear_scaling_dft)
            db = os.path.join(tmp, "tuning_db.json")
            trials = []
            for when in ("cold", "warm"):
                call(f"linear_scaling_dft --tuning-db ({when})",
                     linear_scaling_dft, ["--tuning-db", db])
                trials.append(plan.cache_stats()["tuner_trials"])
            print(f"[29] linear_scaling_dft --tuning-db: trials cold "
                  f"{trials[0]}, warm {trials[1]}", flush=True)
            if not (trials[0] > 0 and trials[1] == 0):
                raise AssertionError(f"tuner trials cold / warm {trials}")
            call("quickstart", quickstart)
            call("tensor_contraction", tensor_contraction)
            cfg = serve_batch.config()
            n = call("serve_batch", serve_batch)
            # one prefill round, and the teacher-forced forward: each runs
            # the kernel once per layer (decode attends without it)
            if (n["fwd"], n["bwd"]) != (2 * cfg.n_layers, 0):
                raise AssertionError(f"serve_batch flash {n} (want "
                                     f"{2 * cfg.n_layers} forward)")
            cfg = train_lm.config()
            n = call("train_lm", train_lm, ["--steps", str(TRAIN_LM_STEPS)])
            # 4 ranks x layers x steps x (2 forward: remat recomputes it,
            # 3 backward), as phase 25 counts them
            want = (4 * cfg.n_layers * TRAIN_LM_STEPS * 2,
                    4 * cfg.n_layers * TRAIN_LM_STEPS * FA.BWD_KERNELS)
            if (n["fwd"], n["bwd"]) != want:
                raise AssertionError(f"train_lm flash {n} (want {want})")
        finally:
            tempfile.tempdir = saved
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch import tuner
    from repro_torch.configs import get_arch
    from repro_torch.core import bsm as B
    from repro_torch.core import commvolume as CV
    from repro_torch.core import envelope
    from repro_torch.core import distribute as D
    from repro_torch.core import engine as E
    from repro_torch.core import local_mm as lm
    from repro_torch.core import plan
    from repro_torch.core import signiter as SI
    from repro_torch.core import tensor as TN
    from repro_torch.core import transport as TR
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import block_spgemm as K
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import stacks as S
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import purify, serve
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer as T

    # full f32 in every matmul the checks compare against
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device {name} | {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    build_s = _build.build()
    for src in _build.SOURCES:
        for line in _build.ptxas_log.get(src, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1]   {src}: {line.strip()}")
    print(f"[1] kernel build {build_s:.2f} s into "
          f"{_build.BUILD_DIR.relative_to(ROOT)}", flush=True)

    phase_kernel_vs_plain(torch, np, K, S, ref, lm, B)
    m = _timed(3, phase_full_width_multiply, torch, K, S, B, E, plan)
    launches, single = _timed(4, phase_purify, torch, K, purify)
    print(f"[4] phases 1-4 in {time.perf_counter() - t0:.1f} s", flush=True)
    phase_flash_vs_plain(torch, np, FA, ref)
    phase_model_cuda_vs_cpu(torch, np, T, FA, get_arch)
    served, engine, toks = _timed(7, phase_serve, torch, np, T, K, FA,
                                  serve)
    _timed(8, phase_breakdown, torch, T, engine, toks)
    del engine, toks
    torch.cuda.empty_cache()
    f = _timed(9, phase_flash_serving_shape, torch, np, FA)
    _timed(10, phase_engines, torch, B, E, CV, TR, lm, K, plan, mesh_mod)
    sharded_launches, sharded = _timed(
        11, phase_sharded_purify, torch, K, CV, plan, mesh_mod, purify,
        single)
    _timed(12, phase_purify_breakdown, torch, B, SI, mesh_mod)
    dbcsr_launches = _timed(13, phase_dbcsr, torch, B, E, CV, SI, TR, K,
                            plan, mesh_mod, D, purify, single, sharded)
    del sharded
    tuner_launches = _timed(14, phase_tuner, torch, B, E, TR, K, S, plan,
                            mesh_mod, tuner, purify, single)
    del single
    tensor = _timed(15, phase_tensor, torch, K, S, plan, TN)
    moe_launches = _timed(16, phase_moe_layer, torch, K, S, MoE, get_arch,
                          envelope)
    cells = start_dryrun_cells()  # phase 26 (c), beside phases 17 and 18
    atexit.register(cells.kill)  # a phase that fails leaves it no orphan
    serve_launches, serve_flash = _timed(17, phase_moe_serve, torch, K, FA,
                                         T, MoE, serve)
    jamba_launches, jamba_flash, jamba_kernel = _timed(
        18, phase_jamba, torch, np, K, S, FA, T, MoE, serve, get_arch)
    _timed(19, phase_rwkv, torch, np, K, FA, T, serve)
    whisper_flash, whisper_kernel = _timed(20, phase_whisper, torch, np, FA,
                                           T, get_arch)
    pixtral_flash, pixtral_kernel = _timed(21, phase_pixtral, torch, np, K,
                                           FA, T, serve)
    fb = _timed(22, phase_flash_backward, torch, np, FA,
                _build.ptxas_log.get("flash_attention_bwd", ""))
    _timed(23, phase_train_cuda_vs_cpu, torch, np, T, FA, get_arch)
    trained = _timed(24, phase_train, torch, np, T, FA, get_arch, smi)
    sharded_train = _timed(25, phase_sharded_train, torch, np, T, FA,
                           get_arch, mesh_mod, smi, trained["losses"][0])
    served_2x2 = _timed(26, phase_dryrun, torch, np, T, FA, get_arch,
                        mesh_mod, smi, trained, sharded_train, cells)
    families = _timed(27, phase_families, torch, np, T, FA, get_arch,
                      mesh_mod, smi)
    families2 = _timed(28, phase_families2, torch, np, T, FA, get_arch,
                       mesh_mod, smi)
    examples = _timed(29, phase_examples, torch, K, FA, plan)

    kernels = [dict(
        name="block_spgemm", route="cuda",
        source="src/repro_torch/kernels/csrc/block_spgemm.cu",
        replaces="src/repro/kernels/block_spgemm.py:217",
        launches=(launches + sharded_launches + dbcsr_launches
                  + tuner_launches + tensor["launches"] + moe_launches
                  + serve_launches + jamba_launches
                  + examples["spgemm_launches"]),
        max_abs_err=m["max_abs_err"],
        ms=m["ms"],
        plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
        bound_by=m["bound_by"], library_ms=m["library_ms"],
    ), dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:25",
        launches=(served["flash_launches"] + serve_flash + jamba_flash
                  + whisper_flash + pixtral_flash + trained["fwd_launches"]
                  + sharded_train["fwd_launches"]
                  + served_2x2["fwd_launches"] + families["fwd_launches"]
                  + families2["fwd_launches"] + examples["fwd_launches"]),
        max_abs_err=f["max_abs_err"],
        ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
        bound_by=f["bound_by"], library_ms=f["library_ms"],
        bwd_launches=trained["bwd_launches"]
        + sharded_train["bwd_launches"] + families["bwd_launches"]
        + families2["bwd_launches"] + examples["bwd_launches"],
        bwd_ms=fb["bwd_ms"],
        bwd_plain_ms=fb["bwd_plain_ms"], bwd_bound_ms=fb["bwd_bound_ms"],
        bwd_library_ms=fb["bwd_library_ms"],
        bwd_max_abs_err=fb["bwd_max_abs_err"], bwd_dkdv_ms=fb["bwd_dkdv_ms"],
        bwd_dq_ms=fb["bwd_dq_ms"],
    )]
    print(f"[30] all phases passed in {time.perf_counter() - t0:.1f} s; "
          f"block_spgemm launches {launches} (single-device purification) "
          f"+ {sharded_launches} (sharded) + {dbcsr_launches} (phase 13's "
          f"four chains) + {tuner_launches} (phase 14's two tuned chains) "
          f"+ {tensor['launches']} (phase 15's contraction) + "
          f"{moe_launches} (phase 16's MoE layer) + {serve_launches} "
          f"(phase 17's spgemm serving) + {jamba_launches} (phase 18's "
          f"jamba spgemm serving) + {examples['spgemm_launches']} (phase "
          f"29's examples); flash launches "
          f"{served['flash_launches']} (phase 7) + {serve_flash} (phase "
          f"17's two serving runs) + {jamba_flash} (phase 18's two jamba "
          f"serving runs) + {whisper_flash} (phase 20's whisper prefill) + "
          f"{pixtral_flash} (phase 21's pixtral serving and fusion) + "
          f"{trained['fwd_launches']} (phase 24's olmo-1b training, whose "
          f"backward launched the backward kernels "
          f"{trained['bwd_launches']} times: {trained['step_ms']:.2f} ms a "
          f"step, {trained['tokens_s']:.1f} tokens/s, model-FLOP share "
          f"{trained['mfu']:.4f}) + {sharded_train['fwd_launches']} "
          f"(phase 25's olmo-1b on 2 x 2 ranks, backward "
          f"{sharded_train['bwd_launches']}: {sharded_train['step_ms']:.2f}"
          f" ms a step, {sharded_train['tokens_s']:.1f} tokens/s) + "
          f"{served_2x2['sharded_launches']} + {served_2x2['one_launches']} "
          f"(phase 26's olmo-1b prefill on 2 x 2 ranks and on one device: "
          f"{served_2x2['prefill_s']:.3f} s, decode "
          f"{served_2x2['decode_ms']:.2f} ms a step) + "
          f"{families['fwd_launches']} (phase 27's MoE and hybrid families "
          f"on 2 x 2 ranks, backward {families['bwd_launches']}) + "
          f"{families2['fwd_launches']} (phase 28's ssm, audio and vlm "
          f"families on 2 x 2 ranks and the one-device serving steps, "
          f"backward {families2['bwd_launches']}) + "
          f"{examples['fwd_launches']} (phase 29's examples, backward "
          f"{examples['bwd_launches']}: " + ", ".join(
              f"{k} {v:.2f} s" for k, v in examples["s"].items())
          + "); phase "
          f"19's rwkv6 serving launches neither; jamba's MoE shape: kernel "
          f"{jamba_kernel['ms']:.4f} ms, bound "
          f"{jamba_kernel['bound_ms']:.4f} ms, grouped bmm "
          f"{jamba_kernel['library_ms']:.4f} ms; flash (ms: kernel, bound,"
          f" sdpa) " + "; ".join(
              f"{model} {name} {r['ms']:.4f}, {r['bound_ms']:.4f}, "
              f"{r['library_ms']:.4f}"
              for model, rows in (("whisper", whisper_kernel),
                                  ("pixtral", pixtral_kernel))
              for name, r in rows.items()), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
