"""The port's training step and driver (``launch.steps.build_train_step``,
``launch.train``) against the reference's.

The reference's step runs on a 1 x 1 ``jax.sharding.Mesh`` of Auto axes
(its ``launch.mesh.make_mesh`` gives Explicit axes, which jax 0.9.0's
``with_sharding_constraint`` rejects inside the step — the red set's
``train_steps`` entries).  Both packages start from the reference's
parameters and zero optimizer state and take three steps on the
reference's data stream (``repro.data``), which the port's own copy must
reproduce.  Tolerances: metrics within 1e-5 relative, and every leaf of
mu and nu within 1e-4 of its largest magnitude (f32, the same arithmetic
in other orders).  Parameters too, except where AdamW normalises rounding
noise: an entry whose gradient root-mean-square sqrt(nu_hat) fell below
NOISE (1e-6, a hundred times eps) at some step moves by lr * m_hat /
(sqrt(nu_hat) + eps), a ratio of two numbers at f32 noise level (a wv
gradient of 2.3e-9 against eps 1e-8 moved one entry 1.3e-4 apart).  Those
entries are held to 2 lr per step, the most two updates can differ.

``launch.train`` is held to itself: a run checkpointed and resumed gives
an uninterrupted run's losses; on a 2 x 2 mesh of ranks (the sharded step)
its losses are the 1 x 1 run's within 1e-4, a resumed 2 x 2 run equals an
uninterrupted one, and a family the sharded step does not run raises.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.config import ShapeConfig as JShapeConfig
from repro.configs import get_arch as jget_arch
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMData as JData
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamW
from repro_torch import interop
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticLMData, make_global_batch
from repro_torch.launch import steps as S
from repro_torch.launch import train
from repro_torch.optim import AdamWConfig
from repro_torch.optim.tree import leaves

SEQ, BATCH, N_STEPS = 16, 4, 3
METRIC_TOL, LEAF_TOL = 1e-5, 1e-4
NOISE, LR = 1e-6, 3e-3
REDUCED = ["--device", "cpu", "--reduced", "--seq-len", "16",
           "--global-batch", "2", "--log-every", "1"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=atol)


@pytest.mark.parametrize("options", [
    dict(remat="dots"),
    dict(remat="full", microbatch=2),
    dict(remat="none", compress_grads=True),
], ids=["plain", "microbatch2", "compress"])
def test_train_step_matches_reference(options):
    jcfg, cfg = jget_arch("olmo-1b").reduced(), get_arch("olmo-1b").reduced()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jopt = JAdamW(lr=LR)
    jstep, (_, o_sds, _) = JS.build_train_step(
        jcfg, mesh, JShapeConfig("train", SEQ, BATCH, "train"), opt=jopt,
        options=JS.StepOptions(loss_chunk=8, **options))
    jp = JT.init_params(jcfg, jax.random.key(0))
    jo = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), o_sds)
    params = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    opt_state = interop.opt_state_from_jax(cfg, jax.tree.map(np.asarray, jo),
                                           device="cpu")
    step = S.build_train_step(
        cfg, ShapeConfig("train", SEQ, BATCH, "train"),
        opt=AdamWConfig(lr=LR), options=S.StepOptions(loss_chunk=8,
                                                        **options),
        device="cpu")
    jdata = JData(JDataConfig(vocab=cfg.vocab, seq_len=SEQ,
                              global_batch=BATCH, seed=0))
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                      global_batch=BATCH, seed=0))
    noisy = None  # entries whose gradient was at noise level at some step
    for i in range(N_STEPS):
        jb = {k: jnp.asarray(v) for k, v in jdata.batch_numpy(i).items()}
        jp, jo, jm = jstep(jp, jo, jb)
        b2c = 1.0 - jopt.b2 ** (i + 1)
        now = [np.sqrt(np.asarray(x) / b2c) < NOISE
               for x in jax.tree.leaves(jo["nu"])]
        noisy = now if noisy is None else [a | b for a, b in zip(noisy, now)]
        params, opt_state, m = step(params, opt_state,
                                    make_global_batch(data, i, "cpu"))
        assert sorted(m) == sorted(jm) == ["ce", "grad_norm", "loss",
                                           "moe_aux"]
        for name in m:
            assert abs(float(m[name]) - float(jm[name])) <= METRIC_TOL * max(
                1.0, abs(float(jm[name]))), (i, name)
    jo_np = jax.tree.map(np.asarray, jo)
    assert int(opt_state["step"]) == int(jo_np["step"]) == N_STEPS
    want_state = interop.opt_state_from_jax(cfg, jo_np, device="cpu")
    assert ("efb" in opt_state) == bool(options.get("compress_grads"))
    want_p = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    noisy = interop.params_from_jax(
        cfg, jax.tree.unflatten(jax.tree.structure(jo["nu"]), noisy),
        device="cpu")
    n_noisy = sum(int(m.sum()) for m in leaves(noisy))
    # few entries (0.27 % here): the exemption is not the whole test
    assert n_noisy <= 1e-2 * sum(m.numel() for m in leaves(noisy))
    for g, w, m in zip(leaves(params), leaves(want_p), leaves(noisy)):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(torch.where(m, w, g), w.numpy(), LEAF_TOL)
        assert float((g - w).abs().max()) <= 2 * LR * N_STEPS
    for got, want in ((opt_state["mu"], want_state["mu"]),
                      (opt_state["nu"], want_state["nu"])):
        for g, w in zip(leaves(got), leaves(want)):
            assert g.dtype == w.dtype and g.shape == w.shape
            _close(g, w.numpy(), LEAF_TOL)
    if "efb" in opt_state:
        # the residual g + r - bf16(g + r): where the two packages' g + r
        # straddle a bf16 rounding boundary it moves by one bf16 spacing of
        # g + r.  nu holds the last clipped payload times (1 - b2), so
        # |g + r| <= sqrt(nu / (1 - b2)) / clip scale
        unclip = max(1.0, float(jm["grad_norm"]) / jopt.clip_norm)
        for g, w, nu in zip(leaves(opt_state["efb"]),
                            leaves(want_state["efb"]),
                            leaves(want_state["nu"])):
            spacing = 2.0**-7 * (torch.sqrt(nu / (1 - jopt.b2)) * unclip
                                 + w.abs())
            limit = LEAF_TOL * max(1.0, float(w.abs().max())) + spacing
            assert bool(((g - w).abs() <= limit).all())


def test_train_step_rejects_a_batch_of_another_shape():
    cfg = get_arch("olmo-1b").reduced()
    step = S.build_train_step(cfg, ShapeConfig("train", SEQ, BATCH, "train"),
                              device="cpu")
    with pytest.raises(ValueError, match="microbatch"):
        S.build_train_step(cfg, ShapeConfig("train", SEQ, 3, "train"),
                           options=S.StepOptions(microbatch=2),
                           device="cpu")
    bad = {"tokens": torch.zeros((BATCH, SEQ + 1), dtype=torch.long),
           "targets": torch.zeros((BATCH, SEQ + 1), dtype=torch.long)}
    with pytest.raises(ValueError, match="tokens"):
        step({}, {}, bad)


def test_train_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """4 steps with a checkpoint every 2, then a second launch to 8 that
    resumes from step 4: the losses of steps 4-7 equal those of one 8-step
    run (the data stream is addressed by step).  The checkpoint holds the
    port's per-layer leaves and the 1 x 1 mesh."""
    ckpt = str(tmp_path / "ckpt")
    whole = train.run([*REDUCED, "--steps", "8"])
    first = train.run([*REDUCED, "--steps", "4", "--ckpt-dir", ckpt,
                       "--ckpt-every", "2"])
    second = train.run([*REDUCED, "--steps", "8", "--ckpt-dir", ckpt])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out
    assert first["rc"] == second["rc"] == whole["rc"] == 0
    assert second["start_step"] == 4 and len(second["losses"]) == 4
    np.testing.assert_allclose(first["losses"] + second["losses"],
                               whole["losses"], rtol=0, atol=1e-6)
    assert whole["losses"][-1] < whole["losses"][0]
    with open(tmp_path / "ckpt" / "step_000000008" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["complete"] and manifest["step"] == 8
    assert manifest["mesh"] == {"shape": [1, 1], "axes": ["data", "model"]}
    assert "params__blocks__1__attn__wq" in manifest["leaves"]
    assert "opt__step" in manifest["leaves"]


def test_train_main_learns_and_logs(capsys):
    """The CPU rehearsal of the entry point: exit 0, a loss that falls,
    the reference's log lines."""
    assert train.main([*REDUCED, "--steps", "6", "--compress-grads",
                       "--remat", "dots"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[train] step")]
    assert len(lines) == 6
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in lines]
    assert losses[-1] < losses[0]
    assert "[train] done: 6 steps" in out


@pytest.mark.parametrize("mesh", ["2x2", "1x2", "2x1x1"])
def test_train_mesh_larger_than_one_device_raises(mesh):
    """A mesh larger than one device runs the sharded step, which takes
    every family: rwkv6 (the ssm family) trains a step on it as on
    ``1x1``, its loss within 1e-4."""
    args = [*REDUCED, "--arch", "rwkv6-7b", "--steps", "1"]
    one = train.run(args)
    got = train.run([*args, "--mesh", mesh])
    assert one["rc"] == got["rc"] == 0
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=0,
                               atol=1e-4)


def test_train_on_a_2x2_mesh_matches_1x1(capsys):
    """The CPU rehearsal of sharded training: ``--mesh 2x2`` exits 0 with
    a falling loss, and its losses are the 1 x 1 run's within 1e-4 (the
    same parameters, drawn once and sharded)."""
    args = [*REDUCED, "--global-batch", "4", "--steps", "6"]
    one = train.run(args)
    two = train.run([*args, "--mesh", "2x2"])
    assert one["rc"] == two["rc"] == 0
    assert two["losses"][-1] < two["losses"][0]
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=0,
                               atol=1e-4)
    assert train.main([*args, "--mesh", "2x1x2", "--head-2p5d",
                       "--seq-parallel", "--zero1", "--microbatch", "2",
                       "--bf16-reduce", "--fsdp-axis", "pod,data",
                       "--steps", "2"]) == 0


def test_train_resume_on_a_2x2_mesh_equals_an_uninterrupted_run(tmp_path):
    """Sharded checkpoints hold the gathered leaves and the 2 x 2 mesh; a
    resumed 2 x 2 run's losses are an uninterrupted one's within 1e-6."""
    ckpt = str(tmp_path / "ckpt")
    args = [*REDUCED, "--global-batch", "4", "--mesh", "2x2"]
    whole = train.run([*args, "--steps", "6"])
    first = train.run([*args, "--steps", "3", "--ckpt-dir", ckpt,
                       "--ckpt-every", "3"])
    second = train.run([*args, "--steps", "6", "--ckpt-dir", ckpt])
    assert second["start_step"] == 3
    np.testing.assert_allclose(first["losses"] + second["losses"],
                               whole["losses"], rtol=0, atol=1e-6)
    with open(tmp_path / "ckpt" / "step_000000006" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["mesh"] == {"shape": [2, 2], "axes": ["data", "model"]}
    leaf = manifest["leaves"]["params__blocks__1__attn__wq"]
    cfg = get_arch("olmo-1b").reduced()
    assert leaf["shape"] == [cfg.d_model, cfg.n_heads * cfg.hd]


def test_train_resume_with_compressed_grads_on_a_2x2_mesh(tmp_path):
    """Under ``--compress-grads`` each data rank keeps its own residual
    of every gradient the data axis replicates (ZeRO-1's: the parameters
    drop FSDP): the checkpoint holds those leaves rank by rank, and a resumed 2 x 2
    run's losses are an uninterrupted one's within 1e-6.  Restoring them
    onto another mesh raises (no re-sharding of per-rank state is
    exact)."""
    ckpt = str(tmp_path / "ckpt")
    args = [*REDUCED, "--global-batch", "4", "--mesh", "2x2",
            "--compress-grads", "--zero1"]
    whole = train.run([*args, "--steps", "6"])
    first = train.run([*args, "--steps", "3", "--ckpt-dir", ckpt,
                       "--ckpt-every", "3"])
    second = train.run([*args, "--steps", "6", "--ckpt-dir", ckpt])
    assert second["start_step"] == 3
    np.testing.assert_allclose(first["losses"] + second["losses"],
                               whole["losses"], rtol=0, atol=1e-6)
    with open(tmp_path / "ckpt" / "step_000000006" / "manifest.json") as f:
        manifest = json.load(f)
    per_rank = [n for n, e in manifest["leaves"].items()
                if e.get("per_rank")]
    assert per_rank and all(n.startswith("opt__efb__") for n in per_rank)
    assert len(manifest["leaves"][per_rank[0]]["files"]) == 4
    with pytest.raises(ValueError, match="per-rank state"):
        train.run([*REDUCED, "--global-batch", "4", "--mesh", "4x1",
                   "--compress-grads", "--zero1", "--steps", "7",
                   "--ckpt-dir", ckpt])


def test_train_needs_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1"])


def test_watchdog_flags_a_slow_step():
    w = train.StragglerWatchdog(factor=3.0, warmup=2)
    for i in range(5):
        assert not w.observe(i, 1.0)
    assert w.observe(5, 10.0)
    # a slow step enters the EMA capped at factor x EMA
    assert w.events == [(5, 10.0)] and w.ema == pytest.approx(1.2)
