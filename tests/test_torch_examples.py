"""The port's example drivers (``repro_torch.examples``) against the JAX
package's single-device oracles, on the same inputs.

The reference's own drivers (``examples/*.py``) are not imported: they set
``XLA_FLAGS`` and ``sys.path`` at import, and their sharded paths are red
under the installed jax (its red set).  Each check they make is rebuilt
here from reference functions that run on one device: ``density_matrix``
on the unsharded H, ``multiply_reference``, ``contract_reference``, the
reference's ``ServingEngine`` and its one-device ``build_train_step``.
Inputs are drawn once by the reference's generators and carried across
(``interop``, bit for bit).  Tolerances: f32 results within 1e-5
(purification, products, contractions; relative to the largest value for
contractions), masks and greedy tokens exactly, training metrics within
1e-4.  ``main`` of each driver runs at its defaults on the CPU and ends
with ``"<name> OK"``; without ``--device cpu`` it raises where there is no
CUDA device.
"""
from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.config import ShapeConfig as JShapeConfig
from repro.configs import get_arch as jget_arch
from repro.core import bsm as RB
from repro.core import engine as RE
from repro.core import signiter as RS
from repro.core import tensor as RT
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMData as JData
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamW
from repro.serving.engine import GenerationConfig as JGen
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.core import bsm as B
from repro_torch.core import tensor as T
from repro_torch.examples import (
    linear_scaling_dft,
    quickstart,
    serve_batch,
    tensor_contraction,
    train_lm,
)

TOL = 1e-5
TRAIN_TOL = 1e-4
NAMES = ("linear_scaling_dft", "quickstart", "tensor_contraction",
         "serve_batch", "train_lm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bsm(m):
    return interop.bsm_from_arrays(m.blocks, m.mask, m.norms, device="cpu")


def _tensor(t) -> T.BlockSparseTensor:
    """The reference's tensor in the port, bit for bit."""
    return T.BlockSparseTensor(
        blocks=torch.from_numpy(np.array(t.blocks)),
        mask=torch.from_numpy(np.array(t.mask)),
        norms=torch.from_numpy(np.array(t.norms)))


def _within(got, want, tol=TOL) -> None:
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# linear_scaling_dft
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hamiltonian():
    h = RB.random_bsm(jax.random.key(42), nb=12, bs=8, occupancy=0.10,
                      pattern="banded", bandwidth=2, symmetric=True)
    w = np.linalg.eigvalsh(np.asarray(h.to_dense(), np.float64))
    mu = float(np.median(w))
    return h, mu, int((w < mu).sum())


def test_linear_scaling_dft_matches_reference(hamiltonian):
    h, mu, n_occ = hamiltonian
    want, stats = RS.density_matrix(
        h, mu, threshold=1e-9, filter_eps=1e-8, max_iter=100, tol=1e-6,
        mode="fused", sync_every=4)
    assert stats.converged and abs(float(RS.trace(want)) - n_occ) < 0.05
    r = linear_scaling_dft.run(_bsm(h), device="cpu")
    assert r["mu"] == mu and r["n_occ"] == n_occ  # exactly
    assert isinstance(r["p"], B.ShardedBSM) and r["stats"].converged
    _within(r["p"].to_dense().numpy(), np.asarray(want.to_dense()))
    assert abs(r["trace"] - n_occ) < linear_scaling_dft.TRACE_TOL
    assert r["idempotency"] < linear_scaling_dft.IDEMPOTENCY_TOL
    assert r["cache"]["chain_misses"] == 1
    assert r["stats"].engine == "twofive"


def test_linear_scaling_dft_tuned_cold_then_warm(hamiltonian, tmp_path):
    h, mu, n_occ = hamiltonian
    db = str(tmp_path / "tuning_db.json")
    cold = linear_scaling_dft.run(_bsm(h), tuning_db=db, device="cpu")
    warm = linear_scaling_dft.run(_bsm(h), tuning_db=db, device="cpu")
    assert cold["cache"]["tuner_misses"] == 1
    assert 0 < cold["cache"]["tuner_trials"] <= 3
    assert warm["cache"]["tuner_trials"] == 0
    assert warm["cache"]["tuner_misses"] == 0
    assert warm["cache"]["tuner_hits"] >= 1
    assert warm["stats"].engine == cold["stats"].engine
    for r in (cold, warm):
        assert r["cache"]["chain_misses"] == 1
        assert abs(r["trace"] - n_occ) < linear_scaling_dft.TRACE_TOL
        assert r["idempotency"] < linear_scaling_dft.IDEMPOTENCY_TOL


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def test_quickstart_matches_reference():
    a, b = (RB.random_bsm(jax.random.key(s), nb=16, bs=16, occupancy=0.10,
                          pattern="decay") for s in (0, 1))
    want = RE.multiply_reference(a, b, threshold=1e-8)
    r = quickstart.run(_bsm(a), _bsm(b), device="cpu")
    assert sorted(r["c"]) == ["cannon", "gather", "onesided", "twofive/2d",
                              "twofive/scatter"]
    for c in [r["ref"], *r["c"].values()]:
        blocks, mask, _ = interop.bsm_to_numpy(c)
        np.testing.assert_array_equal(mask, np.asarray(want.mask))
        _within(blocks, np.asarray(want.blocks))
    filt = RB.filter_bsm(RE.multiply_reference(a, b, threshold=0.5), 0.05)
    np.testing.assert_array_equal(r["filtered"].mask.numpy(),
                                  np.asarray(filt.mask))
    assert float(r["filtered"].occupancy()) == float(filt.occupancy())
    _within(r["filtered"].blocks.numpy(), np.asarray(filt.blocks))


# ---------------------------------------------------------------------------
# tensor_contraction
# ---------------------------------------------------------------------------


def test_tensor_contraction_matches_reference(tmp_path):
    t = RT.random_tensor(jax.random.key(0), nbs=(8, 8, 8), bss=8,
                         occupancy=0.10, pattern="decay")
    op, op2 = (RT.random_tensor(jax.random.key(s), nbs=(8, 8), bss=8,
                                occupancy=0.3, pattern="decay")
               for s in (1, 2))
    db = str(tmp_path / "tuning_db.json")
    cold = tensor_contraction.run(_tensor(t), _tensor(op), _tensor(op2),
                                  tuning_db=db, device="cpu")
    want = RT.contract_reference("ijk,kl->ijl", t, op)
    chain = RT.contract_reference("ijk,kl,lm->ijm", t, op, op2)
    assert cold["mid"].sharded
    assert cold["tuner_trials"] > 0
    warm = tensor_contraction.run(_tensor(t), _tensor(op), _tensor(op2),
                                  tuning_db=db, device="cpu")
    assert warm["tuner_trials"] == 0 and warm["tuner_misses"] == 0
    for r in (cold, warm):
        _within(r["c"].to_dense().numpy(), want)
        _within(r["chain"].to_dense().numpy(), chain)


# ---------------------------------------------------------------------------
# serve_batch
# ---------------------------------------------------------------------------


def test_serve_batch_matches_reference():
    cfg = jget_arch("qwen1.5-4b").reduced()
    jp = JT.init_params(cfg, jax.random.key(0))
    prompts = serve_batch.prompts(cfg.vocab)
    want = JEngine(cfg, jp, batch=4, max_len=128,
                   gen=JGen(max_new_tokens=12, temperature=0.0)
                   ).generate(prompts)
    params = interop.params_from_jax(serve_batch.config(),
                                     jax.tree.map(np.asarray, jp),
                                     device="cpu")
    r = serve_batch.run(params, device="cpu")
    assert [list(map(int, o)) for o in want] == r["outs"]
    assert all(len(o) == 12 for o in r["outs"])
    assert r["match"] >= len(r["outs"][0]) - 1
    # no kernel on the CPU: the plain version ran
    assert r["gen_launches"] == r["fwd_launches"] == 0


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
             vocab=512)


def test_train_lm_matches_reference_one_device_step(tmp_path):
    seq, batch, steps = 32, 8, 3
    jcfg = dataclasses.replace(jget_arch("olmo-1b"), dtype="float32",
                               **SMALL)
    cfg = dataclasses.replace(train_lm.config(), **SMALL)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jstep, (_, o_sds, _) = JS.build_train_step(
        jcfg, mesh, JShapeConfig("train", seq, batch, "train"),
        opt=JAdamW(lr=3e-4, weight_decay=0.01),
        options=JS.StepOptions(remat="full", loss_chunk=seq))
    jp = JT.init_params(jcfg, jax.random.key(0))
    params = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    jo = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), o_sds)
    data = JData(JDataConfig(vocab=cfg.vocab, seq_len=seq,
                             global_batch=batch))
    losses, norms = [], []
    for i in range(steps):
        jb = {k: jnp.asarray(v) for k, v in data.batch_numpy(i).items()}
        jp, jo, m = jstep(jp, jo, jb)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    r = train_lm.run(cfg, steps=steps, seq_len=seq, global_batch=batch,
                     params=params, ckpt_dir=str(tmp_path), device="cpu")
    np.testing.assert_allclose(r["losses"], losses, rtol=TRAIN_TOL,
                               atol=TRAIN_TOL)
    np.testing.assert_allclose(r["grad_norms"], norms, rtol=TRAIN_TOL,
                               atol=TRAIN_TOL)
    assert r["latest"] == steps and r["ranks"] == 4


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES[:4])
def test_main_on_cpu_ends_ok(name, tmp_path, capsys):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    argv = ["--device", "cpu"]
    assert mod.main(argv) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == f"{name} OK"
    if name == "linear_scaling_dft":  # the tuned path, cold and warm
        argv += ["--tuning-db", str(tmp_path / "db.json")]
        for _ in range(2):
            assert mod.main(argv) == 0
        out = capsys.readouterr().out
        assert "autotuned engine: 0 trial(s)" in out
        assert out.strip().splitlines()[-1] == f"{name} OK"


@pytest.mark.parametrize("name", NAMES)
def test_main_without_cuda_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
