"""The port's copy of the synthetic LM data stream against the
reference's ``repro.data``: ``batch_numpy`` bit for bit over seeds, steps
and shapes, and ``make_global_batch`` as int64 tensors of the same
values on the device asked for."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMData as JData
from repro_torch.data import DataConfig, SyntheticLMData, make_global_batch


@pytest.mark.parametrize("vocab,seq,batch,seed,zipf", [
    (512, 16, 4, 0, 1.2),
    (50304, 64, 2, 7, 1.2),
    (100, 33, 3, 123, 0.9),
])
def test_batch_numpy_equals_reference(vocab, seq, batch, seed, zipf):
    kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed,
              zipf_a=zipf)
    ours, ref = SyntheticLMData(DataConfig(**kw)), JData(JDataConfig(**kw))
    for step in (0, 1, 5, 1000):
        got, want = ours.batch_numpy(step), ref.batch_numpy(step)
        assert sorted(got) == sorted(want) == ["targets", "tokens"]
        for name in got:
            assert got[name].dtype == want[name].dtype == np.int32
            np.testing.assert_array_equal(got[name], want[name])


def test_make_global_batch_on_the_cpu():
    data = SyntheticLMData(DataConfig(vocab=512, seq_len=16, global_batch=4,
                                      seed=3))
    b = make_global_batch(data, 2, "cpu")
    want = data.batch_numpy(2)
    for name in ("tokens", "targets"):
        assert b[name].dtype == torch.int64 and b[name].device.type == "cpu"
        np.testing.assert_array_equal(b[name].numpy(), want[name])
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_stream_is_step_addressable_and_learnable():
    """A fresh instance regenerates any step; half the transitions follow
    the fixed successor table (the structure a model can learn)."""
    cfg = DataConfig(vocab=512, seq_len=128, global_batch=8, seed=1)
    a, b = SyntheticLMData(cfg), SyntheticLMData(cfg)
    np.testing.assert_array_equal(a.batch_numpy(9)["tokens"],
                                  b.batch_numpy(9)["tokens"])
    rows = a._rows(0, 0, 8)
    follow = (a._successor[rows[:, :-1]] == rows[:, 1:]).mean()
    assert 0.45 < follow < 0.6


def test_make_global_batch_on_a_mesh_gives_each_rank_its_rows():
    """``check_data_global_batch``: on a (data 4, model 2) mesh of ranks
    each rank holds its data shard's rows of ``batch_numpy`` (model ranks
    share them), generated for that shard alone."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import Shards, batch_spec, unshard

    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    data = SyntheticLMData(DataConfig(vocab=64, seq_len=16, global_batch=8))
    spec = batch_spec(mesh, 8, 16)
    assert spec[0] == "data"
    gb = make_global_batch(data, 2, mesh, spec)
    want = data.batch_numpy(2)
    for name in ("tokens", "targets"):
        assert isinstance(gb[name], Shards) and len(gb[name]) == 8
        for r in range(8):
            d = mesh.coords(r)[0]
            assert gb[name][r].dtype == torch.int64
            np.testing.assert_array_equal(gb[name][r].numpy(),
                                          want[name][2 * d:2 * d + 2])
        np.testing.assert_array_equal(
            unshard(mesh, gb[name], spec).numpy(), want[name])
