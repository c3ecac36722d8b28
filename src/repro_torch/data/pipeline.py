"""Deterministic synthetic LM data — the port's copy of
``repro/data/pipeline.py``.

The generator is pure numpy and is kept here as its own copy, so that
``batch_numpy(step)`` is bit for bit the reference's: Zipf-distributed
tokens with short-range Markov structure (with p = 0.5 the next token is
a fixed successor of the previous one), each row drawn from
``SeedSequence([seed, step, row])``.  A batch is a pure function of
(seed, step), so a run resumed from a checkpoint at step N regenerates
exactly the stream from N.

``make_global_batch`` gives the whole batch as int64 tensors on one
device, or on a mesh of ranks (the reference's form) each rank's rows
under a batch spec, generated for that rank alone (``_rows(step, lo,
hi)``) on its device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2  # Zipf exponent for the unigram distribution


class SyntheticLMData:
    """batch_numpy(step) -> {tokens, targets} with deterministic content."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed unigram distribution + a deterministic "grammar" permutation
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._probs = p / p.sum()
        rng = np.random.default_rng(cfg.seed)
        self._successor = rng.permutation(cfg.vocab)

    def _rows(self, step: int, row_lo: int, row_hi: int) -> np.ndarray:
        """Rows [row_lo, row_hi) of batch ``step``."""
        cfg = self.cfg
        out = np.empty((row_hi - row_lo, cfg.seq_len + 1), np.int32)
        for i, row in enumerate(range(row_lo, row_hi)):
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, row]))
            toks = rng.choice(cfg.vocab, size=cfg.seq_len + 1, p=self._probs)
            follow = rng.random(cfg.seq_len) < 0.5
            for t in range(1, cfg.seq_len + 1):
                if follow[t - 1]:
                    toks[t] = self._successor[toks[t - 1]]
            out[i] = toks
        return out

    def batch_numpy(self, step: int) -> dict[str, np.ndarray]:
        rows = self._rows(step, 0, self.cfg.global_batch)
        return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}


def make_global_batch(data: SyntheticLMData, step: int, device,
                      spec=None) -> dict:
    """Batch ``step`` (the values of ``batch_numpy``) as int64 tensors.

    ``device``: one device, which gets the whole (global_batch, seq_len)
    batch; or a ``launch.mesh.Mesh`` of ranks, which gets per-rank
    ``parallel.sharding.Shards`` of the rows ``spec`` (default:
    ``sharding.batch_spec``, rows over ``(pod, data)``) assigns each rank —
    the rows a rank holds are generated once, for it, on its device."""
    if not hasattr(device, "groups"):
        dev = torch.device(device)
        return {name: torch.from_numpy(a.astype(np.int64)).to(dev)
                for name, a in data.batch_numpy(step).items()}
    from repro_torch.parallel.sharding import Shards, batch_spec, chunk_index

    mesh, cfg = device, data.cfg
    if spec is None:
        spec = batch_spec(mesh, cfg.global_batch, cfg.seq_len)
    out, made = {"tokens": [], "targets": []}, {}
    for r in range(mesh.size):
        i, n = chunk_index(mesh, spec, r)[0]
        lo, hi = i * cfg.global_batch // n, (i + 1) * cfg.global_batch // n
        key = (lo, hi, mesh.home(r))
        if key not in made:
            rows = torch.from_numpy(data._rows(step, lo, hi).astype(np.int64))
            made[key] = (rows[:, :-1].to(mesh.devices[r]),
                         rows[:, 1:].to(mesh.devices[r]))
        out["tokens"].append(made[key][0])
        out["targets"].append(made[key][1])
    return {name: Shards(v) for name, v in out.items()}
