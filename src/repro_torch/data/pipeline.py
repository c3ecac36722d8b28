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
device.  The reference builds a batch sharded over a mesh from host-local
rows; on one device there are no shard-local rows, and the mesh form
comes with the sharded training of ROADMAP.md Queue A item 15b.
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


def make_global_batch(data: SyntheticLMData, step: int,
                      device) -> dict[str, torch.Tensor]:
    """Batch ``step`` as int64 (global_batch, seq_len) tensors on
    ``device`` (the values of ``batch_numpy``)."""
    dev = torch.device(device)
    return {name: torch.from_numpy(a.astype(np.int64)).to(dev)
            for name, a in data.batch_numpy(step).items()}
