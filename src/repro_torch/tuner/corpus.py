"""Application-pattern corpus for the tuner — the torch twin of
``repro/tuner/corpus.py``.

The winning algorithm depends on the application's sparsity pattern
(uniform random masks mislead), so the tuner is exercised on the pattern
families of CP2K-shaped inputs:

``dft_chain``    banded block structure of a quasi-1D linear-scaling DFT
                 chain: occupied where |i - j| <= bandwidth.
``exp_decay``    occupation probability decaying exponentially with block
                 distance — 3D linear-scaling DFT operators (H, S, P).
``zipf``         Zipf-distributed block-row loads in natural order: a few
                 hub rows nearly dense, most nearly empty.
``uniform``      distance-independent occupation, the load-balanced limit
                 of a randomized block permutation.
``three_center`` the matricized (nb^2, nb) mask of a screened
                 three-center integral tensor (ij|k) against a square
                 decay-patterned operand.

Masks are drawn from ``np.random.default_rng(seed)``: ``make_mask`` and
``three_center_mask`` take a seed where the reference takes a jax key, and
given the key's two data words they draw the reference's masks bit for
bit.  ``CorpusEntry`` derives its seeds from ``seed`` alone (``(seed, 0)``
for A's mask, ``(seed, 1)`` for B's) and its block values from a
``torch.Generator``; ``three_center`` entries build a 3-index
``core.tensor.BlockSparseTensor`` and its matricized view.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import bsm as B

# the 2-index mask families make_mask() builds; three_center lives at the
# CorpusEntry level (its A mask is a matricized 3-index pattern)
KINDS = ("dft_chain", "exp_decay", "zipf", "uniform")
ENTRY_KINDS = KINDS + ("three_center",)

@dataclass(frozen=True)
class CorpusEntry:
    name: str
    kind: str
    nb: int
    bs: int
    occupancy: float = 0.1
    bandwidth: int = 2
    zipf_alpha: float = 1.4
    seed: int = 0
    threshold: float = 1e-6
    params: dict = field(default_factory=dict)

    @property
    def symmetric(self) -> bool:
        return self.kind in ("dft_chain", "exp_decay")

    def masks(self) -> tuple[np.ndarray, np.ndarray]:
        """The (A, B) occupation masks of this entry — the (symmetrized)
        patterns ``build`` fills — without any block data.  Three-center
        entries give the matricized (nb^2, nb) tensor mask and the square
        (nb, nb) mask of the ``kl`` operand."""
        seed_a, seed_b = (self.seed, 0), (self.seed, 1)
        if self.kind == "three_center":
            ma = three_center_mask(self.nb, seed_a, occupancy=self.occupancy)
            mb = make_mask("exp_decay", self.nb, seed_b,
                           occupancy=max(self.occupancy, 0.15))
            return ma, mb
        ma = make_mask(self.kind, self.nb, seed_a,
                       occupancy=self.occupancy, bandwidth=self.bandwidth,
                       zipf_alpha=self.zipf_alpha)
        if self.symmetric:
            ma = ma | ma.T
            return ma, ma  # H . H: the purification multiply
        # independent second operand: SpGEMM traffic, not purification
        mb = make_mask(self.kind, self.nb, seed_b,
                       occupancy=self.occupancy,
                       zipf_alpha=self.zipf_alpha)
        return ma, mb

    def imbalance(self, p_r: int = 2, p_c: int = 2) -> float:
        """Max/mean per-rank product load of this entry's multiply on a
        (p_r, p_c) grid under the identity assignment."""
        from repro_torch.core.commvolume import load_imbalance
        from repro_torch.core.distribute import product_counts

        ma, mb = self.masks()
        return load_imbalance(product_counts(ma, mb), p_r, p_c)

    def build(self, device=None) -> tuple[B.BlockSparseMatrix,
                                          B.BlockSparseMatrix]:
        """Reproducible (A, B) operand pair for this entry on ``device``
        (CUDA unless the caller names another); values are drawn on the
        CPU, so every device gets the same numbers.

        Three-center entries return the MATRICIZED tensor operand — an
        (nb^2, nb) tall-skinny ``BlockSparseMatrix`` whose mask is
        ``masks()[0]`` — so every family goes through one matrix
        interface."""
        from repro_torch.config import resolve_device

        if self.kind == "three_center":
            from repro_torch.core import tensor as T

            t, b = self.build_tensor(device)
            return T.matricize(t, (0, 1), (2,)), b

        dev = resolve_device(device)
        ma, mb = self.masks()
        a = _fill(ma, 2 * self.seed, self.bs, symmetric=self.symmetric,
                  device=dev)
        if self.symmetric:
            return a, a
        return a, _fill(mb, 2 * self.seed + 1, self.bs, symmetric=False,
                        device=dev)

    def build_tensor(self, device=None):
        """The un-flattened (T, B) operand pair of a three-center entry:
        the 3-index ``BlockSparseTensor`` (ij|k), N(0, 1) / bs^1.5 blocks,
        and the square (k, l) matrix it contracts with through
        ``contract("ijk,kl->ijl")``."""
        if self.kind != "three_center":
            raise ValueError(
                f"build_tensor() is only defined for three_center "
                f"entries, not kind={self.kind!r}")
        from repro_torch.config import resolve_device
        from repro_torch.core import tensor as T

        dev = resolve_device(device)
        nb, bs = self.nb, self.bs
        m3 = _three_center_mask3(nb, (self.seed, 0), occupancy=self.occupancy)
        gen = torch.Generator().manual_seed(2 * self.seed)
        blocks = torch.randn((nb,) * 3 + (bs,) * 3, generator=gen) / bs**1.5
        t = T.make_tensor(blocks.to(dev), torch.from_numpy(m3).to(dev))
        _, mb = self.masks()
        return t, _fill(mb, 2 * self.seed + 1, bs, symmetric=False,
                        device=dev)


def _rng(seed) -> np.random.Generator:
    return np.random.default_rng(seed)


def _with_diag(m: np.ndarray) -> np.ndarray:
    n = min(m.shape)
    m[np.arange(n), np.arange(n)] = True
    return m


def make_mask(kind: str, nb: int, seed, *, occupancy: float = 0.1,
              bandwidth: int = 2, zipf_alpha: float = 1.4) -> np.ndarray:
    """Concrete (nb, nb) occupation mask of one corpus family; ``seed`` is
    anything ``np.random.default_rng`` takes."""
    rng = _rng(seed)
    i = np.arange(nb)[:, None]
    j = np.arange(nb)[None, :]
    if kind == "dft_chain":
        m = np.abs(i - j) <= bandwidth
    elif kind == "exp_decay":
        scale = max(occupancy * nb / 2.0, 1e-3)
        m = rng.random((nb, nb)) < np.exp(-np.abs(i - j) / scale)
    elif kind == "uniform":
        m = rng.random((nb, nb)) < occupancy
    elif kind == "zipf":
        # row r carries weight (r+1)^-alpha in natural order, hub rows
        # clustered at the top; normalized to a mean fill of `occupancy`
        w = (np.arange(nb, dtype=np.float64) + 1.0) ** -zipf_alpha
        p_row = np.clip(w * (occupancy * nb / w.sum()), 0.0, 1.0)
        m = rng.random((nb, nb)) < p_row[:, None]
    else:
        raise ValueError(f"unknown corpus kind {kind!r}; one of {KINDS}")
    return _with_diag(np.asarray(m, bool))


def _fill(mask: np.ndarray, seed: int, bs: int, *, symmetric: bool,
          device) -> B.BlockSparseMatrix:
    mask = np.asarray(mask, bool)
    if symmetric:
        mask = mask | mask.T
    nb_r, nb_c = mask.shape
    gen = torch.Generator().manual_seed(int(seed))
    blocks = torch.randn((nb_r, nb_c, bs, bs), generator=gen) / np.sqrt(bs)
    if symmetric:
        blocks = 0.5 * (blocks + blocks.permute(1, 0, 3, 2))
    return B.make_bsm(blocks.to(device),
                      torch.from_numpy(mask).to(device))


def _three_center_mask3(nb: int, seed, *, occupancy: float = 0.1,
                        decay: float = 0.25) -> np.ndarray:
    """Decayed (nb, nb, nb) occupation mask of a screened three-center
    integral tensor (ij|k): occupation probability falls exponentially
    with the normalized index spread max(i,j,k) - min(i,j,k); the
    i == j == k fiber is always kept."""
    rng = _rng(seed)
    i = np.arange(nb, dtype=np.float64)
    spread = (np.maximum(np.maximum(i[:, None, None], i[None, :, None]),
                         i[None, None, :])
              - np.minimum(np.minimum(i[:, None, None], i[None, :, None]),
                           i[None, None, :])) / max(nb - 1, 1)
    shape = np.exp(-spread / decay)
    # amplitude calibrated so the MEAN fill matches `occupancy`
    p = np.clip(shape * (occupancy / shape.mean()), 0.0, 1.0)
    m = rng.random((nb, nb, nb)) < p
    m |= spread == 0.0
    return np.asarray(m, bool)


def three_center_mask(nb: int, seed, *, occupancy: float = 0.1,
                      decay: float = 0.25) -> np.ndarray:
    """The matricized (nb^2, nb) view of the three-center mask: indices
    (i, j) flattened block-major onto rows, k onto columns."""
    m3 = _three_center_mask3(nb, seed, occupancy=occupancy, decay=decay)
    return m3.reshape(nb * nb, nb)


def corpus(*, nb: int = 16, bs: int = 16, smoke: bool = False) -> list[CorpusEntry]:
    """The standard tuner corpus (``smoke`` shrinks sizes for CI); the
    ``bigblock`` entry carries blocks above the kernel's 96-wide panel."""
    if smoke:
        nb, bs = min(nb, 8), min(bs, 8)
    big_nb, big_bs = (4, 64) if smoke else (max(nb // 2, 8), 128)
    return [
        CorpusEntry("dft_chain_narrow", "dft_chain", nb, bs,
                    bandwidth=max(1, nb // 8), seed=11),
        CorpusEntry("dft_chain_wide", "dft_chain", nb, bs,
                    bandwidth=max(2, nb // 4), seed=12),
        CorpusEntry("exp_decay_sparse", "exp_decay", nb, bs,
                    occupancy=0.08, seed=13),
        CorpusEntry("exp_decay_filled", "exp_decay", nb, bs,
                    occupancy=0.35, seed=14),
        CorpusEntry("zipf_hub", "zipf", nb, bs,
                    occupancy=0.15, zipf_alpha=1.4, seed=15),
        CorpusEntry("dft_chain_bigblock", "dft_chain", big_nb, big_bs,
                    bandwidth=max(1, big_nb // 4), seed=16),
        # tall-skinny matricized tensor product: (nb^2, nb) @ (nb, nb)
        CorpusEntry("three_center_tall", "three_center",
                    4 if smoke else 8, bs, occupancy=0.10, seed=17),
    ]
