"""The one traffic generator: it reads a mix's parameters (a JSON file
under ``perfbench/traffic/``) and draws the requests from the seed.

Every seed gets the same sizes; the seed changes only the order of a
cycle's rounds, the token ids and which requests are checked.  A mix of
rounds takes its prompt lengths from a length distribution
(``prompt_tokens``: a lognormal of the given mean and log standard
deviation): its ``classes`` quantile midpoints, ``(i + 1/2) / classes``.
A cycle holds one round of each class, and a round's prompts are all of
its class's length, since the serving engine pads the prompts it admits
together to the longest.  Each request's tokens come from their own
stream, ``numpy.random.default_rng([seed, stream, index])``, so a round's
prompts do not depend on how many rounds ran before it.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from statistics import NormalDist

import numpy as np

SESSIONS, ROUNDS, WARM, CHECK, ORDER = 0, 1, 2, 3, 4


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def lengths(dist: dict, n: int) -> list[int]:
    """The ``n`` quantile midpoints of the lognormal length distribution
    ``dist`` (``mean``, ``log_sd``), rounded, in rising order."""
    sd = float(dist["log_sd"])
    mu = math.log(float(dist["mean"])) - sd * sd / 2
    nd = NormalDist()
    return [max(1, round(math.exp(mu + sd * nd.inv_cdf((i + 0.5) / n))))
            for i in range(n)]


def _prompt(seed: int, stream: int, index: int, length: int,
            vocab: int) -> np.ndarray:
    rng = np.random.default_rng([seed, stream, index])
    return rng.integers(0, vocab, size=length).astype(np.int32)


def session_prompts(t: dict, seed: int, vocab: int) -> list[np.ndarray]:
    """The prompts of the ``sessions`` concurrent sessions."""
    return [_prompt(seed, SESSIONS, i, t["prompt_len"], vocab)
            for i in range(t["sessions"])]


def round_length(t: dict, seed: int, r: int, warm: bool = False) -> int:
    """The prompt length of round ``r``: cycle ``r // classes`` takes the
    classes in an order drawn for it (warm-up rounds draw their own)."""
    sizes = lengths(t["prompt_tokens"], t["classes"])
    k = len(sizes)
    order = np.random.default_rng(
        [seed, ORDER, WARM if warm else ROUNDS, r // k]).permutation(k)
    return sizes[order[r % k]]


def round_prompts(t: dict, seed: int, vocab: int, r: int,
                  warm: bool = False) -> list[np.ndarray]:
    """Round ``r``'s ``requests_per_round`` prompts, all of the round's
    length (warm-up rounds draw from a stream of their own)."""
    stream = WARM if warm else ROUNDS
    n = t["requests_per_round"]
    size = round_length(t, seed, r, warm)
    return [_prompt(seed, stream, r * n + i, size, vocab) for i in range(n)]


def check_sample(seed: int, n: int, k: int) -> list[int]:
    """``min(k, n)`` of the indices 0 .. n - 1, drawn from the seed, in
    order."""
    rng = np.random.default_rng([seed, CHECK])
    return sorted(int(i) for i in rng.choice(n, size=min(k, n),
                                             replace=False))
