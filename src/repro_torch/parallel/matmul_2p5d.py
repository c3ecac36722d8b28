"""The paper's 2.5D schedule applied to the LM's largest matmul — the twin
of ``repro/parallel/matmul_2p5d.py`` on a mesh of ranks.

The 2.5D SpGEMM insight — split the contraction dimension over a depth
axis L, compute partial products against the *home* layout, and fuse the
partial-result reduction into one collective — applies verbatim to the
LM-head / embedding matmul, whose (d_model x vocab) weight is the biggest
single GEMM of most architectures.  On a ``(pod, data, model)`` mesh the
``pod`` axis plays L:

    w (d, V)  sharded  P("pod", "model")  — d split over L, V over TP
    x (T, d)  sharded  P(None, "pod")     — activations split over d too
    partial = x_l @ w_l                   — no communication
    logits  = psum_scatter(partial, "pod") — the (L-1)-panel reduction

Per rank the scatter moves (L-1)/L of the logits shard instead of
all-gathering a d-sharded weight — the paper's "(L-1) S_C vs
V/sqrt(L) (S_A+S_B)" trade of Eq. (7); ``plan_2p5d`` evaluates it.  Under
the transport's conventions (a psum-scatter costs (n-1) times its output)
the scatter form moves exactly ``plan_2p5d(...).bytes_2p5d`` per rank.
The partial product is ``torch.matmul`` (the reference's is an
``einsum``, not a kernel); the collectives are differentiable
(``parallel/collectives.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import P, Shards, shard, unshard


def matmul_2p5d(mesh, xs, ws, *, depth_axis: str = "pod",
                tp_axis: str = "model", reduce: str = "scatter") -> list:
    """x @ w from per-rank shards: ``xs[r]`` (..., T, d / L), rank r's
    slice of the contraction dim by its ``depth_axis`` coordinate, and
    ``ws[r]`` (d / L, V / tp), its (depth, tp) block.  ``reduce="scatter"``
    gives rank r the token chunk of its depth coordinate, (..., T / L,
    V / tp) — ``P(depth, tp)``, the chunked-CE form; ``"psum"`` the whole
    (..., T, V / tp) on every depth rank."""
    if reduce not in ("scatter", "psum"):
        raise ValueError(f"reduce {reduce!r}: scatter or psum")
    partial = [torch.matmul(x, w) for x, w in zip(xs, ws)]
    if reduce == "scatter":
        return C.psum_scatter(mesh, partial, depth_axis,
                              dim=partial[0].dim() - 2)
    return C.psum(mesh, partial, depth_axis)


def place_2p5d(mesh, x: torch.Tensor, w: torch.Tensor, *,
               depth_axis: str = "pod", tp_axis: str = "model"):
    """(xs, ws): a full x (T, d) and w (d, V) placed as ``matmul_2p5d``
    takes them."""
    return (shard(mesh, x, P(None, depth_axis)),
            shard(mesh, w, P(depth_axis, tp_axis)))


def gather_2p5d(mesh, outs, *, depth_axis: str = "pod",
                tp_axis: str = "model", reduce: str = "scatter"):
    """The full (T, V) product from ``matmul_2p5d``'s per-rank outputs."""
    spec = P(depth_axis, tp_axis) if reduce == "scatter" else P(None,
                                                                 tp_axis)
    return unshard(mesh, Shards(outs), spec)


@dataclass(frozen=True)
class Plan2p5d:
    l: int
    bytes_baseline: float  # all-gather the d-sharded weight per step
    bytes_2p5d: float  # psum_scatter of the partial logits
    wins: bool


def plan_2p5d(
    tokens: int, d_model: int, vocab: int, l: int, tp: int, bytes_per_el: int = 2
) -> Plan2p5d:
    """Napkin math for claiming the pod axis as 2.5D depth on the LM head.

    Baseline (pure DP over pod): weight fully resident, logits local — but
    the FSDP variant all-gathers W (d x V / tp) per step: d*V/tp bytes.
    2.5D: psum_scatter moves (l-1)/l of the partial logits: T*V/tp*(l-1)/l.
    """
    base = d_model * vocab / tp * bytes_per_el
    ours = tokens * vocab / tp * (l - 1) / l * bytes_per_el
    return Plan2p5d(l=l, bytes_baseline=base, bytes_2p5d=ours, wins=ours < base)
