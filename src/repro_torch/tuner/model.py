"""Analytic candidate model: enumerate, cost and prune — the torch twin of
``repro/tuner/model.py``.

The tuner's first stage does no device work.  For a mesh and a feature
vector it enumerates every feasible ``(engine, L, backend, capacity,
transport, group layout, assignment)`` point and prices each with

* the paper's communication-volume model on the plan's actual schedule
  (``commvolume.plan_volume``, Eq. (7)), at ``COPY_BW`` bytes per second,
  plus ``TICK_OVERHEAD_S`` per schedule tick;
* the local-stage cost model (``local_mm.local_stage_cost``: the whole
  cube for ``dense``, the surviving products for the compacted backends)
  at ``PEAK_FLOPS``, stretched by the candidate's own product-load
  imbalance for the compacted backends;

and prunes every candidate whose Eq. (6) footprint per rank
(``commvolume.device_memory_bytes`` with the product-list arrays sized by
``plan.get_device_capacity``) exceeds ``device_memory_budget``.  The
survivors, ranked by modeled time, are what ``tuner.measure`` times.

Ranks that share one device (every rank of a mesh on the one card, or on
the CPU) run one after another, and the model prices them so
(``ranks_per_device``): the device does the summed local work whatever
the balance, so there is no division by the ranks and no imbalance
stretch; the copies share the device's copy rate; a compressed panel
still lands as a dense one, so it costs the dense panel's bytes plus its
packed bytes; and only the identity assignment is ranked unless the
caller pins another, since balance buys nothing there.  A mesh without
devices (a duck-typed one) and a mesh of distinct devices keep the
reference's distributed formulas.

Backends follow the operands' device: ``("dense", "cuda")`` on CUDA
tensors, ``("dense", "stacks")`` on the CPU (the reference's
``("jnp", "pallas" | "stacks")``).  The group-layout axis
(``kernels.block_spgemm.tile_candidates``) belongs to ``cuda`` only, and
holds the default group alone until a smaller one wins on the card.
The enumeration keeps the reference's order: ``sorted`` is stable and
tied estimates are common, so the order decides an analytic winner.
"""
from __future__ import annotations

import math
import os
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import commvolume
from repro_torch.core import plan as plan_mod
from repro_torch.core.local_mm import backend_local_cost, local_stage_cost
from repro_torch.core.topology import validate_l
from repro_torch.tuner.features import PairFeatures

# --- H100 constants (NVIDIA H100 80GB HBM3, 700 W) --------------------------
# f32 FMA peak on the CUDA cores (data sheet), the bound of PERF.md's kernel
# table: the local stage runs f32 outside the tensor cores
PEAK_FLOPS = 67e12
# wire bytes per rank per second of a rank-to-rank panel copy with every
# rank on one card: one dense H2O-DFT-LS panel hop at nb 512 on a (r 2,
# c 2) mesh moved 138,739,712 bytes per rank in 0.4112 ms (median of CUDA
# events, chip_smoke.py phase 14.0, NVIDIA H100 80GB HBM3).  The ranks copy
# one after another, so a mesh of n ranks on the card sees about
# COPY_RANKS/n of it
COPY_BW = 3.374e11
COPY_RANKS = 4  # the ranks that shared the card when COPY_BW was measured
# per-tick dispatch overhead, seconds: a PLACEHOLDER (the reference's), not
# measured on the card; it only orders many-tick schedules against the
# one-shot gather when their bytes tie
TICK_OVERHEAD_S = 20e-6

# per-rank memory budget off the card: the reference's (16 GB with a 10 %
# reserve), so CPU decisions equal the reference's
_DEFAULT_BUDGET = 0.9 * 16e9


def ranks_per_device(mesh) -> int:
    """The most ranks of ``mesh`` placed on one device: 1 for distinct
    devices and for a mesh without devices (the reference's model), the
    mesh size when every rank is on the one card or on the CPU."""
    devices = getattr(mesh, "devices", None)
    if not devices:
        return 1
    return max(Counter(torch.device(d) for d in devices).values())


def device_memory_budget(mesh=None) -> float:
    """Per-rank byte budget (``REPRO_DEVICE_MEMORY_BYTES`` overrides).  On
    a CUDA mesh 90 % of the card's memory shared by the ranks placed on
    that card (Eq. (6) must hold per share); elsewhere the reference's
    ``0.9 * 16e9``."""
    raw = os.environ.get("REPRO_DEVICE_MEMORY_BYTES", "").strip()
    if raw:
        return float(raw)
    devices = getattr(mesh, "devices", None)
    if devices:
        dev = torch.device(devices[0])
        if dev.type == "cuda":
            total = torch.cuda.get_device_properties(dev).total_memory
            return 0.9 * total / ranks_per_device(mesh)
    return _DEFAULT_BUDGET


_ASSIGN_TAGS = {"randomized": "@rand", "nnz_greedy": "@nnz"}


def _label(engine: str, l, backend: str, tile, transport: str,
           assign: str) -> str:
    tag = engine if l is None else f"{engine}-l{l}"
    tag = f"{tag}/{backend}"
    if tile is not None:
        tag = f"{tag}/g{tile[0]}x{tile[1]}"
    if transport == "compressed":
        tag += "+ct"
    return tag + _ASSIGN_TAGS.get(assign, "")


@dataclass(frozen=True)
class Candidate:
    """One point of the tuner's decision space."""

    engine: str
    l: int | None = None  # depth of twofive pull plans (None: the plan's)
    backend: str = "dense"
    stack_capacity: int | None = None  # compacted backends: per-rank bound
    transport: str = "dense"  # panel transport mode ("dense"|"compressed")
    tile: tuple[int, int] | None = None  # cuda group layout (None: default)
    assign: str = "identity"  # block->rank assignment (distribute.MODES)

    @property
    def label(self) -> str:
        return _label(self.engine, self.l, self.backend, self.tile,
                      self.transport, self.assign)


@dataclass(frozen=True)
class Estimate:
    """Analytic cost of one candidate on one (mesh, features) pair."""

    candidate: Candidate
    comm_s: float
    compute_s: float
    mem_bytes: float
    feasible: bool
    reason: str = ""  # why infeasible (empty when feasible)

    @property
    def total_s(self) -> float:
        return self.comm_s + self.compute_s


@dataclass(frozen=True)
class ModelReport:
    """Ranked feasible candidates, everything pruned, and the host
    seconds the analytic stage took."""

    ranked: tuple[Estimate, ...]  # feasible, best modeled time first
    pruned: tuple[Estimate, ...] = field(default=())
    n_candidates: int = 0
    host_s: float = 0.0


def mesh_signature(mesh) -> tuple:
    """Hashable, JSON-able identity of a mesh for decision/DB keys."""
    return tuple((name, int(mesh.shape[name])) for name in mesh.axis_names)


def valid_square_depths(p: int) -> list[int]:
    """Depths L > 1 valid on a square p x p grid (paper §3 rule)."""
    return [k * k for k in range(2, p + 1) if p % k == 0]


def default_backends(device=None) -> tuple[str, str]:
    """The local backends worth ranking on ``device``: the dense stage and
    the compacted flavour the device runs (the CUDA kernel on a card, the
    plain stacks path on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        return ("dense", "cuda")
    return ("dense", "stacks")


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def assignment_space(
    counts, mesh, *, assigns: tuple[str, ...] | None = None
) -> dict[str, object]:
    """The assignment modes worth ranking for one (counts, mesh) pair,
    resolved to their ``distribute.Assignment`` (identity maps to None).
    Without ``counts`` only identity survives; so it does on a non-square
    block grid or one that ``lcm(p_r, p_c)`` does not divide."""
    from repro_torch.core import distribute as D

    if assigns is None:
        assigns = D.MODES
    out: dict[str, object] = {}
    for mode in assigns:
        if mode == "identity":
            out["identity"] = None
            continue
        if counts is None:
            continue
        c = np.asarray(counts)
        if c.shape[0] != c.shape[1] or c.shape[0] % math.lcm(
            int(mesh.shape["r"]), int(mesh.shape["c"])
        ):
            continue
        out[mode] = D.assignment_for(mode, c, (mesh.shape["r"],
                                               mesh.shape["c"]))
    if not out:
        out["identity"] = None
    return out


def _engine_pairs(mesh) -> list[tuple[str, int | None]]:
    """(engine, depth) pairs a mesh admits, in the reference's order."""
    if "l" in tuple(mesh.axis_names):
        # stacked (l, r, c) mesh: the depth is physical, twofive only
        return [("twofive", None)]
    p_r, p_c = int(mesh.shape["r"]), int(mesh.shape["c"])
    if p_r == p_c:
        pairs = [("cannon", None), ("onesided", None), ("gather", None)]
        return pairs + [("twofive", d) for d in valid_square_depths(p_r)]
    pairs = [("onesided", None), ("gather", None)]
    mn, mx = min(p_r, p_c), max(p_r, p_c)
    if validate_l(p_r, p_c, mx // mn) and mx // mn > 1:
        pairs.append(("twofive", mx // mn))
    return pairs


def enumerate_candidates(
    mesh,
    feats: PairFeatures,
    *,
    ok=None,
    counts=None,
    engines: tuple[str, ...] | None = None,
    backends: tuple[str, ...] | None = None,
    l: int | None = None,
    transports: tuple[str, ...] | None = None,
    assigns: tuple[str, ...] | None = None,
    device=None,
) -> list[Candidate]:
    """All (engine, L, backend, capacity, transport, group layout,
    assignment) points feasible for ``mesh``, in the reference's order.

    ``ok`` — the concrete numpy filter cube: with it the compacted
    backends get their exact bucketed per-rank capacity
    (``plan.get_device_capacity``); without it they are skipped, and so is
    compressed transport.  ``counts`` — the integer mask product: with it
    non-identity assignments join for the candidates they can change (the
    compacted backends, compressed transport; a dense stage with dense
    panels does the same work in any layout).  ``engines`` / ``l`` /
    ``backends`` / ``transports`` / ``assigns`` restrict the space; with
    ``assigns`` left open, ranks sharing one device rank identity only.
    ``device`` — the operands' device, which sets the default backends.

    The permuted cube is made once per assignment mode and the capacity
    once per (mode, engine), however many backends, transports and group
    layouts share them: each is a copy or a digest of the whole cube.
    """
    if transports is None:
        transports = ("dense", "compressed") if ok is not None else ("dense",)
    elif ok is None:
        transports = tuple(t for t in transports if t == "dense")
    if backends is None:
        backends = default_backends(device)
    if assigns is None and ranks_per_device(mesh) > 1:
        assigns = ("identity",)  # ranks in turn: balance buys nothing
    assign_map = assignment_space(counts, mesh, assigns=assigns)

    pairs = _engine_pairs(mesh)
    if engines is not None:
        pairs = [(e, d) for e, d in pairs if e in engines]
    if l is not None:
        pairs = [(e, d) for e, d in pairs
                 if (d == l if e == "twofive" else False) or e != "twofive"]

    cubes: dict[str, np.ndarray] = {}
    caps: dict[tuple[str, str], int] = {}

    def capacity(mode: str, asg, engine: str) -> int:
        if (mode, engine) not in caps:
            if mode not in cubes:
                if asg is None:
                    cubes[mode] = ok
                else:
                    from repro_torch.core.distribute import permute_cube

                    cubes[mode] = permute_cube(ok, asg.perm)
            caps[(mode, engine)] = plan_mod.get_device_capacity(
                cubes[mode], mesh, engine)
        return caps[(mode, engine)]

    out: list[Candidate] = []
    for engine, depth in pairs:
        try:
            plan = plan_mod.plan_multiply(mesh, engine, depth)
            plan.validate_blocks(feats.nb_r, feats.nb_c, feats.nb_k)
        except ValueError:
            continue  # block grid does not divide this topology
        for backend in backends:
            for tp in transports:
                for mode, asg in assign_map.items():
                    if (mode != "identity" and backend == "dense"
                            and tp != "compressed"):
                        # dense panels + dense stage: every rank does the
                        # same work in any layout
                        continue
                    if backend == "dense":
                        out.append(Candidate(
                            engine, depth, "dense", None, tp, None, mode
                        ))
                    elif ok is not None:
                        cap = capacity(mode, asg, engine)
                        if cap > 0:
                            for tile in _backend_tiles(backend, feats):
                                out.append(Candidate(
                                    engine, depth, backend, cap, tp,
                                    tile, mode
                                ))
    return out


def _backend_tiles(backend: str, feats: PairFeatures) -> list:
    """Group-layout axis of the search space: only the CUDA kernel has
    one (``[None]``, the default, for every other backend)."""
    if backend != "cuda":
        return [None]
    from repro_torch.kernels.block_spgemm import tile_candidates

    return tile_candidates(feats.bs_r, feats.bs_c, _torch_dtype(feats.dtype))


def _n_devices(mesh) -> int:
    n = 1
    for name in mesh.axis_names:
        n *= int(mesh.shape[name])
    return n


def estimate_candidate(
    cand: Candidate,
    mesh,
    feats: PairFeatures,
    *,
    budget_bytes: float | None = None,
    imbalance: float | None = None,
) -> Estimate:
    """Model one candidate: comm seconds + local-compute seconds + the
    Eq. (6) memory verdict.  ``imbalance`` — max/mean per-rank product
    load under THIS candidate's assignment (defaults to the features'
    canonical-grid statistic); it stretches the compacted backends'
    compute, whose work follows the products, and leaves the dense stage
    (the full cube on every rank) alone.  Ranks sharing one device are
    priced as they run, in turn (see the module docstring)."""
    budget = device_memory_budget(mesh) if budget_bytes is None \
        else budget_bytes
    plan = plan_mod.plan_multiply(mesh, cand.engine, cand.l)
    dtype = _torch_dtype(feats.dtype)
    itemsize = float(dtype.itemsize)
    # compressed transport scales the Eq. (7) A/B term by panel occupancy
    # (analytic flavour; execution derives the exact bucketed capacities)
    vol = commvolume.plan_volume(
        plan, feats.nb_r, feats.bs_r, itemsize=itemsize,
        transport=cand.transport, occ_a=feats.occ_a, occ_b=feats.occ_b,
        nb_k=feats.nb_k, nb_c=feats.nb_c,
        bs_k=feats.bs_k, bs_c=feats.bs_c,
    )
    shared = ranks_per_device(mesh)
    if shared == 1:
        comm_s = vol.total / COPY_BW
    else:
        wire = vol.total
        if cand.transport == "compressed":
            # unpacked into a whole dense panel on the same device
            wire += commvolume.plan_volume(
                plan, feats.nb_r, feats.bs_r, itemsize=itemsize,
                nb_k=feats.nb_k, nb_c=feats.nb_c,
                bs_k=feats.bs_k, bs_c=feats.bs_c,
            ).total
        comm_s = wire * shared / (COPY_RANKS * COPY_BW)
    comm_s += plan.ticks * TICK_OVERHEAD_S

    ndev = _n_devices(mesh)
    fill = 1.0 if cand.backend == "dense" else feats.product_fill
    lc = local_stage_cost(
        feats.nb_r, feats.nb_k, feats.nb_c,
        feats.bs_r, feats.bs_k, feats.bs_c,
        fill=fill, backend=cand.backend,
        dtype=dtype, tile=cand.tile,
        capacity=cand.stack_capacity,
    )
    # the device does the work of every rank placed on it
    compute_s = lc.effective * shared / ndev / PEAK_FLOPS
    if cand.backend != "dense" and shared == 1:
        imb = imbalance if imbalance is not None else feats.imbalance
        compute_s *= max(float(imb), 1.0)

    mem = commvolume.device_memory_bytes(
        plan, feats.nb_r, feats.bs_r, itemsize=itemsize,
        stack_capacity=cand.stack_capacity or 0,
        nb_k=feats.nb_k, nb_c=feats.nb_c,
        bs_k=feats.bs_k, bs_c=feats.bs_c,
    )
    feasible = mem <= budget and lc.feasible
    if feasible:
        reason = ""
    elif not lc.feasible:
        reason = (
            f"group {cand.tile or 'default'} working set exceeds the "
            f"kernel's staging budget for blocks "
            f"{feats.bs_r}x{feats.bs_k}x{feats.bs_c} ({feats.dtype})"
        )
    else:
        reason = (
            f"memory {mem / 1e9:.2f} GB exceeds budget {budget / 1e9:.2f} GB "
            f"(Eq. 6, L={plan.topo.l})"
        )
    return Estimate(
        candidate=cand, comm_s=comm_s, compute_s=compute_s,
        mem_bytes=mem, feasible=feasible, reason=reason,
    )


def assignment_imbalances(counts, mesh, modes=None) -> dict[str, float]:
    """Exact per-mesh max/mean product-load factor of every assignment
    mode (identity included)."""
    from repro_torch.core.commvolume import load_imbalance

    p_r, p_c = int(mesh.shape["r"]), int(mesh.shape["c"])
    out: dict[str, float] = {}
    for mode, asg in assignment_space(counts, mesh, assigns=modes).items():
        perm = None if asg is None else asg.perm
        out[mode] = load_imbalance(counts, p_r, p_c, perm=perm) \
            if counts is not None else 1.0
    return out


def rank_candidates(
    mesh,
    feats: PairFeatures,
    *,
    ok=None,
    counts=None,
    engines: tuple[str, ...] | None = None,
    backends: tuple[str, ...] | None = None,
    l: int | None = None,
    transports: tuple[str, ...] | None = None,
    assigns: tuple[str, ...] | None = None,
    budget_bytes: float | None = None,
    top_k: int | None = None,
    device=None,
) -> ModelReport:
    """Enumerate -> estimate -> prune -> rank.  Raises ``ValueError`` when
    no candidate fits the per-rank memory budget: the tuner refuses rather
    than over-commit device memory.  With ``counts`` each candidate is
    priced at its own assignment's exact per-mesh load imbalance."""
    import time

    t0 = time.perf_counter()
    cands = enumerate_candidates(
        mesh, feats, ok=ok, counts=counts, engines=engines,
        backends=backends, l=l, transports=transports, assigns=assigns,
        device=device,
    )
    if not cands:
        raise ValueError(
            f"no engine candidate fits mesh {mesh_signature(mesh)} and "
            f"block grid {feats.nb_r}x{feats.nb_c}"
        )
    imbs = assignment_imbalances(counts, mesh, modes=assigns) \
        if counts is not None and ranks_per_device(mesh) == 1 else {}
    ests = [
        estimate_candidate(c, mesh, feats, budget_bytes=budget_bytes,
                           imbalance=imbs.get(c.assign))
        for c in cands
    ]
    feasible = sorted((e for e in ests if e.feasible), key=lambda e: e.total_s)
    pruned = tuple(e for e in ests if not e.feasible)
    if not feasible:
        raise ValueError(
            "every candidate exceeds the per-device memory budget: "
            + "; ".join(f"{e.candidate.label}: {e.reason}" for e in pruned)
        )
    if top_k is not None:
        feasible = feasible[:top_k]
    return ModelReport(ranked=tuple(feasible), pruned=pruned,
                       n_candidates=len(cands),
                       host_s=time.perf_counter() - t0)


def choose_local_backend(
    ni: int, nk: int, nj: int,
    bs_r: int, bs_k: int, bs_c: int,
    fill: float,
    *,
    device=None,
) -> str:
    """Dense-vs-compacted local backend from the analytic cost model
    (``local_mm.backend_local_cost``): ``"dense"``, or the compacted
    flavour ``device`` runs (``"cuda"`` on a card, ``"stacks"``
    elsewhere)."""
    dense = backend_local_cost(ni, nk, nj, bs_r, bs_k, bs_c,
                               fill=1.0, backend="dense")
    compact = backend_local_cost(ni, nk, nj, bs_r, bs_k, bs_c,
                                 fill=fill, backend="stacks")
    if dense <= compact:
        return "dense"
    return default_backends(device)[1]


def chain_safe(cand: Candidate, *, envelope: bool = False) -> bool:
    """Whether a candidate is sound for a fused iteration chain, whose
    pattern evolves under one sweep program: without an envelope only the
    dense stage with dense panels (a capacity from the first pattern could
    drop fill-in products or panels); under an envelope every candidate
    (its capacities cover every sweep)."""
    if envelope:
        return True
    return cand.backend == "dense" and cand.transport == "dense"
