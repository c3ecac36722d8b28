"""Three-term roofline of one traced step — the twin of
``repro/roofline/__init__.py``.

The reference derives its terms from the compiled SPMD module of a TPU
v5e target.  The port's come from a trace of the step's aten ops
(``roofline/hlo_cost.py``) on the dry run's abstract ranks, for the H100:

    compute term     = FLOPs per device / PEAK_FLOPS
    memory term      = HBM bytes per device / HBM_BW
    collective term  = collective wire bytes per device / NVLINK_BW

where a per-device count is the trace's total over the ranks divided by
the mesh's size (the ranks do equal work: every shape is static, an MoE
capacity buffer's too) and the wire
bytes are ``core/transport``'s bytes per destination rank.  The
constants are the H100 SXM's data-sheet values, not measurements: 989e12
FLOP/s (bf16 dense, tensor cores), 3.35e12 bytes/s of HBM3, and NVLink's
450e9 bytes/s per direction per GPU (in place of the reference's one ICI
link).  No TPU constant is carried over.

The trace already sees the flash kernels as ops whose inputs and outputs
are their HBM traffic (Q, K, V, O, lse), so the reference's
kernel-adjusted memory term equals the raw one here
(``memory_s_kernel == memory_s``, ``attn_tile_bytes`` 0).  The dry
run's record carries the reference's analytic flash traffic
(``launch/dryrun.py::_flash_kernel_bytes``) beside the traced bytes of
the flash ops, per device, to compare them.

The reference's HLO parsers, ``shape_bytes`` and ``parse_collectives``,
have no counterpart: there is no HLO text.  ``CollectiveStats`` keeps the
fields the transport's counts by kind fill (the reference's
``payload_bytes`` and ``add`` serve its HLO parser only).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.roofline.hlo_cost import (  # noqa: F401
    CostReport,
    spgemm_dense_flops,
    spgemm_stacks_flops,
)

# --- H100 SXM data-sheet constants -------------------------------------------
PEAK_FLOPS = 989e12  # bf16 dense FLOP/s per GPU (tensor cores)
HBM_BW = 3.35e12  # bytes/s per GPU
NVLINK_BW = 450e9  # bytes/s per direction per GPU
HBM_BYTES = 80 * 2**30  # device memory per GPU


@dataclass
class CollectiveStats:
    """Per-device collective traffic of one traced step."""

    by_kind_bytes: dict[str, float] = field(default_factory=dict)
    by_kind_count: dict[str, int] = field(default_factory=dict)
    wire_bytes: float = 0.0  # bytes on the wire, per device


@dataclass
class RooflineReport:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_total: float
    useful_flops_ratio: float  # MODEL_FLOPS / (per-device flops * chips)
    collectives: CollectiveStats
    memory: dict[str, float]
    top_collectives: list = field(default_factory=list)
    top_memory: list = field(default_factory=list)
    top_flops: list = field(default_factory=list)
    # the reference's kernel-adjusted memory term: the trace already holds
    # the flash kernels' traffic, so analyze sets memory_s and 0
    memory_s_kernel: float = 0.0
    attn_tile_bytes: float = 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute_s / max(all terms): 1.0 means compute-bound at the roof
        if the terms overlap perfectly."""
        b = self.bound_s
        return self.compute_s / b if b > 0 else 0.0

    def to_json(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_total": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_by_kind_bytes": self.collectives.by_kind_bytes,
            "collective_by_kind_count": self.collectives.by_kind_count,
            "memory": self.memory,
            "top_collectives": [[b, d] for b, d in self.top_collectives[:8]],
            "top_memory": [[b, d] for b, d in self.top_memory[:8]],
            "top_flops": [[b, d] for b, d in self.top_flops[:8]],
            "memory_s_kernel": self.memory_s_kernel,
            "attn_tile_bytes": self.attn_tile_bytes,
        }


def analyze(
    cost: CostReport,
    *,
    n_chips: int,
    model_flops_total: float,
    peak_flops: float = PEAK_FLOPS,
    hbm_bw: float = HBM_BW,
    nvlink_bw: float = NVLINK_BW,
) -> RooflineReport:
    """Roofline terms from one traced step (``hlo_cost.trace``, or
    ``hlo_cost.extrapolate`` of two) on a mesh of ``n_chips`` ranks."""
    flops = cost.flops / n_chips
    hbm_bytes = cost.hbm_bytes / n_chips
    stats = CollectiveStats(
        by_kind_bytes=dict(cost.by_kind_bytes),
        by_kind_count={k: int(round(v)) for k, v in
                       cost.by_kind_count.items()},
        wire_bytes=cost.collective_wire_bytes,
    )
    memory = {
        "argument_bytes": cost.argument_bytes,
        "output_bytes": cost.output_bytes,
        "temp_bytes": cost.peak_bytes - cost.argument_bytes,
        "alias_bytes": cost.alias_bytes,
        "peak_bytes": cost.peak_bytes,
    }
    compute_s = flops / peak_flops
    memory_s = hbm_bytes / hbm_bw
    collective_s = stats.wire_bytes / nvlink_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total = flops * n_chips
    return RooflineReport(
        flops_per_device=flops,
        hbm_bytes_per_device=hbm_bytes,
        collective_bytes_per_device=stats.wire_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops_total=model_flops_total,
        useful_flops_ratio=model_flops_total / total if total else 0.0,
        collectives=stats,
        memory=memory,
        top_collectives=sorted(([b, k] for k, b in
                                stats.by_kind_bytes.items()), reverse=True),
        top_memory=[[v / n_chips, d] for v, d in cost.top("top_memory")],
        top_flops=[[v / n_chips, d] for v, d in cost.top("top_flops")],
        memory_s_kernel=memory_s,
    )


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6 N D (train), 2 N D (prefill), 2 N_active B (decode)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: 1 token / sequence
