"""What the metric readers share: sums over the traced window's kernels by
name, roofline shares, the device's idle share, the model's share of the
peak.  Each returns None where the record has nothing to read, never 0
for a share."""
from __future__ import annotations

from perfbench import workcount as W


def kernel_seconds(rec: dict, names: tuple[str, ...]) -> float | None:
    """Device seconds of the kernels whose name contains one of ``names``
    in the traced window."""
    tr = rec.get("trace")
    if tr is None:
        return None
    s = sum(v for k, v in tr["kernel_s"].items()
            if any(n in k for n in names))
    return s or None


def roofline(rec: dict, work: str, names: tuple[str, ...]) -> float | None:
    """% of the kernels' time that the least time for their work takes."""
    wk = (rec.get("work") or {}).get(work)
    t = kernel_seconds(rec, names)
    if not wk or not t:
        return None
    return 100.0 * W.least_seconds(wk["flops"], wk["bytes"], wk["roof"]) / t


def _device_seen(rec: dict) -> bool:
    """The traced window recorded work on the device."""
    tr = rec.get("trace")
    return tr is not None and tr["busy_s"] > 0 and tr["window_s"] > 0


def idle_share(rec: dict) -> float | None:
    tr = rec.get("trace")
    if not _device_seen(rec):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(rec: dict) -> float | None:
    """% of the bf16 peak that the model FLOPs of the traced window's
    tokens, from the published widths, take over its wall time."""
    tr = rec.get("trace")
    flops = (rec.get("work") or {}).get("model_flops")
    if tr is None or not flops:
        return None
    return 100.0 * flops / tr["window_s"] / W.BF16_FLOPS


def per_step(rec: dict, value: float | None) -> float | None:
    """``value`` of the traced window per traced step (nothing where the
    window saw no device work)."""
    tr = rec.get("trace")
    if not _device_seen(rec) or value is None or not tr["steps"]:
        return None
    return value / tr["steps"]


SPGEMM = ("group_kernel",)
FLASH = ("flash_bf16_kernel", "flash_f32_kernel")
