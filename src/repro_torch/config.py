"""Runtime configuration of the PyTorch port.

Two settings: the block-storage dtype of the dtype-matrixed test runs
(``REPRO_STORAGE_DTYPE``, as in the JAX package) and the device an entry
point runs on.  The JAX package's ``pallas_interpret()`` has no twin: a
kernel wrapper picks its plain version or its CUDA kernel from the device
of the tensors it is given.
"""
from __future__ import annotations

import os

import torch


def storage_dtype() -> str:
    """Configured block-storage dtype for dtype-matrixed test/CI runs.

    ``REPRO_STORAGE_DTYPE`` selects the reduced-precision storage leg of
    the CI matrix: "float32" (default) keeps the exact path, "bfloat16"
    runs the mixed-precision path (bf16 blocks, f32 accumulation).  Read by
    the dtype-matrixed end-to-end tests; library code never consults it
    (storage dtype is an explicit argument: ``bsm.cast_bsm`` /
    ``sign_iteration(storage_dtype=...)``).
    """
    raw = os.environ.get("REPRO_STORAGE_DTYPE", "float32").strip().lower()
    if raw in ("", "f32", "float32"):
        return "float32"
    if raw in ("bf16", "bfloat16"):
        return "bfloat16"
    raise ValueError(
        f"REPRO_STORAGE_DTYPE={raw!r}: expected float32 | bfloat16"
    )


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and no
    CUDA device is present — an entry point never moves to the CPU on its
    own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev
