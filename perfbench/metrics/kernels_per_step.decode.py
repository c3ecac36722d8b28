"""Kernels on the device per decode step of the traced window."""
from perfbench.readers import per_step


def read(rec):
    tr = rec.get("trace")
    return None if tr is None else per_step(rec, tr["n_kernels"])
