"""Seconds per converged density matrix: the window's wall time over the
purifications completed in it."""


def read(rec):
    n = rec.get("purifications")
    return rec["window_s"] / n if n else None
