"""Device busy ms per decode step of the traced window."""
from perfbench.readers import per_step


def read(rec):
    tr = rec.get("trace")
    return None if tr is None else per_step(rec, 1e3 * tr["busy_s"])
