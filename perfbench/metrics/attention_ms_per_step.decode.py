"""Device ms of attention per decode step: the operations put down to the
program's ``repro.attention`` spans (scores over the cache, softmax, P.V)
over the traced steps."""
from perfbench import spans
from perfbench.readers import per_step


def read(rec):
    s = spans.device_s(rec, ("repro.attention",))
    return None if s is None else per_step(rec, 1e3 * s)
