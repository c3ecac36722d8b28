"""Device ms of the MoE glue per decode step: the operations put down to
the program's ``repro.moe.route``, ``repro.moe.dispatch`` and
``repro.moe.combine`` spans (router, dispatch mask, product and group
lists, the weighted gather) over the traced steps; the expert products are
not in it."""
from perfbench import spans
from perfbench.readers import per_step


def read(rec):
    s = spans.device_s(rec, ("repro.moe.route", "repro.moe.dispatch",
                             "repro.moe.combine"))
    return None if s is None else per_step(rec, 1e3 * s)
