"""Device ms of the list build per local multiply: the operations put down
to the program's ``repro.local_mm.list_build`` spans (pair filter, product
count, compaction, group masks) over the ``repro.local_mm.multiply`` spans
of the traced window."""
from perfbench import spans


def read(rec):
    build = spans.device_s(rec, ("repro.local_mm.list_build",))
    mult = spans.span_row(rec, "repro.local_mm.multiply")
    if build is None or not mult or not mult["calls"]:
        return None
    return 1e3 * build / mult["calls"]
