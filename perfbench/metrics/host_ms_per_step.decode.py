"""Host ms per decode step: the host's own time in the program's decode
call, its span less the CUDA calls in it that wait for the device, from
the profiler's host events over the traced steps (the profiler's own
cost included)."""


def read(rec):
    tr = rec.get("trace")
    return None if tr is None else tr["host_ms_per_step"]
