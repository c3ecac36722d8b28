"""Time to first token, the mean over every request of the window."""


def read(rec):
    t = rec.get("ttft_s")
    return sum(t) / len(t) if t else None
