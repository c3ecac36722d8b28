"""Decode tokens of the window over its wall time."""


def read(rec):
    if not rec.get("tokens"):
        return None
    return rec["tokens"] / rec["window_s"]
