"""Sign-iteration sweeps per purification (the window's mean)."""


def read(rec):
    return rec.get("sweeps")
