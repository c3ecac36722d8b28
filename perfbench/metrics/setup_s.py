"""Set-up seconds: process start until the window opens."""


def read(rec):
    return rec.get("setup_s")
