"""The flash kernel's share of its roofline in the traced window, from the
kept causal pairs."""
from perfbench.readers import FLASH, roofline


def read(rec):
    return roofline(rec, "flash", FLASH)
