"""block_spgemm's share of its roofline in the traced window: the least
time for the products the inputs need over the kernel's device time."""
from perfbench.readers import SPGEMM, roofline


def read(rec):
    return roofline(rec, "block_spgemm", SPGEMM)
