"""The model's FLOPs of the traced window's tokens over its wall time, as %
of the bf16 peak."""
from perfbench.readers import mfu as read  # noqa: F401
