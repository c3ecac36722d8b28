"""The 90th percentile of the gap between output tokens, over every decode
step of the window (each step gives every session one token)."""
import numpy as np


def read(rec):
    gaps = rec.get("itl_s")
    if not gaps:
        return None
    return 1e3 * float(np.percentile(np.asarray(gaps), 90))
