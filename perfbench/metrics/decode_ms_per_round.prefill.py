"""Wall ms of the engine's decode steps per traced round: the program's
``repro.serve.decode`` spans (the step's model call, sample and readback)
over the rounds of the traced window.  A 1-token round runs one such step
after its prefill, and no request keeps its token."""
from perfbench import spans


def read(rec):
    row = spans.span_row(rec, "repro.serve.decode")
    tr = rec.get("trace")
    if row is None or not tr["steps"]:
        return None
    return 1e3 * row["s"] / tr["steps"]
