"""Share of the traced stretch of whole cycles (the first cycle mark's
start to the last one's end) in which no operation runs on the device, in
percent, from the union of the device's operation intervals."""

from benchmark import trace


def read(t):
    lo, hi = trace.stretch(t.marks)
    if hi <= lo:
        return None
    return 100.0 * (1.0 - trace.busy_ns(t.ops, lo, hi) / (hi - lo))
