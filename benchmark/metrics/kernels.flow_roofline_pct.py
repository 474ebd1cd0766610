"""Share of the Farneback register's least time in the device's busy time
inside the register spans, in percent.  The least time is the kernels'
work of one register at its shapes, its fixed levels and iterations and
its configuration's Farneback precision (``roofline.register_least_s``,
from shapes, never from launches); the busy
time is the union of the device's operation intervals inside the
``optflow.register`` marks on the profiler's timeline."""

from benchmark import roofline, trace


def read(t):
    spans = [(s, e) for n, s, e in t.marks if n == "optflow.register"]
    busy = sum(trace.busy_ns(t.ops, s, e) for s, e in spans)
    if not spans or busy <= 0:
        return None
    least = roofline.register_least_s(t.config["plane"], t.config["OptFlowReg"],
                                      t.config["precision"]["flow"]) * len(spans)
    return 100.0 * least / (busy / 1e9)
