"""Device seconds a cycle in OptFlowReg's NMI gate (its three 41-tap DoGs
and both scores): the interval between the timing events of the port's
``optflow.gate`` spans, summed over the window and divided by its
cycles."""

from benchmark import program_trace


def read(t):
    secs = program_trace.device_total_s(program_trace.spans(t, "optflow.gate"))
    return secs / t.cycles if secs is not None else None
