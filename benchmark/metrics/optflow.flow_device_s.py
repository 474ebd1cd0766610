"""Device seconds a cycle in OptFlowReg's Farneback flow with its post-warp:
the interval between the timing events (CUDA events on the stream that
runs the work) of the port's ``optflow.flow`` spans, summed over the
window and divided by its cycles."""

from benchmark import program_trace


def read(t):
    secs = program_trace.device_total_s(program_trace.spans(t, "optflow.flow"))
    return secs / t.cycles if secs is not None else None
