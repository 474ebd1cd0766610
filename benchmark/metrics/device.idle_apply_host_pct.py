"""Share of the traced stretch of whole cycles in which the device runs
nothing while one of the apply's host steps is open on any thread (the
port's ``apply.read``, ``apply.stage``, ``apply.wait_plane`` and
``apply.write`` spans), in percent.  The spans go onto the profiler's
timeline by the cycles' clock offset (``program_trace``); the device's
idle time is the complement of the union of its operations."""

from benchmark import program_trace, trace

HOST_STEPS = ("apply.read", "apply.stage", "apply.wait_plane", "apply.write")


def read(t):
    found = program_trace.on_timeline(t, program_trace.spans(t, *HOST_STEPS))
    if not found:
        return None
    lo, hi = trace.stretch(t.marks)
    if hi <= lo:
        return None
    host = trace.union(found, lo, hi)
    return 100.0 * program_trace.overlap_ns(program_trace.idle(t.ops, lo, hi), host) / (hi - lo)
