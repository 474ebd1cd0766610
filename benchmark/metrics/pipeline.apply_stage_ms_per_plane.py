"""Milliseconds a plane that the apply's reader thread spends staging a
plane: a free pinned slot, the pageable-to-pinned host copy and issuing
the host-to-device copy (the port's ``apply.stage`` spans in
``pipeline/apply.py``, host clock), mean over the window's spans."""

from benchmark import program_trace


def read(t):
    found = program_trace.spans(t, "apply.stage")
    return sum(s.t1_ns - s.t0_ns for s in found) / 1e6 / len(found) if found else None
