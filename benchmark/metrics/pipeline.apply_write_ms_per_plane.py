"""Milliseconds a plane that the apply's writer thread spends waiting for
the device-to-host copy and handing the plane to ``write_fn`` (the port's
``apply.write`` spans in ``pipeline/apply.py``, host clock), mean over the
window's spans."""

from benchmark import program_trace


def read(t):
    found = program_trace.spans(t, "apply.write")
    return sum(s.t1_ns - s.t0_ns for s in found) / 1e6 / len(found) if found else None
