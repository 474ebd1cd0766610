"""Milliseconds a plane that the apply's writer thread spends on the
device-to-host copy of the warped plane and the wait for it, before
``write_fn`` (the port's ``apply.fetch`` spans inside ``apply.write`` in
``pipeline/apply.py``, host clock), mean over the window's spans; nothing
where the port records no such span."""

from benchmark import program_trace


def read(t):
    found = program_trace.spans(t, "apply.fetch")
    return sum(s.t1_ns - s.t0_ns for s in found) / 1e6 / len(found) if found else None
