"""Milliseconds a projected page in the z-max projections (the port's
``pages.project`` spans in ``utils/pages.py::max_project_u8``, host clock):
the window's projections' wall over the ``pages.copy`` spans inside them,
one a page copied to the device; nothing where the port records no
``pages.copy`` span."""

from benchmark import program_trace


def read(t):
    found = program_trace.spans(t, "pages.project", "pages.copy")
    projections = {s.id: s for s in found if s.name == "pages.project"}
    pages = sum(1 for s in found if s.name == "pages.copy" and s.parent in projections)
    if not pages:
        return None
    return sum(s.t1_ns - s.t0_ns for s in projections.values()) / 1e6 / pages
