"""Milliseconds a plane in the applies (``stream_apply`` with the runner's
per-plane warps): the benchmark's synchronised spans around every apply of
the window, over the planes they applied."""


def read(t):
    n = t.planes_applied
    return 1e3 * t.spans.total("pipeline.apply") / n if n else None
