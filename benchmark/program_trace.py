"""The port's own spans and counters in a traced run.

Under ``MICROALIGNER_TPU_PROFILE``, which the traced run sets for its window
alone, the port records spans and counters in process
(``microaligner_tpu_torch.utils.logging``: ``spans()``, ``counters()``,
``device_s()``), on ``time.perf_counter_ns``, the clock of the benchmark's
``trace.Spans``.  The readers keep only what lies inside the window: from
the first benchmark ``cycle`` span's start to the last one's end.  A port
that records none gives nothing: every function here then returns an empty
list or None, and a metric that reads it is left out of the result line.

The profiler's timeline (``t.ops``, ``t.marks``) runs on another clock.  A
program span goes onto it by the line that best maps the benchmark's
``cycle`` spans onto their marks, starts and ends (``clock_map``).
"""

from __future__ import annotations

import statistics

from benchmark import trace


def _port():
    """The port's tracing module, or None where it records no spans."""
    try:
        from microaligner_tpu_torch.utils import logging as plog
    except ImportError:
        return None
    return plog if hasattr(plog, "spans") and hasattr(plog, "counters") else None


def _cycles_s(t) -> list:
    return sorted((s, e) for n, s, e in t.spans.spans if n == "cycle")


def window_ns(t) -> tuple[int, int] | None:
    """(first cycle span's start, last one's end) on ``perf_counter_ns``."""
    cycles = _cycles_s(t)
    if not cycles:
        return None
    return round(cycles[0][0] * 1e9), round(max(e for _, e in cycles) * 1e9)


def spans(t, *names) -> list:
    """The port's closed spans named ``names`` (every name when none is
    given) inside the window."""
    port, window = _port(), window_ns(t)
    if port is None or window is None:
        return []
    lo, hi = window
    return [s for s in port.spans()
            if (not names or s.name in names) and s.t1_ns is not None and lo <= s.t0_ns and s.t1_ns <= hi]


def counters(t, name: str) -> list:
    """The port's counters named ``name`` taken inside the window."""
    port, window = _port(), window_ns(t)
    if port is None or window is None:
        return []
    lo, hi = window
    return [c for c in port.counters() if c.name == name and lo <= c.t_ns <= hi]


def device_total_s(entries) -> float | None:
    """Device seconds between the timing events of ``entries``, summed;
    None where there are none or one of them has no events."""
    port = _port()
    if port is None or not entries:
        return None
    secs = [port.device_s(s) for s in entries]
    return None if any(x is None for x in secs) else sum(secs)


def clock_pairs(t) -> list:
    """(``perf_counter_ns``, profiler ns) of the start and the end of each
    window cycle: its benchmark span against its mark."""
    marks = sorted((s, e) for n, s, e in t.marks if n == "cycle")
    cycles = _cycles_s(t)
    if not marks or len(marks) != len(cycles):
        return []
    return [(round(h * 1e9), m) for (s, e), (m0, m1) in zip(cycles, marks) for h, m in ((s, m0), (e, m1))]


def clock_map(t):
    """The map from ``perf_counter_ns`` to the profiler's clock: the least
    squares line through :func:`clock_pairs` (the two clocks drift apart by
    some parts in a million over a window), or None without cycles."""
    pairs = clock_pairs(t)
    if not pairs:
        return None
    x0, y0 = pairs[0]
    xs = [x - x0 for x, _ in pairs]
    ys = [y - y0 for _, y in pairs]
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    var = sum((x - mx) ** 2 for x in xs)
    rate = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / var if var else 1.0
    return lambda ns: y0 + round(my + rate * (ns - x0 - mx))


def clock_error_ns(t) -> int | None:
    """The largest distance of a cycle mark's start or end from its span's
    under :func:`clock_map`."""
    to = clock_map(t)
    return None if to is None else max(abs(m - to(h)) for h, m in clock_pairs(t))


def on_timeline(t, entries) -> list:
    """``(start, end)`` of each span on the profiler's clock."""
    to = clock_map(t)
    return [] if to is None else [(to(s.t0_ns), to(s.t1_ns)) for s in entries]


def idle(ops, lo: int, hi: int) -> list:
    """The intervals of ``[lo, hi)`` in which the device runs nothing."""
    out, prev = [], lo
    for s, e in trace.union(((s, e) for _, s, e in ops), lo, hi):
        if s > prev:
            out.append((prev, s))
        prev = e
    if hi > prev:
        out.append((prev, hi))
    return out


def overlap_ns(a, b) -> int:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total
