"""Spans and the device timeline of a traced run.

The benchmark opens a span around each call into a layer of the port
(``port_entry.Cycles.run``'s ``span`` argument).  In a traced run a span
synchronises the device at both ends, so its host-clock length is the
layer's time, and it is also a ``torch.profiler.record_function`` mark, so
the profiler's timeline places it among the device's operations.  The
device's busy time is the union of the intervals of its operations
(kernels, copies, fills) on that timeline: the apply's side streams overlap
the main stream, so a sum of durations would count time twice.
"""

from __future__ import annotations

import contextlib
import time

import torch

MARK = "bench:"  # prefix of the benchmark's marks on the profiler's timeline


class Spans:
    """Host-clock spans ``(name, start_s, end_s)`` of the traced run."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.spans: list = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(MARK + name):
            yield
            self._sync()
        self.spans.append((name, t0, time.perf_counter()))

    def total(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.spans if n == name)

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.spans if n == name)


def timeline(prof) -> tuple[list, list]:
    """(device operations, benchmark marks) of a finished profiler, each a
    list of ``(name, start_ns, end_ns)`` on the profiler's clock."""
    ops, marks = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(MARK):
            if e.device_type() == torch.autograd.DeviceType.CPU:
                marks.append((name[len(MARK):], e.start_ns(), e.end_ns()))
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            ops.append((name, e.start_ns(), e.end_ns()))
    return ops, marks


def union(intervals, lo: int, hi: int) -> list:
    """The union of ``(start, end)`` intervals clipped to ``[lo, hi)``, as
    sorted disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(ops, lo: int, hi: int) -> int:
    return sum(e - s for s, e in union(((s, e) for _, s, e in ops), lo, hi))


def stretch(marks, name: str = "cycle") -> tuple[int, int]:
    """From the first ``name`` mark's start to the last one's end."""
    spans = [(s, e) for n, s, e in marks if n == name]
    return min(s for s, _ in spans), max(e for _, e in spans)


def breakdown(ops, marks, lo: int, hi: int, top: int = 10) -> dict:
    """The device operations with the most time and the longest idle gaps,
    each gap under the innermost mark open at its start (seconds)."""
    by_name: dict = {}
    for name, s, e in ops:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            by_name[name] = by_name.get(name, 0) + d
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union(((s, e) for _, s, e in ops), lo, hi)
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]

    def open_at(t):
        inside = [(s, n) for n, s, e in marks if s <= t < e]
        return max(inside)[1] if inside else "outside any span"

    return {"device_ops": [[n, d / 1e9] for n, d in device_ops],
            "idle_gaps": [[open_at(s), (e - s) / 1e9] for s, e in gaps]}
