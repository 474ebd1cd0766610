"""Lightweight logging, stage timing and tracing.

The reference's only observability is ~30 bare prints (SURVEY §5).  This
module keeps those exact lines (tests and users rely on them) but routes them
through a leveled logger, and adds opt-in stage timers and spans:

* ``MICROALIGNER_TPU_LOG=quiet|info|debug``  — default info (print parity)
* ``MICROALIGNER_TPU_PROFILE=1``             — stage lines, spans, counters

Both variables are the JAX package's, so one setting drives either package.

Under ``MICROALIGNER_TPU_PROFILE`` every :func:`span` is recorded in a
bounded in-memory buffer, read in process with :func:`spans` (a snapshot
that does not consume it): its id, its parent (the innermost span open on
the same thread, or the ``parent`` handed to a worker thread), its root
(shared by every span under one top-level call), its name and attributes,
its thread, and its start and end on ``time.perf_counter_ns``.  A span is
also a ``torch.profiler.record_function`` range, so a profiler trace shows
the stages beside the kernels, and with a CUDA ``device`` it records a pair
of timing events on the thread's current stream; :func:`device_s` reads
their interval when asked, after the work.  A span never synchronises.
:func:`counter` records named values at the same boundaries, read with
:func:`counters`.  With the variable unset a span is one flag check, and
so is a counter's call site.

``stage_timer`` is a span that also prints ``[profile] <label>: <s>s``.
PyTorch returns before the device finishes, so a stage timer synchronises
its device at both ends: its line is the stage's wall time, device work
included.
"""

from __future__ import annotations

import collections
import itertools
import os
import sys
import threading
import time

__all__ = ["log", "debug", "stage_timer", "profiling_enabled", "span", "current_span", "spans", "device_s",
           "counter", "counters"]

_LEVELS = {"quiet": 0, "info": 1, "debug": 2}
_CAPACITY = 1 << 16  # records kept of each kind; the oldest go first


def _level() -> int:
    return _LEVELS.get(os.environ.get("MICROALIGNER_TPU_LOG", "info"), 1)


def profiling_enabled() -> bool:
    return os.environ.get("MICROALIGNER_TPU_PROFILE", "") not in ("", "0")


def log(*args):
    if _level() >= 1:
        print(*args)
        sys.stdout.flush()


def debug(*args):
    if _level() >= 2:
        print(*args)
        sys.stdout.flush()


_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_spans: collections.deque = collections.deque(maxlen=_CAPACITY)
_counters: collections.deque = collections.deque(maxlen=_CAPACITY)

Counter = collections.namedtuple("Counter", "name values span root thread t_ns")


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """What :func:`span` and :func:`stage_timer` return when profiling is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class Span:
    """One span: open while its ``with`` block runs, then a record of
    :func:`spans`.  ``t1_ns`` is None while it is open."""

    __slots__ = ("id", "parent", "root", "name", "attrs", "thread", "t0_ns", "t1_ns", "events",
                 "_device", "_label", "_range")

    def __init__(self, name: str, device, parent, attrs: dict, label: str | None = None):
        self.name, self.attrs, self._device, self._label = name, attrs, device, label
        self.parent = parent
        self.events = self._range = None
        self.t1_ns = None

    def set(self, **attrs) -> None:
        """Add attributes known only inside the block."""
        self.attrs.update(attrs)

    def _sync(self) -> None:
        import torch

        if self._device is not None:
            torch.cuda.synchronize(self._device)

    def __enter__(self):
        import torch

        stack = _stack()
        parent = stack[-1] if stack else self.parent
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        self.thread = threading.current_thread().name
        if self._device is not None:
            if torch.device(self._device).type == "cuda":
                self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            else:
                self._device = None
        if self._label is not None:
            self._sync()
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.t0_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[0].record(torch.cuda.current_stream(self._device))
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch

        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self._device))
        if self._label is not None and exc_type is None:
            self._sync()
        self.t1_ns = time.perf_counter_ns()
        self._range.__exit__(exc_type, exc, tb)
        self._range = None
        _stack().pop()
        with _lock:
            _spans.append(self)
        if self._label is not None and exc_type is None:
            print(f"[profile] {self._label}: {(self.t1_ns - self.t0_ns) / 1e9:.3f}s")
            sys.stdout.flush()
        return False


def span(name: str, device=None, *, parent: Span | None = None, **attrs):
    """A traced span around a ``with`` block when profiling is on (see the
    module docstring); ``device`` takes timing events where it is a CUDA
    device.  ``parent`` is the span a block on a worker thread belongs to,
    taken with :func:`current_span` where the thread is started; a span open
    on the block's own thread comes first."""
    if not profiling_enabled():
        return _OFF
    return Span(name, device, parent, attrs)


def stage_timer(label: str, device=None, *, name: str, **attrs):
    """Wall-clock a pipeline stage when MICROALIGNER_TPU_PROFILE is set: a
    :func:`span` ``name`` that prints ``[profile] <label>: <s>s`` and, with
    a CUDA ``device``, waits for its queued work at both ends."""
    if not profiling_enabled():
        return _OFF
    return Span(name, device, None, attrs, label)


def current_span() -> Span | None:
    """The innermost span open on this thread (None when there is none or
    profiling is off)."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def spans() -> list:
    """The recorded spans in the order they ended (a copy; the buffer
    keeps them)."""
    with _lock:
        return list(_spans)


def device_s(entry: Span) -> float | None:
    """Device seconds between a span's timing events (waits for its end
    event); None for a span without them."""
    if entry.events is None:
        return None
    entry.events[1].synchronize()
    return entry.events[0].elapsed_time(entry.events[1]) / 1e3


def counter(name: str, **values) -> None:
    """Record ``values`` under ``name``, inside the innermost open span of
    this thread.  The caller checks :func:`profiling_enabled` first, so
    that nothing is computed for it when profiling is off.  A value may be
    a device tensor: it is read when the reader reads it."""
    parent = current_span()
    rec = Counter(name, values, parent.id if parent else None, parent.root if parent else None,
                  threading.current_thread().name, time.perf_counter_ns())
    with _lock:
        _counters.append(rec)


def counters() -> list:
    """The recorded counters, oldest first (a copy)."""
    with _lock:
        return list(_counters)
