"""The readers of the port's spans and counters on a made-up traced run:
benchmark cycle spans on the host clock, their marks on the profiler's
clock at a known offset and drift, device operations, and program spans and
counters in and out of the window."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness, program_trace

S = 1_000_000_000  # ns a second
OFFSET = 1_700_000_000 * S + 123_456  # profiler clock less perf_counter_ns at T0
DRIFT = 25e-6  # the profiler's clock runs 25 parts in a million fast
T0 = 100 * S  # the window's first cycle starts here on perf_counter_ns


def _profiler_ns(host_ns: int) -> int:
    return host_ns + OFFSET + round((host_ns - T0) * DRIFT)


class FakePort:
    """The port's tracing module as the readers use it."""

    def __init__(self, spans=(), counters=()):
        self._spans, self._counters = list(spans), list(counters)

    def spans(self):
        return list(self._spans)

    def counters(self):
        return list(self._counters)

    @staticmethod
    def device_s(entry):
        return entry.device


def _span(name, t0_s, t1_s, device=None, **attrs):
    return SimpleNamespace(name=name, t0_ns=T0 + round(t0_s * S), t1_ns=T0 + round(t1_s * S), device=device,
                           attrs=attrs)


def _counter(name, t_s, **values):
    return SimpleNamespace(name=name, t_ns=T0 + round(t_s * S), values=values)


def _trace(ops_s=(), jitter=(0, 0, 0)):
    """Three cycles of one second from T0; ``ops_s`` are device operations
    as (start, end) seconds from T0 on the host clock; each cycle mark lies
    its ``jitter`` (ns) off its span on the profiler's clock."""
    cycles = [(k, k + 1) for k in range(3)]
    spans = SimpleNamespace(spans=[("cycle", (T0 + a * S) / S, (T0 + b * S) / S) for a, b in cycles])
    marks = [("cycle", _profiler_ns(T0 + a * S) + j, _profiler_ns(T0 + b * S) + j) for (a, b), j in zip(cycles, jitter)]
    ops = [("op", _profiler_ns(T0 + round(a * S)), _profiler_ns(T0 + round(b * S))) for a, b in ops_s]
    return SimpleNamespace(spans=spans, marks=marks, ops=ops, cycles=len(cycles))


@pytest.fixture
def port(monkeypatch):
    def install(**kwargs):
        fake = FakePort(**kwargs)
        monkeypatch.setattr(program_trace, "_port", lambda: fake)
        return fake
    return install


def test_clock_map_and_its_error():
    t = _trace()
    assert program_trace.clock_error_ns(t) <= 1
    at = _span("apply.stage", 1.25, 2.5)
    assert program_trace.on_timeline(t, [at]) == [(pytest.approx(_profiler_ns(at.t0_ns), abs=1),
                                                   pytest.approx(_profiler_ns(at.t1_ns), abs=1))]
    jittered = _trace(jitter=(0, 10_000, -20_000))
    assert 0 < program_trace.clock_error_ns(jittered) <= 20_000


@pytest.mark.parametrize("metric,name", [("pipeline.apply_stage_ms_per_plane", "apply.stage"),
                                         ("pipeline.apply_write_ms_per_plane", "apply.write")])
def test_host_step_ms_per_plane(port, metric, name):
    port(spans=[_span(name, 0.1, 0.11), _span(name, 1.5, 1.52), _span("apply.read", 0.2, 0.9),
                _span(name, -0.6, -0.1),  # before the window: dropped
                _span(name, 2.9, 3.2)])  # ends after it: dropped
    assert harness.read_metric(metric, _trace()) == pytest.approx(15.0)


def test_idle_while_apply_host_steps_run(port):
    # busy but for two gaps, 0.5-0.6 s and 1.5-1.7 s, in a stretch of 3 s
    t = _trace([(0.0, 0.5), (0.6, 1.5), (1.7, 3.0)])
    stretch = 3.0
    port(spans=[_span("apply.write", 0.45, 0.65),  # covers the first gap
                _span("apply.warp", 1.4, 1.8),  # a device step: not a host step
                _span("optflow.register", 1.5, 1.7),
                _span("apply.stage", -0.5, -0.1)])  # outside the window
    got = harness.read_metric("device.idle_apply_host_pct", t)
    assert got == pytest.approx(100 * 0.1 / stretch)
    port(spans=[_span("apply.read", 1.45, 1.6), _span("apply.wait_plane", 1.55, 1.65),
                _span("apply.stage", 0.52, 0.54)])  # overlapping host spans count once
    assert harness.read_metric("device.idle_apply_host_pct", t) == pytest.approx(100 * 0.17 / stretch)


@pytest.mark.parametrize("metric,name", [("optflow.flow_device_s", "optflow.flow"),
                                         ("optflow.gate_device_s", "optflow.gate")])
def test_device_seconds_a_cycle(port, metric, name):
    port(spans=[_span(name, 0.1, 0.5, device=0.3), _span(name, 1.1, 1.9, device=0.6),
                _span(name, -2.0, -1.0, device=5.0), _span("optflow.dog", 0.2, 0.3, device=7.0)])
    assert harness.read_metric(metric, _trace()) == pytest.approx(0.3)
    port(spans=[_span(name, 0.1, 0.5)])  # no timing events: not measured
    assert harness.read_metric(metric, _trace()) is None


def test_knn_roofline(port):
    knn = dict(query_rows=100_000, train_rows=100_000, width=200)
    port(spans=[_span("features.match", 0.1, 0.4, device=0.25), _span("features.match", 1.1, 1.4, device=0.25),
                _span("features.match", 3.5, 3.6, device=9.0)],
         counters=[_counter("features.knn", 0.2, query_valid=90_000, train_valid=80_000, dtype="bfloat16", ties=10,
                            **knn),
                   _counter("features.knn", 1.2, query_valid=1_000, train_valid=1, dtype="float32", ties=0,
                            **knn),
                   _counter("features.knn", 3.55, query_valid=9, train_valid=9, dtype="float32", ties=0, **knn)])
    big = max(2 * 90_000 * 80_000 * 200 / 989e12 + 2 * 10 * 80_000 * 200 / 67e12,
              (170_000 * 200 * 2 + 90_000 * 9) / 3.35e12)  # operations
    small = max(2 * 1_000 * 1 * 200 / 67e12, (1_001 * 200 * 4 + 1_000 * 9) / 3.35e12)  # bytes
    assert big > (170_000 * 200 * 2 + 90_000 * 9) / 3.35e12
    assert small == (1_001 * 200 * 4 + 1_000 * 9) / 3.35e12
    got = harness.read_metric("features.knn_roofline_pct", _trace())
    assert got == pytest.approx(100 * (big + small) / 0.5)


@pytest.mark.parametrize("metric", ["pipeline.apply_stage_ms_per_plane", "pipeline.apply_write_ms_per_plane",
                                    "device.idle_apply_host_pct", "optflow.flow_device_s",
                                    "optflow.gate_device_s", "features.knn_roofline_pct"])
def test_a_port_without_spans_gives_nothing(monkeypatch, port, metric):
    t = _trace([(0.0, 3.0)])
    monkeypatch.setattr(program_trace, "_port", lambda: None)
    assert harness.read_metric(metric, t) is None
    port()  # a port that recorded nothing in the window
    assert harness.read_metric(metric, t) is None
