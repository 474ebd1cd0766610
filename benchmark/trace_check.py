"""Check a traced run of one cell against the port's own spans, on the card.

    python3 benchmark/trace_check.py --workload <cell> --seed <n> --seconds <s> [--out FILE]

from the root of a checkout.  Runs the cell once with ``--trace 1``'s
settings and prints, as one JSON object (also written to ``--out``):

* ``metrics``: the result line's per-layer metrics;
* ``idle_covered_pct``: the share of the device's idle time in the traced
  stretch that falls inside some program span, on any thread;
* ``clock_error_us``: the largest distance of a cycle mark from its
  benchmark span under the fitted clock map (``clock_error_median_us``:
  under the median offset alone; ``clock_rate_ppm``: the fitted drift;
  ``clock_residuals_us``: each cycle's start and end off the map), and
  ``span_outside_mark_us``: the most any program span lies outside its
  cycle's mark on the profiler's clock;
* ``match_device_over_match_s``: the ``features.match`` spans' device
  seconds over the synchronised ``[profile] ... match`` lines' seconds;
* ``annotation_ops``: device operations of the timeline that carry a
  program span's name (a profiler that lists its ranges as operations);
* the split of the idle time by span name, of the register by stage, the
  knn's counts, the spans and timing events a cycle, and the traced cycle
  walls.

Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
MATCH_LINE = re.compile(r"^\[profile\] feature lvl\d+ match: ([0-9.]+)s$", re.M)


def _report(t) -> dict:
    from benchmark import program_trace as pt
    from benchmark import trace

    lo, hi = trace.stretch(t.marks)
    window = pt.window_ns(t)
    mine = pt.spans(t)
    to = pt.clock_map(t)
    pairs = pt.clock_pairs(t)
    off = statistics.median(m - h for h, m in pairs[::2])
    idle = pt.idle(t.ops, lo, hi)
    idle_ns = sum(e - s for s, e in idle)
    covered = pt.overlap_ns(idle, trace.union(pt.on_timeline(t, mine), lo, hi))
    by_name = defaultdict(list)
    for s in mine:
        by_name[s.name].append(s)
    idle_by = {n: pt.overlap_ns(idle, trace.union(pt.on_timeline(t, ss), lo, hi)) / 1e9 / t.cycles
               for n, ss in by_name.items()}
    cycles = sorted((round(s * 1e9), round(e * 1e9)) for n, s, e in t.spans.spans if n == "cycle")
    marks = sorted((s, e) for n, s, e in t.marks if n == "cycle")
    outside = 0
    for s in mine:
        k = max(i for i, (c0, _) in enumerate(cycles) if c0 <= s.t0_ns)
        outside = max(outside, marks[k][0] - to(s.t0_ns), to(s.t1_ns) - marks[k][1])
    match_dev = pt.device_total_s(by_name.get("features.match"))
    match_s = sum(float(x) for x in MATCH_LINE.findall(t.log))
    knn = pt.counters(t, "features.knn")
    return {
        "window_ns": window, "cycles": t.cycles, "stretch_s": (hi - lo) / 1e9, "idle_s": idle_ns / 1e9,
        "idle_covered_pct": 100.0 * covered / idle_ns if idle_ns else None,
        "clock_error_us": pt.clock_error_ns(t) / 1e3,
        "clock_error_median_us": max(abs(m - h - off) for h, m in pairs) / 1e3,
        "clock_residuals_us": [round((m - to(h)) / 1e3, 1) for h, m in pairs],
        "clock_rate_ppm": 1e6 * ((to(pairs[-1][0]) - to(pairs[0][0])) / (pairs[-1][0] - pairs[0][0]) - 1),
        "span_outside_mark_us": max(0, outside) / 1e3,
        "match_device_s": match_dev, "match_s": match_s,
        "match_device_over_match_s": match_dev / match_s if match_dev and match_s else None,
        "annotation_ops": sum(1 for n, _, _ in t.ops if n in by_name),
        "idle_s_a_cycle_inside": dict(sorted(idle_by.items(), key=lambda kv: -kv[1])),
        "host_s_a_cycle": {n: sum(s.t1_ns - s.t0_ns for s in ss) / 1e9 / t.cycles for n, ss in by_name.items()},
        "device_s_a_cycle": {n: pt.device_total_s(ss) / t.cycles for n, ss in by_name.items()
                             if all(s.events is not None for s in ss)},
        "spans_a_cycle": len(mine) / t.cycles,
        "events_a_cycle": 2 * sum(1 for s in mine if s.events is not None) / t.cycles,
        "knn": {"calls_a_cycle": len(knn) / t.cycles,
                "rows": [[int(c.values["query_valid"]), int(c.values["train_valid"]), int(c.values["ties"]),
                          c.values["dtype"]] for c in knn[:9]]},
        "cycle_walls_s": [(e - s) / 1e9 for s, e in cycles],
        "cycle_wall_median_s": statistics.median((e - s) / 1e9 for s, e in cycles),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("the check reads the card's timeline: no CUDA device is visible", file=sys.stderr)
        return 2
    seen = {}
    read_metric = harness.read_metric

    def keep(name, t):
        seen["t"] = t
        return read_metric(name, t)

    harness.read_metric = keep
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, True, "cuda:0", T_START)
    report = {"workload": args.workload, "seed": args.seed, "correct": result["correct"],
              "metrics": {k: v["value"] for k, v in result["metrics"].items()}, **_report(seen["t"])}
    text = json.dumps(report)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
