"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

For each seed, in one process, two runs of the cell through the harness
with no window beyond its one judged cycle (``harness.run`` with
``seconds=0``: the inputs, the warm-up cycle, one cycle, the check): the
program's (the lower readings, from sound runs), then the control's, the
reference one precision below the configuration's (``check.precision``
with ``control``) put in the program's place by :class:`Control` (the
upper readings; the control has to come out not correct).  One JSON line a
seed.  The benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmark import check  # noqa: E402
from benchmark.port_entry import Cycles  # noqa: E402


class Control(Cycles):
    """The reference at the control's precision in the program's place,
    chained as the program chains: each cycle registers against the
    control's own warp of the cycle before."""

    def __init__(self, config, ref_cycle, device, ref_channel=0):
        super().__init__(config, ref_cycle, device, ref_channel)
        self.config, self.ref_cycle = config, ref_cycle
        self.prec = check.precision(config, control=True)
        self.ref_img = check.project(ref_cycle, ref_channel, self.device)  # the chain's start

    def run(self, planes, affine_out, flow_out, span=None):
        prev = {k: self.last[k] for k in ("flow", "tmat") if k in self.last}
        out = check.in_place_of_program(self.config, self.ref_cycle, planes, self.ref_img, self.device, self.prec,
                                        self.ref_channel)
        if affine_out is not None:
            np.copyto(affine_out, out.pop("affine_out"))
        np.copyto(flow_out, out.pop("flow_out"))
        self.last = dict(out, prev=prev)
        self.ref_img = out["warped"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = parser.parse_args(argv)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"seed": seed}
        for side, cls in (("program", None), ("control", Control)):
            t0 = time.perf_counter()
            result = harness.run(ROOT, args.workload, seed, 0.0, False, "cuda:0", t0, cycles_cls=cls)
            line[side] = {"correct": result["correct"], "seconds": time.perf_counter() - t0,
                          **{name: c["value"] for name, c in result["checks"].items()}}
        line["limits"] = {name: c["limit"] for name, c in result["checks"].items()}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
