"""Run one cell of the benchmark of ``microaligner_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as the last line of
standard output (one JSON object) and each number compared against the
reference beside its limit as the last lines of standard error.  Exits with
a code other than 0, and prints no result, when no CUDA device is visible,
when the port cannot be imported, or when the JAX package or JAX was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    chips = harness.load_cell(ROOT, args.workload)[1]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{chips} CUDA device(s) needed: the benchmark runs on the card and does not fall back to the CPU",
              file=sys.stderr)
        return 2

    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
