#!/usr/bin/env python3
"""K5 alone on one NVIDIA GPU: build it, check it and time it, with the
z-stack apply around it, through ``chip_smoke.py``'s own phases.

    python3 scripts/k5_chip.py [--root DIR] [--label NAME]

``--root`` is the checkout whose port is measured (default: this script's
repository), so that two commits can be timed in one run on one card:
unpack the other with ``git archive`` into a git-ignored directory and run
parent, change, change, parent, one process each.  The run takes that
checkout's ``chip_smoke.py``: K5's registers and spills
(``k5_build_lines``), K5 against its plain version and K1 and timed at the
band slabs under the random and the smooth flow (``check_k5``), and the
z-stack apply (``zstack_apply``) of 8 planes of 4096^2 and of 4100^2, a
width whose rows of u8, u16 and i16 planes are not on 16 bytes.  The
numbers go to ``chiprun_out/k5_chip_<label>.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k5_chip: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs
    from microaligner_tpu_torch.ops import cuda_lib

    dev = torch.device("cuda", 0)
    res = {"label": args.label, "root": args.root, "device": cs.nvidia_smi()}
    t0 = time.perf_counter()
    _, ptxas = cuda_lib.build(verbose=True)
    cuda_lib.library()
    res["build_s"] = time.perf_counter() - t0
    res["k5_build"] = cs.k5_build_lines(ptxas)
    rng = np.random.default_rng(20261016)
    res["k5"] = cs.check_k5(dev, rng)
    counters = cs.Counters()
    for n in (4096, 4100):
        res[f"zstack_{n}"] = cs.zstack_apply(dev, rng, counters, n=n)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"k5_chip_{args.label}.json").write_text(json.dumps(res, indent=1, default=str))
    print(json.dumps({"label": args.label, "device": res["device"],
                      **{k: res[k]["apply_ms"] for k in res if k.startswith("zstack_")}}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
