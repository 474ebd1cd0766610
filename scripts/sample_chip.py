#!/usr/bin/env python3
"""K1 and K5 (``csrc/sample.cu``) alone on one NVIDIA GPU, through
``chip_smoke.py``'s own phases, with the one-plane band warps around them.

    python3 scripts/sample_chip.py [--root DIR] [--label NAME]

``--root`` is the checkout whose port is measured (default: this script's
repository), so that two commits can be timed in one run on one card:
unpack the other with ``git archive`` into a git-ignored directory and run
parent, change, change, parent, one process each.  The run takes that
checkout's ``chip_smoke.py``: the build lines of K1 and K5
(``k1_build_lines``, where the checkout has it, and ``k5_build_lines``),
``check_kernels`` (K1–K4 held to their plain versions and timed at the band
slabs, K1 beside ``F.grid_sample``), ``check_k5``, the z-stack apply
(``zstack_apply``) of 8 planes of 4096^2 and of 4100^2, and
``check_one_plane_band`` where the checkout has it.  Timed here, the same
way in every checkout: the CLI's per-plane apply (``_apply_flow_plane``)
and the Warper's ``warp_device`` of one u16 4096^2 plane under the z-stack
apply's smooth flow (tile 1000, overlap 100: one band).  The numbers go to
``chiprun_out/sample_chip_<label>.json``; the last line is a summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def time_apply(cs, dev, rng, n=4096, tile=1000, overlap=100) -> dict:
    """``_apply_flow_plane`` and ``Warper.warp_device`` of one u16 plane,
    in the order apply, warp, apply, warp."""
    from microaligner_tpu_torch.optflow.warper import Warper
    from microaligner_tpu_torch.pipeline.runner import _apply_flow_plane
    from microaligner_tpu_torch.tiles import TileGrid

    plane = torch.from_numpy(rng.integers(0, 65535, (n, n)).astype(np.uint16)).to(dev)
    flow = torch.stack(cs.smooth_flow(n, n, dev), dim=-1).contiguous()
    grid = TileGrid.for_image((n, n), tile, overlap)
    warper = Warper(device=dev)
    warper.tile_size, warper.overlap = tile, overlap

    def warp():
        warper.image, warper.flow = plane, flow
        return warper.warp_device()

    def apply():
        return _apply_flow_plane(plane, flow, grid, torch.uint16)

    a1, w1, a2, w2 = (cs.cuda_ms(fn, 20) for fn in (apply, warp, apply, warp))
    res = {"apply_flow_plane_ms": min(a1, a2), "warp_device_ms": min(w1, w2)}
    print(f"[sample_chip] u16 {n}^2 smooth flow: _apply_flow_plane {res['apply_flow_plane_ms']:.4f} ms, "
          f"Warper.warp_device {res['warp_device_ms']:.4f} ms", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sample_chip: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs
    from microaligner_tpu_torch.ops import cuda_lib

    dev = torch.device("cuda", 0)
    res = {"label": args.label, "root": args.root, "device": cs.nvidia_smi()}
    t0 = time.perf_counter()
    _, ptxas = cuda_lib.build(verbose=True)
    cuda_lib.library()
    res["build_s"] = time.perf_counter() - t0
    if hasattr(cs, "k1_build_lines"):
        res["k1_build"] = cs.k1_build_lines(ptxas)
    res["k5_build"] = cs.k5_build_lines(ptxas)
    rng = np.random.default_rng(20261016)  # the same inputs in every checkout
    res["apply"] = time_apply(cs, dev, rng)
    res["kernels"] = cs.check_kernels(dev, rng)
    res["k5"] = cs.check_k5(dev, rng)
    counters = cs.Counters()
    for n in (4096, 4100):
        res[f"zstack_{n}"] = cs.zstack_apply(dev, rng, counters, n=n)
    if hasattr(cs, "check_one_plane_band"):
        res["one_plane_band"] = cs.check_one_plane_band(dev, rng)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"sample_chip_{args.label}.json").write_text(json.dumps(res, indent=1, default=str))
    k1 = res["kernels"]["K1"]
    print(json.dumps({"label": args.label, "device": res["device"], "apply": res["apply"],
                      "k1": {k: v for k, v in k1.items() if k.startswith(("ms", "library_ms"))},
                      **{k: res[k]["apply_ms"] for k in res if k.startswith("zstack_")}}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
