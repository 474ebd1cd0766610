"""A cell at a size the CPU runs in seconds, for the benchmark's tests."""

from __future__ import annotations

import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 7  # past 32 signed bits, as the driver's seeds are
OPTFLOW = {"NumberPyramidLevels": 2, "NumberIterationsPerLevel": 3, "TileSize": 100, "Overlap": 16,
           "NumberOfWorkers": 0, "UseFullResImage": True, "UseDOG": False}
FEATURE = {"NumberPyramidLevels": 3, "NumberIterationsPerLevel": 2, "TileSize": 200, "Overlap": 100,
           "NumberOfWorkers": 0, "UseFullResImage": False, "UseDOG": True}
CELLS = ("optflow_20k.cycif4", "chained_8k.cycif4")


def override(cell: str, **extra) -> dict:
    """The cell's configuration cut to 512^2, with tiles small enough that
    OptFlowReg's coarsest level is under two tiles (one Farneback over the
    level) and the others are banded, as at the cells' own sizes.  On the
    CPU the port's FeatureReg takes float32 operands whatever its route
    (``features/routes.py``), so the precision says so; ``extra`` replaces
    further keys."""
    out = {"plane": [512, 512], "OptFlowReg": OPTFLOW, "precision": {"flow": "float32", "warp": "float32"}}
    if cell.startswith("chained"):
        out["FeatureReg"] = FEATURE
        out["precision"] = {**out["precision"], "daisy": "float32", "match": "float32"}
    return {**out, **extra}


def run(cell: str, traced: bool = False, seconds: float = 0.0, cycles_cls=None, seed: int = SEED,
        **extra) -> dict:
    """One run of ``cell`` on the CPU at the tiny size."""
    from benchmark import harness

    return harness.run(ROOT, cell, seed, seconds, traced, "cpu", time.perf_counter(),
                       cycles_cls=cycles_cls, config_override=override(cell, **extra))
