"""YAML pipeline configuration with the reference's exact schema.

Schema, field names, dtype checks, bounds, and input-topology inference all
match the reference (pipeline_modules/config_reader.py): three input layouts
(``CycleStack`` / ``CycleBuilder`` / ``CyclePerImage``), bounds
NumberPyramidLevels 0..8, NumberIterationsPerLevel >=1, TileSize >=20,
Overlap 10..TileSize, NumberOfWorkers >=0 (tile parallelism maps to a device
mesh instead of a worker pool, and the key caps the mesh: 0 is every visible
card, ``utils/workers.py``).

The implementation is table-driven: each section is a tuple of field specs
``(name, accepted types, lo, hi)`` validated by one generic checker, and the
input-topology inference + path parsing happen in a single traversal — unlike
the reference's per-field call chains.

Copied from ``microaligner_tpu/pipeline/config.py``, which imports no JAX, with its
imports rewritten to this package (importing anything under
``microaligner_tpu`` would run its ``__init__``, which imports JAX).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import yaml

__all__ = ["PipelineConfig", "PipelineConfigReader", "RegParam"]

FloatInt = Union[float, int]

# Field spec: (name, accepted type(s), min, max).  ``max`` may name another
# field in the same section (resolved at validation time) — used by
# Overlap <= TileSize.
_Spec = Tuple[str, tuple, Optional[FloatInt], Union[FloatInt, str, None]]

_REG_PARAM_SPECS: Tuple[_Spec, ...] = (
    ("NumberPyramidLevels", (int,), 0, 8),
    ("NumberIterationsPerLevel", (int,), 1, None),
    ("TileSize", (int,), 20, None),
    ("Overlap", (int,), 10, "TileSize"),
    ("NumberOfWorkers", (int,), 0, None),
    ("UseFullResImage", (bool,), None, None),
    ("UseDOG", (bool,), None, None),
)

_INPUT_SPECS: Tuple[_Spec, ...] = (
    ("InputImagePaths", (dict, list), None, None),
    ("ReferenceCycle", (int,), 1, None),
    ("ReferenceChannel", (str,), None, None),
)

_OUTPUT_SPECS: Tuple[_Spec, ...] = (
    ("OutputDir", (str,), None, None),
    ("OutputPrefix", (str,), None, None),
    ("SaveOutputToCycleStack", (bool,), None, None),
)

_CYCLE_KEY = re.compile(r"Cycle (\d+)")


def read_yaml(path) -> dict:
    with open(path, "r", encoding="utf-8") as s:
        return yaml.safe_load(s)


def _validate_section(section: dict, specs: Tuple[_Spec, ...]):
    """Presence + dtype + range for every field spec, in one pass."""
    for name, types, lo, hi in specs:
        if name not in section:
            raise KeyError(f"config is missing required field '{name}'")
        val = section[name]
        if not isinstance(val, types):
            raise TypeError(
                f"config field '{name}': got {type(val).__name__}, "
                f"expected one of {[t.__name__ for t in types]}"
            )
        if not isinstance(val, (int, float)):
            continue
        if isinstance(hi, str):  # bound given by a sibling field
            hi = section.get(hi)
        if lo is not None and val < lo:
            raise ValueError(f"config field '{name}'={val} is below the minimum of {lo}")
        if hi is not None and val > hi:
            raise ValueError(f"config field '{name}'={val} is above the maximum of {hi}")


class RegParam:
    NumberPyramidLevels: int
    NumberIterationsPerLevel: int
    TileSize: int
    Overlap: int
    NumberOfWorkers: int
    UseFullResImage: bool
    UseDOG: bool

    def read_from_dict(self, d: dict):
        _validate_section(d, _REG_PARAM_SPECS)
        for name, *_ in _REG_PARAM_SPECS:
            setattr(self, name, d[name])

    def __repr__(self):
        return str(self.__dict__)


class PipelineInput:
    InputImagePaths: dict
    ReferenceCycle: int
    ReferenceChannel: str
    PipelineInputType: str

    def __repr__(self):
        return str(self.__dict__)


class PipelineOutput:
    OutputDir: Path
    OutputPrefix: str
    SaveOutputToCycleStack: bool

    def __repr__(self):
        return str(self.__dict__)


class PipelineRegParam:
    FeatureReg: Optional[RegParam]
    OptFlowReg: Optional[RegParam]

    def __init__(self):
        self.FeatureReg = RegParam()
        self.OptFlowReg = RegParam()

    def __repr__(self):
        return f"FeatureReg: {self.FeatureReg}, OptFlowReg: {self.OptFlowReg}"


class PipelineConfig:
    def __init__(self):
        self.Input = PipelineInput()
        self.Output = PipelineOutput()
        self.RegistrationParameters = PipelineRegParam()

    def __repr__(self):
        return str(self.__dict__)


def _cycle_id(key: str) -> int:
    m = _CYCLE_KEY.match(key)
    if not m:
        raise ValueError(f"bad cycle key {key!r}: expected the form 'Cycle <number>'")
    return int(m.group(1))


def _parse_input_paths(path_dict: dict) -> Tuple[str, Dict]:
    """Infer the input topology AND build the parsed path mapping in one
    traversal (reference splits this into get_path_dict_type + a second walk).

    Returns ``(topology, {cycle_id: Path | {channel: Path}})``.
    """
    if "CycleStack" in path_dict:
        if len(path_dict) > 1:
            raise ValueError("a CycleStack input is a single stack file; remove the extra paths")
        return "CycleStack", {0: Path(path_dict["CycleStack"])}

    per_channel: Dict[int, Dict[str, Path]] = {}
    per_cycle: Dict[int, Path] = {}
    unknown = []
    for key, val in path_dict.items():
        if isinstance(val, dict):
            cyc = _cycle_id(key)
            channels = list(val.keys())
            if len(channels) > len(set(channels)):
                raise ValueError(f"duplicate channel names under Cycle {cyc}: {channels}")
            per_channel[cyc] = {ch: Path(p) for ch, p in val.items()}
        elif isinstance(val, str):
            per_cycle[_cycle_id(key)] = Path(val)
        else:
            unknown.append(key)

    if per_channel and per_cycle:
        raise NotImplementedError(
            "InputImagePaths mixes per-channel and per-cycle entries; pick one layout"
        )
    if not per_channel and not per_cycle:
        raise ValueError(
            "InputImagePaths matches none of the known layouts "
            "(CycleStack / CycleBuilder / CyclePerImage)"
        )
    if max(len(per_channel), len(per_cycle)) < 2:
        raise ValueError("registration needs at least two cycles in InputImagePaths")
    if per_channel:
        return "CycleBuilder", per_channel
    return "CyclePerImage", per_cycle


class PipelineConfigReader:
    """Reads and validates the pipeline YAML (reference config_reader.py:149-304)."""

    def read_config(self, config_path) -> PipelineConfig:
        config = read_yaml(config_path)
        missing = [f for f in ("Input", "Output", "RegistrationParameters") if f not in config]
        if missing:
            raise ValueError(f"config file lacks required top-level sections: {missing}")

        pc = PipelineConfig()

        inp = config["Input"]
        if not isinstance(inp, dict):
            raise ValueError("the Input section must be a mapping")
        _validate_section(inp, _INPUT_SPECS)
        topology, parsed_paths = _parse_input_paths(inp["InputImagePaths"])
        pc.Input.InputImagePaths = parsed_paths
        pc.Input.ReferenceCycle = inp["ReferenceCycle"]
        pc.Input.ReferenceChannel = inp["ReferenceChannel"]
        pc.Input.PipelineInputType = topology

        outp = config["Output"]
        _validate_section(outp, _OUTPUT_SPECS)
        pc.Output.OutputDir = Path(outp["OutputDir"])
        pc.Output.OutputPrefix = outp["OutputPrefix"]
        pc.Output.SaveOutputToCycleStack = outp["SaveOutputToCycleStack"]

        reg = config["RegistrationParameters"]
        if "FeatureReg" not in reg and "OptFlowReg" not in reg:
            raise ValueError("RegistrationParameters must define FeatureReg, OptFlowReg, or both")
        for engine in ("FeatureReg", "OptFlowReg"):
            if engine in reg:
                if not isinstance(reg[engine], dict):
                    raise TypeError(f"config field '{engine}': expected a mapping")
                getattr(pc.RegistrationParameters, engine).read_from_dict(reg[engine])
            else:
                setattr(pc.RegistrationParameters, engine, None)
        return pc
