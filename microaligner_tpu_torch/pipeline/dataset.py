"""Dataset structure resolution: which TIFF page holds (cycle, channel, z).

Behavioral re-implementation of metadata_handling.py: the ``DatasetStruct``
maps ``[cycle][channel][z] -> tiff page / file path`` for the three input
topologies (stack / per-image / builder).  Cycle count for stacks is inferred
from the spacing of the reference channel across the combined channel list.

Copied from ``microaligner_tpu/pipeline/dataset.py``, which imports no JAX, with its
imports rewritten to this package (importing anything under
``microaligner_tpu`` would run its ``__init__``, which imports JAX).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Union

from microaligner_tpu_torch.io.ome import (
    XML,
    collect_info_from_ome,
    read_ome_meta_from_file,
    strip_cycle_info,
)
from microaligner_tpu_torch.pipeline.stack_builder import generate_ome_for_cycle_builder

__all__ = ["DatasetStruct", "DatasetStructCreator"]


@dataclass
class DatasetStruct:
    tiff_pages: Dict[int, Dict[int, Dict[int, int]]] = field(default_factory=dict)
    img_paths: Dict[int, Dict[int, Dict[int, Path]]] = field(default_factory=dict)
    ref_channel_ids: Dict[int, int] = field(default_factory=dict)
    ome_xmls: Dict[int, XML] = field(default_factory=dict)


class DatasetStructCreator:
    def __init__(self):
        self._ref_ch = "DAPI"
        self.img_paths: Union[None, Dict] = None
        self.input_is_stack = False
        self.input_is_stack_builder = False
        self.output_is_stack = True

    @property
    def ref_channel_name(self) -> str:
        return self._ref_ch

    @ref_channel_name.setter
    def ref_channel_name(self, channel_name: str):
        self._ref_ch = strip_cycle_info(channel_name)

    def create_dataset_struct(self) -> DatasetStruct:
        if self.img_paths is None:
            raise ValueError("Attribute img_paths is empty")
        if self.input_is_stack:
            return self._stack_structure(self.img_paths)
        if self.input_is_stack_builder:
            return self._builder_structure(self.img_paths)
        return self._img_list_structure(self.img_paths)

    def _stack_structure(self, cycle_stack_path: Dict[int, Path]) -> DatasetStruct:
        img_path = cycle_stack_path[sorted(cycle_stack_path.keys())[0]]
        ome_xml = read_ome_meta_from_file(img_path)
        info = collect_info_from_ome(self._ref_ch, ome_xml)
        ref_ch_ids = info["ref_ch_ids"]
        if len(ref_ch_ids) < 2:
            raise ValueError(
                "Cannot infer cycles from the stack: the reference channel "
                f"{self._ref_ch!r} appears {len(ref_ch_ids)} time(s)"
            )
        nch_per_cycle = ref_ch_ids[1] - ref_ch_ids[0]
        ncycles = info["nchannels"] // nch_per_cycle
        nz = info["nzplanes"]

        struct = DatasetStruct()
        page = 0
        for cyc in range(1, ncycles + 1):
            pages: Dict[int, Dict[int, int]] = {}
            paths: Dict[int, Dict[int, Path]] = {}
            for ch in range(1, nch_per_cycle + 1):
                pages[ch] = {}
                paths[ch] = {}
                for z in range(1, nz + 1):
                    pages[ch][z] = page
                    paths[ch][z] = img_path
                    page += 1
            struct.tiff_pages[cyc] = pages
            struct.img_paths[cyc] = paths
            struct.ref_channel_ids[cyc] = ref_ch_ids[0] + 1
            struct.ome_xmls[cyc] = ome_xml
        return struct

    def _img_list_structure(self, img_paths: Dict[int, Path]) -> DatasetStruct:
        struct = DatasetStruct()
        for cyc, img_path in img_paths.items():
            ome_xml = read_ome_meta_from_file(img_path)
            info = collect_info_from_ome(self._ref_ch, ome_xml)
            pages: Dict[int, Dict[int, int]] = {}
            paths: Dict[int, Dict[int, Path]] = {}
            page = 0
            for ch in range(1, info["nchannels"] + 1):
                pages[ch] = {}
                paths[ch] = {}
                for z in range(1, info["nzplanes"] + 1):
                    pages[ch][z] = page
                    paths[ch][z] = img_path
                    page += 1
            struct.tiff_pages[cyc] = pages
            struct.img_paths[cyc] = paths
            struct.ref_channel_ids[cyc] = info["ref_ch_ids"][0] + 1
            struct.ome_xmls[cyc] = ome_xml
        return struct

    def _builder_structure(self, cycle_map: Dict[int, Dict[str, Path]]) -> DatasetStruct:
        ome_per_cyc = generate_ome_for_cycle_builder(cycle_map)
        struct = DatasetStruct()
        for cyc, ome_xml in ome_per_cyc.items():
            info = collect_info_from_ome(self._ref_ch, ome_xml)
            ch_names = list(cycle_map[cyc].keys())
            pages: Dict[int, Dict[int, int]] = {}
            paths: Dict[int, Dict[int, Path]] = {}
            for ch in range(1, info["nchannels"] + 1):
                pages[ch] = {}
                paths[ch] = {}
                img_path = cycle_map[cyc][ch_names[ch - 1]]
                for z in range(1, info["nzplanes"] + 1):
                    pages[ch][z] = z - 1
                    paths[ch][z] = img_path
            struct.tiff_pages[cyc] = pages
            struct.img_paths[cyc] = paths
            struct.ref_channel_ids[cyc] = info["ref_ch_ids"][0] + 1
            struct.ome_xmls[cyc] = ome_xml
        return struct
