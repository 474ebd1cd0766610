"""Synthesize OME-XML for CycleBuilder inputs (per-channel files).

Behavioral re-implementation of stack_builder.py: for inputs given as
``Cycle N: {channel_name: path}``, probe the first file's dimensions and
fabricate a per-cycle OME document with Channel and TiffData nodes so the
rest of the pipeline can treat every topology uniformly.

Deviation (documented): the reference sets SizeZ = Z * num_channels when the
per-channel files are z-stacks (stack_builder.py:107-111), which indexes TIFF
pages past the end of each file — unreachable-but-broken.  We set SizeZ = Z
of one file (each channel file holds its own z-planes).

Copied from ``microaligner_tpu/pipeline/stack_builder.py``, which imports no JAX, with its
imports rewritten to this package (importing anything under
``microaligner_tpu`` would run its ``__init__``, which imports JAX).
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List

from microaligner_tpu_torch.io.ome import XML, str_to_xml
from microaligner_tpu_torch.io.tiff import TiffFile

__all__ = ["generate_ome_for_cycle_builder", "process_cycle_map", "get_image_dims"]

_OME_ATTRIB = {
    "xmlns": "http://www.openmicroscopy.org/Schemas/OME/2016-06",
    "xmlns:xsi": "http://www.w3.org/2001/XMLSchema-instance",
    "xsi:schemaLocation": (
        "http://www.openmicroscopy.org/Schemas/OME/2016-06 "
        "http://www.openmicroscopy.org/Schemas/OME/2016-06/ome.xsd"
    ),
}


def digits_from_str(string: str) -> List[int]:
    return [int(x) for x in re.split(r"(\d+)", string) if x.isdigit()]


def process_cycle_map(cycle_map: Dict[str, Dict[str, str]]) -> Dict[int, Dict[str, str]]:
    """'Cycle N' keys -> sorted integer keys (stack_builder.py:49-66)."""
    with_ids = {digits_from_str(name)[0]: v for name, v in cycle_map.items()}
    return {k: with_ids[k] for k in sorted(with_ids)}


def get_image_dims(path: Path) -> Dict[str, int]:
    """Collapse Q/C/Z ambiguity of a single file to Z (stack_builder.py:68-96)."""
    with TiffFile(path) as tf:
        s = tf.series[0]
        shape = list(s.shape)
        axes = list(s.axes)
    dims = {d: (shape[axes.index(d)] if d in axes else 1) for d in ("Q", "C", "Z", "Y", "X")}
    if sum(v > 1 for v in (dims["Q"], dims["C"], dims["Z"])) >= 2:
        raise ValueError("The input image has too many dimensions")
    z = max(dims["Q"], dims["C"], dims["Z"])
    return {"Z": z, "Y": dims["Y"], "X": dims["X"]}


def generate_ome_for_cycle_builder(cycle_map: Dict[int, Dict[str, Path]]) -> Dict[int, XML]:
    first_cycle = cycle_map[list(cycle_map.keys())[0]]
    first_path = list(first_cycle.values())[0]
    with TiffFile(first_path) as tf:
        img_dtype = tf.series[0].dtype

    ome_per_cycle: Dict[int, XML] = {}
    channel_id_offset = 0
    for cyc, chans in cycle_map.items():
        ch_names = list(chans.keys())
        nch = len(ch_names)
        d = get_image_dims(list(chans.values())[0])
        sizes = {"SizeT": 1, "SizeZ": d["Z"], "SizeC": nch, "SizeY": d["Y"], "SizeX": d["X"]}

        pixels_attrib = {
            "ID": "Pixels:0",
            "DimensionOrder": "XYZCT",
            "Interleaved": "false",
            "Type": img_dtype.name,
        }
        pixels_attrib.update({k: str(v) for k, v in sizes.items()})

        node_ome = ET.Element("OME", _OME_ATTRIB)
        node_image = ET.Element("Image", {"ID": "Image:0", "Name": "default.tif"})
        node_pixels = ET.Element("Pixels", pixels_attrib)
        for i, name in enumerate(ch_names):
            node_pixels.append(
                ET.Element(
                    "Channel",
                    {"ID": f"Channel:0:{channel_id_offset + i}", "Name": name, "SamplesPerPixel": "1"},
                )
            )
        ifd = 0
        for t in range(sizes["SizeT"]):
            for c in range(sizes["SizeC"]):
                for z in range(sizes["SizeZ"]):
                    node_pixels.append(
                        ET.Element(
                            "TiffData",
                            {"FirstT": str(t), "FirstC": str(c), "FirstZ": str(z), "IFD": str(ifd)},
                        )
                    )
                    ifd += 1
        channel_id_offset += nch
        node_image.append(node_pixels)
        node_ome.append(node_image)
        xmlstr = '<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(
            node_ome, encoding="utf-8", method="xml"
        ).decode("ascii")
        ome_per_cycle[cyc] = str_to_xml(xmlstr)
    return ome_per_cycle
