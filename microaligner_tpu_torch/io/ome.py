"""OME-XML metadata processing.

Behavioral re-implementation of the reference's ome_meta_processing.py:
namespace-stripped ElementTree parsing, reference-channel resolution with
cycle-prefix stripping, pixel-size extraction with unit conversion to nm
(pint is not available here; a fixed conversion table covers the OME length
units), and the four output-metadata modes of ``create_new_meta``
(passthrough / combined / split / per-image — ome_meta_processing.py:455-473).

Copied from ``microaligner_tpu/io/ome.py``, which imports no JAX, with its
imports rewritten to this package (importing anything under
``microaligner_tpu`` would run its ``__init__``, which imports JAX).
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from copy import deepcopy
from io import StringIO
from typing import Any, Dict, List, Tuple, Union

__all__ = [
    "str_to_xml",
    "xml_to_string",
    "read_ome_meta_from_file",
    "strip_cycle_info",
    "collect_info_from_ome",
    "extract_pixels_info",
    "extract_channel_info",
    "create_new_meta",
]

XML = ET.Element

# OME length units -> nanometers
_TO_NM = {
    "Ym": 1e33, "Zm": 1e30, "Em": 1e27, "Pm": 1e24, "Tm": 1e21, "Gm": 1e18,
    "Mm": 1e15, "km": 1e12, "hm": 1e11, "dam": 1e10, "m": 1e9, "dm": 1e8,
    "cm": 1e7, "mm": 1e6, "µm": 1e3, "um": 1e3, "micron": 1e3, "nm": 1.0,
    "pm": 1e-3, "fm": 1e-6, "Å": 0.1, "angstrom": 0.1,
}


def str_to_xml(xmlstr: str) -> XML:
    """Parse, stripping XML namespaces from tags."""
    it = ET.iterparse(StringIO(xmlstr))
    for _, el in it:
        _, _, el.tag = el.tag.rpartition("}")
    return it.root


def xml_to_string(xml: XML) -> str:
    decl = '<?xml version="1.0" encoding="UTF-8"?>'
    # decode as UTF-8: the reference decodes ascii/errors=ignore
    # (ome_meta_processing.py:284), which silently strips non-ASCII — e.g.
    # PhysicalSizeXUnit "µm" became "m", a 1e9 unit corruption in passthrough
    return decl + ET.tostring(xml, method="xml", encoding="utf-8").decode("utf-8")


def read_ome_meta_from_file(path) -> XML:
    from microaligner_tpu_torch.io.tiff import TiffFile

    with TiffFile(path) as tf:
        ome_str = tf.ome_metadata
    if ome_str is None:
        raise ValueError(f"{path}: no OME metadata found")
    return str_to_xml(ome_str)


def convert_to_nm(value: float, unit: str) -> float:
    if unit not in _TO_NM:
        raise ValueError(f"Unsupported physical size unit: {unit}")
    return value * _TO_NM[unit]


def _convert_sizes(size_info: dict) -> dict:
    size_info["PhysicalSizeX"] = convert_to_nm(size_info["PhysicalSizeX"], size_info["PhysicalSizeXUnit"])
    size_info["PhysicalSizeY"] = convert_to_nm(size_info["PhysicalSizeY"], size_info["PhysicalSizeYUnit"])
    size_info["PhysicalSizeXUnit"] = "nm"
    size_info["PhysicalSizeYUnit"] = "nm"
    return size_info


def strip_cycle_info(name: str) -> str:
    """Strip cycle prefixes/suffixes from a channel name, e.g. 'c02 DAPI-1'
    -> 'DAPI' (reference regexes at ome_meta_processing.py:71-74)."""
    ch = re.sub(r"^(c|cyc|cycle)\d+(\s+|_|-)?", "", name)
    return re.sub(r"(-\d+)?(_\d+)?$", "", ch)


def _filter_ref_channel_ids(ref_ch: str, channels: List[str]) -> List[int]:
    return [i for i, ch in enumerate(channels) if re.match(ref_ch, ch, re.IGNORECASE)]


def _find_where_ref_channel(ref_ch: str, channel_info) -> Tuple[List[str], List[int]]:
    fluors = channel_info["channel_fluors"]
    names = [strip_cycle_info(n) for n in channel_info["channel_names"]]
    fluors = [strip_cycle_info(f) for f in fluors] if fluors else None
    if ref_ch in names:
        cleaned = names
    elif fluors is not None and ref_ch in fluors:
        cleaned = fluors
    else:
        avail = f"Available channel names: {set(names)}"
        if fluors is not None:
            avail += f", fluors: {set(fluors)}"
        raise ValueError(f"Incorrect reference channel {ref_ch}. " + avail)
    return cleaned, _filter_ref_channel_ids(ref_ch, cleaned)


def extract_channel_info(ome_xml: XML) -> Dict[str, Any]:
    pixels = ome_xml.find("Image").find("Pixels")
    channels = pixels.findall("Channel")
    attrs = pixels.attrib
    return {
        "channels": channels,
        "channel_names": [ch.get("Name") for ch in channels],
        "channel_fluors": [ch.get("Fluor") for ch in channels if "Fluor" in ch.attrib],
        "nchannels": int(attrs.get("SizeC", 1)),
        "nzplanes": int(attrs.get("SizeZ", 1)),
    }


def extract_pixels_info(ome_xml: XML) -> Dict[str, Union[int, float, str]]:
    pixels = ome_xml.find("Image").find("Pixels")
    info: Dict[str, Union[int, float, str]] = {}
    for d in ("SizeX", "SizeY", "SizeC", "SizeZ", "SizeT"):
        info[d] = int(pixels.get(d, 1))
    for s in ("PhysicalSizeX", "PhysicalSizeY"):
        info[s] = float(pixels.get(s, 1))
    for u in ("PhysicalSizeXUnit", "PhysicalSizeYUnit"):
        info[u] = pixels.get(u, "um")
    return info


def collect_info_from_ome(ref_ch: str, ome_xml: XML) -> Dict[str, Any]:
    channel_info = extract_channel_info(ome_xml)
    _, ref_ids = _find_where_ref_channel(ref_ch, channel_info)
    info = channel_info.copy()
    info["ref_ch_ids"] = ref_ids
    info.update(extract_pixels_info(ome_xml))
    return info


# -- output metadata construction ---------------------------------------------

_OME_ATTRIBS = {
    "xmlns": "http://www.openmicroscopy.org/Schemas/OME/2016-06",
    "xmlns:xsi": "http://www.w3.org/2001/XMLSchema-instance",
    "xsi:schemaLocation": (
        "http://www.openmicroscopy.org/Schemas/OME/2016-06 "
        "http://www.openmicroscopy.org/Schemas/OME/2016-06/ome.xsd"
    ),
}


def _extract_sizes(ome_xml_list: List[XML], target_shape) -> Dict[str, Any]:
    infos = [extract_pixels_info(x) for x in ome_xml_list]
    return {
        "SizeX": target_shape[1],
        "SizeY": target_shape[0],
        "SizeC": sum(i["SizeC"] for i in infos),
        "SizeZ": max(i["SizeZ"] for i in infos),
        "SizeT": max(i["SizeT"] for i in infos),
        "PhysicalSizeX": max(i["PhysicalSizeX"] for i in infos),
        "PhysicalSizeY": max(i["PhysicalSizeY"] for i in infos),
        "PhysicalSizeXUnit": infos[-1]["PhysicalSizeXUnit"],
        "PhysicalSizeYUnit": infos[-1]["PhysicalSizeYUnit"],
    }


def _tiff_data_nodes(n_time: int, n_channels: int, n_zplanes: int) -> List[XML]:
    nodes = []
    ifd = 0
    for t in range(n_time):
        for c in range(n_channels):
            for z in range(n_zplanes):
                nodes.append(
                    ET.Element(
                        "TiffData",
                        {"FirstC": str(c), "FirstT": str(t), "FirstZ": str(z),
                         "IFD": str(ifd), "PlaneCount": "1"},
                    )
                )
                ifd += 1
    return nodes


def _reset_pixels(xml: XML, sizes: Dict[str, Any]):
    pixels = xml.find("Image").find("Pixels")
    pixels.set("DimensionOrder", "XYZCT")
    for attr, val in sizes.items():
        pixels.set(attr, str(val))
    xml.attrib.clear()
    for attr, val in _OME_ATTRIBS.items():
        xml.set(attr, val)
    for td in pixels.findall("TiffData"):
        pixels.remove(td)


def _append_tiffdata(xml: XML, sizes: Dict[str, Any]):
    pixels = xml.find("Image").find("Pixels")
    for td in _tiff_data_nodes(sizes["SizeT"], sizes["SizeC"], sizes["SizeZ"]):
        pixels.append(td)


def _combined_meta(ome_meta_per_cyc: Dict[int, XML], target_shape) -> Dict[int, str]:
    """All cycles into one stack: cycle-prefixed channel names, summed SizeC."""
    xmls = list(ome_meta_per_cyc.values())
    infos = [extract_channel_info(x) for x in xmls]
    sizes = _convert_sizes(_extract_sizes(xmls, target_shape))
    ncycles = len(xmls)
    ref_xml = deepcopy(xmls[0])
    _reset_pixels(ref_xml, sizes)
    pixels = ref_xml.find("Image").find("Pixels")
    for ch in pixels.findall("Channel"):
        pixels.remove(ch)
    digit_format = "0" + str(len(str(ncycles)) + 1) + "d"
    channel_id = 0
    for i in range(ncycles):
        prefix = "c" + format(i + 1, digit_format) + " "
        for ch, name in zip(infos[i]["channels"], infos[i]["channel_names"]):
            node = deepcopy(ch)
            node.set("Name", prefix + (name or ""))
            node.set("ID", f"Channel:0:{channel_id}")
            pixels.append(node)
            channel_id += 1
    _append_tiffdata(ref_xml, sizes)
    result = xml_to_string(ref_xml)
    return {cyc: result for cyc in ome_meta_per_cyc}


def _per_image_meta(ome_meta_per_cyc: Dict[int, XML], target_shape) -> Dict[int, str]:
    out = {}
    for cyc, old in ome_meta_per_cyc.items():
        sizes = _convert_sizes(_extract_sizes([old], target_shape))
        new = deepcopy(old)
        _reset_pixels(new, sizes)
        _append_tiffdata(new, sizes)
        out[cyc] = xml_to_string(new)
    return out


def _split_stack_meta(ome_meta_per_cyc: Dict[int, XML], target_shape) -> Dict[int, str]:
    """One input stack -> one file per cycle with that cycle's channel slice."""
    xmls = list(ome_meta_per_cyc.values())
    total_c = _extract_sizes([xmls[0]], target_shape)["SizeC"]
    ncycles = len(ome_meta_per_cyc)
    per_cyc_c = int(round(total_c / ncycles))
    out = {}
    for n, (cyc, old) in enumerate(ome_meta_per_cyc.items()):
        sizes = _extract_sizes([old], target_shape)
        sizes["SizeC"] = per_cyc_c
        sizes = _convert_sizes(sizes)
        new = deepcopy(old)
        info = extract_channel_info(old)
        sl = slice(n * per_cyc_c, (n + 1) * per_cyc_c)
        _reset_pixels(new, sizes)
        pixels = new.find("Image").find("Pixels")
        for ch in pixels.findall("Channel"):
            pixels.remove(ch)
        for i, (ch, name) in enumerate(zip(info["channels"][sl], info["channel_names"][sl])):
            node = deepcopy(ch)
            node.set("Name", name or "")
            node.set("ID", f"Channel:0:{i}")
            pixels.append(node)
        _append_tiffdata(new, sizes)
        out[cyc] = xml_to_string(new)
    return out


def create_new_meta(
    ome_meta_per_cyc: Dict[int, XML],
    target_shape,
    input_is_stack: bool,
    output_is_stack: bool,
) -> Dict[int, str]:
    """Output OME metadata for the four in/out topology combinations
    (reference ome_meta_processing.py:455-473)."""
    if input_is_stack and output_is_stack:
        return {cyc: xml_to_string(x) for cyc, x in ome_meta_per_cyc.items()}
    if output_is_stack:
        return _combined_meta(ome_meta_per_cyc, target_shape)
    if input_is_stack:
        return _split_stack_meta(ome_meta_per_cyc, target_shape)
    return _per_image_meta(ome_meta_per_cyc, target_shape)
