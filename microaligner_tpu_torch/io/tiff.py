"""Self-contained TIFF / BigTIFF / OME-TIFF reader and writer.

Covers what the registration pipeline needs (the subset of tifffile the
reference exercises — SURVEY §2.10):

Reader: classic (42) and BigTIFF (43), little/big endian, strip and tile
layouts, compression none/LZW/deflate(+zlib)/PackBits/zstd/LZMA, new-style
JPEG (7, incl. JPEGTables splicing), old-style JPEG (6, JPEGInterchangeFormat
layout), JPEG 2000 (34712 + Aperio 33003/33005, lossless u16 supported), WebP
(50001), horizontal predictor, 1 sample per pixel (grayscale microscopy) or N
contiguous samples, 8/16/32-bit unsigned, float32.  Page data is decoded one
page at a time (the reference's "keeps only one image page in memory"
property).

Writer: contiguous uncompressed BigTIFF with a (T, C, Z, Y, X) plane layout,
OME-XML in the first ImageDescription, addressable through a numpy memmap —
the shape of output the reference produces via ``tif.memmap``
(__main__.py:116-132).

Heavy decode loops (LZW, PackBits, predictor) go through the C++ codec in
``microaligner_tpu_torch/_native`` when built, else a numpy/Python fallback.

Copied from ``microaligner_tpu/io/tiff.py``, which imports no JAX, with its
imports rewritten to this package (importing anything under
``microaligner_tpu`` would run its ``__init__``, which imports JAX).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from microaligner_tpu_torch._native import codec as _codec

__all__ = ["TiffFile", "MemmapWriter", "read_tiff_page", "TiffPage"]

# tag ids
_T_WIDTH = 256
_T_LENGTH = 257
_T_BITS = 258
_T_COMPRESSION = 259
_T_PHOTOMETRIC = 262
_T_DESCRIPTION = 270
_T_STRIP_OFFSETS = 273
_T_SPP = 277
_T_ROWS_PER_STRIP = 278
_T_STRIP_COUNTS = 279
_T_PLANAR = 284
_T_PREDICTOR = 317
_T_TILE_WIDTH = 322
_T_TILE_LENGTH = 323
_T_TILE_OFFSETS = 324
_T_TILE_COUNTS = 325
_T_SAMPLE_FORMAT = 339
_T_JPEG_TABLES = 347
_T_JPEG_IF = 513  # JPEGInterchangeFormat: old-style (compression 6) JPEG stream
_T_JPEG_IF_LEN = 514

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q", 17: "q"}


@dataclass
class TiffPage:
    width: int = 0
    length: int = 0
    bits: int = 8
    compression: int = 1
    predictor: int = 1
    sample_format: int = 1
    samples_per_pixel: int = 1
    rows_per_strip: int = 0
    strip_offsets: List[int] = field(default_factory=list)
    strip_counts: List[int] = field(default_factory=list)
    tile_width: int = 0
    tile_length: int = 0
    tile_offsets: List[int] = field(default_factory=list)
    tile_counts: List[int] = field(default_factory=list)
    description: Optional[str] = None
    jpeg_tables: Optional[bytes] = None
    jpeg_if_offset: int = 0  # old-style JPEG: whole-page JIF stream location
    jpeg_if_length: int = 0

    @property
    def dtype(self) -> np.dtype:
        kind = {1: "u", 2: "i", 3: "f"}[self.sample_format]
        return np.dtype(f"{kind}{self.bits // 8}")

    @property
    def is_tiled(self) -> bool:
        return bool(self.tile_offsets)


@dataclass
class Series:
    """Minimal analog of ``tifffile``'s series: shape/axes/dtype + page access."""

    shape: Tuple[int, ...]
    axes: str
    dtype: np.dtype
    _tif: "TiffFile" = None

    @property
    def pages(self):
        return _SeriesPages(self._tif)


class _SeriesPages:
    def __init__(self, tif: "TiffFile"):
        self._tif = tif

    def __len__(self):
        return len(self._tif.pages)

    def __getitem__(self, i: int):
        return _PageProxy(self._tif, i)


class _PageProxy:
    def __init__(self, tif: "TiffFile", index: int):
        self._tif = tif
        self._index = index

    def asarray(self) -> np.ndarray:
        return self._tif.read_page(self._index)


def _decode_jpeg_block(data: bytes, page: TiffPage) -> np.ndarray:
    """Decode one new-style JPEG (compression 7) strip/tile to pixels.

    TIFF stores either a complete JPEG stream per block or an abbreviated
    stream whose quantization/Huffman tables live in the JPEGTables tag
    (an SOI..tables..EOI stream); the abbreviated case is reassembled by
    splicing the tables between the block's SOI and its first segment.
    Decoding itself is delegated to OpenCV (lazy import — the only place
    the package uses it at runtime): JPEG is a lossy consumer codec with no
    place on the TPU compute path, and the reference reads it through
    tifffile's optional imagecodecs dependency in exactly the same spirit.
    8-bit baseline/progressive only (cv2's JPEG support); 12-bit JPEG
    raises as unsupported.  Old-style (compression 6) pages reuse this for
    their whole-page JPEGInterchangeFormat stream (``read_page``).
    """
    try:
        import cv2
    except ImportError as e:  # pragma: no cover - cv2 is present in CI
        raise ValueError(
            "JPEG-compressed TIFF requires OpenCV (cv2) for decoding"
        ) from e

    stream = data
    tables = page.jpeg_tables
    if tables and len(tables) > 4 and stream[:2] == b"\xff\xd8":
        # strip tables' SOI/EOI, splice after the block's SOI
        stream = stream[:2] + tables[2:-2] + stream[2:]
    buf = np.frombuffer(stream, dtype=np.uint8)
    flag = cv2.IMREAD_GRAYSCALE if page.samples_per_pixel == 1 else cv2.IMREAD_COLOR
    arr = cv2.imdecode(buf, flag)
    if arr is None:
        raise ValueError("JPEG block failed to decode")
    if page.samples_per_pixel > 1:
        arr = arr[..., ::-1]  # cv2 returns BGR; TIFF wants RGB order
    return arr


def _decode_cv2_unchanged(data: bytes, page: TiffPage, codec: str) -> np.ndarray:
    """Decode a JPEG2000 / WebP block with OpenCV, preserving bit depth.

    JPEG 2000 blocks are either a JP2 container or a raw J2K codestream
    (Aperio writes the latter); cv2's OpenJPEG backend accepts both.
    ``IMREAD_UNCHANGED`` keeps uint16 JP2 pixels intact (the one JPEG-family
    codec with a lossless u16 mode microscopy actually uses).
    """
    try:
        import cv2
    except ImportError as e:  # pragma: no cover - cv2 is present in CI
        raise ValueError(f"{codec}-compressed TIFF requires OpenCV (cv2)") from e

    arr = cv2.imdecode(np.frombuffer(data, dtype=np.uint8), cv2.IMREAD_UNCHANGED)
    if arr is None:
        raise ValueError(f"{codec} block failed to decode")
    if page.samples_per_pixel == 1:
        if arr.ndim == 3:  # e.g. a gray image stored as RGB by the encoder
            arr = arr[..., 0]
        return arr
    if arr.ndim == 3 and arr.shape[-1] >= 3:
        arr = arr[..., 2::-1] if arr.shape[-1] == 3 else arr[..., [2, 1, 0, 3]]
    return arr


class TiffFile:
    """Parse IFDs up front; decode pages lazily, one at a time."""

    def __init__(self, path):
        self._path = Path(path)
        self._fh = open(self._path, "rb")
        self.pages: List[TiffPage] = []
        self.ome_metadata: Optional[str] = None
        self._parse_header_and_ifds()

    # -- context manager ----------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- parsing -------------------------------------------------------------

    def _parse_header_and_ifds(self):
        fh = self._fh
        head = fh.read(8)
        if head[:2] == b"II":
            self._bo = "<"
        elif head[:2] == b"MM":
            self._bo = ">"
        else:
            raise ValueError(f"{self._path}: not a TIFF file")
        magic = struct.unpack(self._bo + "H", head[2:4])[0]
        if magic == 42:
            self._big = False
            ifd_off = struct.unpack(self._bo + "I", head[4:8])[0]
        elif magic == 43:
            self._big = True
            offsize, _ = struct.unpack(self._bo + "HH", head[4:8])
            if offsize != 8:
                raise ValueError("unsupported BigTIFF offset size")
            ifd_off = struct.unpack(self._bo + "Q", fh.read(8))[0]
        else:
            raise ValueError(f"{self._path}: bad TIFF magic {magic}")

        seen = set()
        while ifd_off and ifd_off not in seen:
            seen.add(ifd_off)
            page, ifd_off = self._parse_ifd(ifd_off)
            self.pages.append(page)

        if self.pages and self.pages[0].description:
            d = self.pages[0].description
            if "<OME" in d or "OME xmlns" in d or d.lstrip().startswith("<?xml"):
                self.ome_metadata = d

    def _read_entry_count(self, off: int) -> Tuple[int, int, int]:
        fh = self._fh
        fh.seek(off)
        if self._big:
            n = struct.unpack(self._bo + "Q", fh.read(8))[0]
            return n, off + 8, 20
        n = struct.unpack(self._bo + "H", fh.read(2))[0]
        return n, off + 2, 12

    def _tag_values(self, typ: int, cnt: int, payload: bytes):
        if typ == 2:  # ASCII
            return payload[: cnt].split(b"\0")[0].decode("utf-8", errors="replace")
        fmt = _TYPE_FMT.get(typ)
        if fmt is None:
            return None
        return list(struct.unpack(self._bo + fmt * cnt, payload[: cnt * _TYPE_SIZES[typ]]))

    def _parse_ifd(self, off: int) -> Tuple[TiffPage, int]:
        fh = self._fh
        n, entry_off, entry_size = self._read_entry_count(off)
        inline = 8 if self._big else 4
        page = TiffPage()
        fh.seek(entry_off)
        raw = fh.read(n * entry_size)
        next_off_pos = entry_off + n * entry_size
        entries = []
        for i in range(n):
            e = raw[i * entry_size : (i + 1) * entry_size]
            tag, typ = struct.unpack(self._bo + "HH", e[:4])
            if self._big:
                cnt = struct.unpack(self._bo + "Q", e[4:12])[0]
                val = e[12:20]
            else:
                cnt = struct.unpack(self._bo + "I", e[4:8])[0]
                val = e[8:12]
            entries.append((tag, typ, cnt, val))

        for tag, typ, cnt, val in entries:
            size = _TYPE_SIZES.get(typ, 1) * cnt
            if size <= inline:
                payload = val
            else:
                ptr = struct.unpack(self._bo + ("Q" if self._big else "I"), val)[0]
                fh.seek(ptr)
                payload = fh.read(size)
            if tag == _T_JPEG_TABLES:
                # abbreviated tables stream (SOI..tables..EOI), raw bytes
                page.jpeg_tables = bytes(payload[:cnt])
                continue
            if tag in (_T_JPEG_IF, _T_JPEG_IF_LEN):
                val0 = self._tag_values(typ, cnt, payload)
                if val0:
                    if tag == _T_JPEG_IF:
                        page.jpeg_if_offset = int(val0[0])
                    else:
                        page.jpeg_if_length = int(val0[0])
                continue
            v = self._tag_values(typ, cnt, payload)
            if v is None:
                continue
            if tag == _T_WIDTH:
                page.width = int(v[0])
            elif tag == _T_LENGTH:
                page.length = int(v[0])
            elif tag == _T_BITS:
                page.bits = int(v[0])
            elif tag == _T_COMPRESSION:
                page.compression = int(v[0])
            elif tag == _T_PREDICTOR:
                page.predictor = int(v[0])
            elif tag == _T_SAMPLE_FORMAT:
                page.sample_format = int(v[0])
            elif tag == _T_SPP:
                page.samples_per_pixel = int(v[0])
            elif tag == _T_ROWS_PER_STRIP:
                page.rows_per_strip = int(v[0])
            elif tag == _T_STRIP_OFFSETS:
                page.strip_offsets = [int(x) for x in v]
            elif tag == _T_STRIP_COUNTS:
                page.strip_counts = [int(x) for x in v]
            elif tag == _T_TILE_WIDTH:
                page.tile_width = int(v[0])
            elif tag == _T_TILE_LENGTH:
                page.tile_length = int(v[0])
            elif tag == _T_TILE_OFFSETS:
                page.tile_offsets = [int(x) for x in v]
            elif tag == _T_TILE_COUNTS:
                page.tile_counts = [int(x) for x in v]
            elif tag == _T_DESCRIPTION and isinstance(v, str):
                page.description = v

        fh.seek(next_off_pos)
        nxt = struct.unpack(self._bo + ("Q" if self._big else "I"), fh.read(8 if self._big else 4))[0]
        return page, nxt

    # -- series (tifffile-compatible surface) --------------------------------

    @property
    def series(self) -> List[Series]:
        p0 = self.pages[0]
        npages = len(self.pages)
        if self.ome_metadata is not None:
            from microaligner_tpu_torch.io.ome import str_to_xml, extract_pixels_info

            info = extract_pixels_info(str_to_xml(self.ome_metadata))
            shape: List[int] = []
            axes = ""
            for ax, key in (("T", "SizeT"), ("C", "SizeC"), ("Z", "SizeZ")):
                if int(info[key]) > 1:
                    shape.append(int(info[key]))
                    axes += ax
            shape += [p0.length, p0.width]
            axes += "YX"
            return [Series(tuple(shape), axes, p0.dtype, self)]
        if npages > 1:
            return [Series((npages, p0.length, p0.width), "QYX", p0.dtype, self)]
        return [Series((p0.length, p0.width), "YX", p0.dtype, self)]

    # -- decoding -------------------------------------------------------------

    def _decode_block(self, data: bytes, page: TiffPage, rows: int, cols: int) -> np.ndarray:
        spp = page.samples_per_pixel
        itemsize = page.bits // 8
        expected = rows * cols * spp * itemsize
        if page.compression == 1:
            raw = data[:expected]
        elif page.compression == 5:
            raw = _codec.lzw_decode(data, expected)
        elif page.compression in (8, 32946):
            raw = zlib.decompress(data)
        elif page.compression == 32773:
            raw = _codec.packbits_decode(data, expected)
        elif page.compression in (50000, 34926):  # zstd (official + legacy tag)
            raw = _codec.zstd_decode(data, expected)
        elif page.compression == 34925:  # LZMA (tifffile writes .xz containers)
            import lzma

            raw = lzma.decompress(data)
        elif page.compression == 7:  # new-style JPEG (lossy, 8-bit)
            # decoded to pixels directly (no predictor applies to JPEG);
            # crop the codec's MCU-padded output to the block extent
            arr = _decode_jpeg_block(data, page)
            return arr[:rows, :cols]
        elif page.compression in (34712, 33003, 33005):
            # JPEG 2000: official tag + the two Aperio SVS raw-codestream tags
            arr = _decode_cv2_unchanged(data, page, "JPEG2000")
            return arr[:rows, :cols]
        elif page.compression == 50001:  # WebP (BigTIFF extension tag)
            arr = _decode_cv2_unchanged(data, page, "WebP")
            return arr[:rows, :cols]
        else:
            # JPEG-family and exotic codecs are documented out of scope
            # (PARITY.md); the reference reads them via tifffile's imagecodecs
            raise ValueError(f"unsupported TIFF compression {page.compression}")
        if len(raw) < expected:
            raw = raw + b"\0" * (expected - len(raw))
        arr = np.frombuffer(raw, dtype=page.dtype.newbyteorder(self._bo), count=rows * cols * spp)
        arr = arr.astype(page.dtype, copy=False)  # native byte order
        arr = arr.reshape(rows, cols * spp if spp > 1 else cols)
        if spp > 1:
            arr = arr.reshape(rows, cols, spp)
        if page.predictor == 2:
            arr = _codec.undo_horizontal_predictor(arr)
        elif page.predictor != 1:
            # e.g. 3 = floating-point differencing: decoding without undoing
            # it would silently produce garbage pixels
            raise ValueError(f"unsupported TIFF predictor {page.predictor}")
        return arr

    def read_page(self, index: int) -> np.ndarray:
        page = self.pages[index]
        fh = self._fh
        spp = page.samples_per_pixel
        if page.compression == 6:
            # Old-style JPEG: the overwhelmingly common layout stores one
            # complete JIF stream per page at JPEGInterchangeFormat (tag 513);
            # strip offsets, if present, alias into it and are ignored.  The
            # tables-in-tags variant (JPEGQTables/DC/ACTables, no JIF) was
            # never produced by mainstream writers and raises clearly.
            if not page.jpeg_if_offset:
                raise ValueError(
                    "old-style JPEG (compression 6) without a "
                    "JPEGInterchangeFormat stream is unsupported"
                )
            fh.seek(0, 2)
            end = fh.tell()
            length = page.jpeg_if_length or end - page.jpeg_if_offset
            fh.seek(page.jpeg_if_offset)
            arr = _decode_jpeg_block(fh.read(length), page)
            return arr[: page.length, : page.width]
        out_shape = (page.length, page.width) if spp == 1 else (page.length, page.width, spp)
        out = np.empty(out_shape, dtype=page.dtype)
        if page.is_tiled:
            tw, tl = page.tile_width, page.tile_length
            ntx = -(-page.width // tw)
            i = 0
            for ty in range(-(-page.length // tl)):
                for tx in range(ntx):
                    fh.seek(page.tile_offsets[i])
                    data = fh.read(page.tile_counts[i])
                    tile = self._decode_block(data, page, tl, tw)
                    y0, x0 = ty * tl, tx * tw
                    ys = min(tl, page.length - y0)
                    xs = min(tw, page.width - x0)
                    out[y0 : y0 + ys, x0 : x0 + xs] = tile[:ys, :xs]
                    i += 1
        else:
            rps = page.rows_per_strip or page.length
            y = 0
            for off, cnt in zip(page.strip_offsets, page.strip_counts):
                rows = min(rps, page.length - y)
                fh.seek(off)
                data = fh.read(cnt)
                out[y : y + rows] = self._decode_block(data, page, rows, page.width)
                y += rows
        return out


def read_tiff_page(img_path, page_id: int, series_id: int = 0) -> np.ndarray:
    """Read a single TIFF page (reference: shared_modules/utils.py:69-72)."""
    with TiffFile(img_path) as tf:
        return tf.series[series_id].pages[page_id].asarray()


# -- writer -------------------------------------------------------------------


class MemmapWriter:
    """Contiguous uncompressed BigTIFF with a preallocated TCZYX plane chain.

    Usage mirrors the reference's ``tif.memmap`` path (__main__.py:116-132):

    >>> mm = MemmapWriter(path, shape=(1, C, Z, H, W), dtype=np.uint16,
    ...                   description=ome_xml_string)
    >>> mm[0, c, z] = plane
    >>> mm.flush(); mm.close()
    """

    def __init__(self, path, shape: Tuple[int, ...], dtype, description: str = ""):
        if len(shape) != 5:
            raise ValueError("expected 5-D (T, C, Z, Y, X) shape")
        self._path = Path(path)
        self._shape = tuple(int(s) for s in shape)
        self._dtype = np.dtype(dtype)
        t, c, z, h, w = self._shape
        npages = t * c * z
        plane_bytes = h * w * self._dtype.itemsize
        desc_bytes = description.encode("utf-8") + b"\0"

        bo = "<"
        sample_format = {"u": 1, "i": 2, "f": 3}[self._dtype.kind]

        def tag(tid, typ, cnt, value) -> bytes:
            payload = struct.pack(bo + _TYPE_FMT[typ] * (cnt if isinstance(value, (list, tuple)) else 1),
                                  *(value if isinstance(value, (list, tuple)) else [value]))
            return struct.pack(bo + "HHQ", tid, typ, cnt) + payload.ljust(8, b"\0")

        ntags_first = 11
        ntags_rest = 10
        ifd_size_first = 8 + ntags_first * 20 + 8
        ifd_size_rest = 8 + ntags_rest * 20 + 8
        header_size = 16
        desc_off = header_size
        ifd0_off = desc_off + len(desc_bytes)
        ifd0_off += (-ifd0_off) % 8
        data_off = ifd0_off + ifd_size_first + (npages - 1) * ifd_size_rest
        data_off += (-data_off) % 16
        self._data_offset = data_off

        with open(self._path, "wb") as fh:
            fh.write(b"II" + struct.pack(bo + "HHHQ", 43, 8, 0, ifd0_off))
            fh.write(desc_bytes)
            fh.write(b"\0" * (ifd0_off - fh.tell()))
            for p in range(npages):
                first = p == 0
                tags = [
                    tag(_T_WIDTH, 4, 1, w),
                    tag(_T_LENGTH, 4, 1, h),
                    tag(_T_BITS, 3, 1, self._dtype.itemsize * 8),
                    tag(_T_COMPRESSION, 3, 1, 1),
                    tag(_T_PHOTOMETRIC, 3, 1, 1),  # minisblack
                ]
                if first:
                    tags.append(struct.pack(bo + "HHQQ", _T_DESCRIPTION, 2, len(desc_bytes), desc_off))
                tags += [
                    tag(_T_STRIP_OFFSETS, 16, 1, data_off + p * plane_bytes),
                    tag(_T_SPP, 3, 1, 1),
                    tag(_T_ROWS_PER_STRIP, 4, 1, h),
                    tag(_T_STRIP_COUNTS, 16, 1, plane_bytes),
                    tag(_T_SAMPLE_FORMAT, 3, 1, sample_format),
                ]
                tags.sort(key=lambda b: struct.unpack(bo + "H", b[:2])[0])
                this_size = ifd_size_first if first else ifd_size_rest
                next_ifd = fh.tell() + this_size if p < npages - 1 else 0
                fh.write(struct.pack(bo + "Q", len(tags)))
                fh.write(b"".join(tags))
                fh.write(struct.pack(bo + "Q", next_ifd))
            fh.write(b"\0" * (data_off - fh.tell()))
            fh.truncate(data_off + npages * plane_bytes)

        self._mm = np.memmap(self._path, dtype=self._dtype, mode="r+",
                             offset=data_off, shape=self._shape)

    def __setitem__(self, idx, value):
        self._mm[idx] = value

    def __getitem__(self, idx):
        return self._mm[idx]

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    def flush(self):
        self._mm.flush()

    def close(self):
        self._mm.flush()
        del self._mm
