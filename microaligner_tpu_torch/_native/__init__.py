"""Native (C++) TIFF codec kernels with Python fallbacks.

Copied from ``microaligner_tpu/_native/__init__.py`` (which imports no JAX),
with two changes:

* the library is built at first use (``build()``), not at import, into the git-ignored
  ``microaligner_tpu_torch/_build/`` under a name that holds a hash of the
  source, so an edited source rebuilds and an unchanged one is reused;
* the build is atomic (a temporary file, then ``os.replace``), so processes
  that import and use this package side by side never load half a file.

Without ``g++`` the codec falls back to numpy/Python implementations, as in
the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["codec", "build"]

_HERE = Path(__file__).parent
_SRC = _HERE / "tiffcodec.cpp"
BUILD_DIR = _HERE.parent / "_build"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded = False
_LIB = None
_ZSTD = None


def build() -> Path:
    """Compile ``tiffcodec.cpp`` into ``_build/`` unless it is already built;
    returns the library's path.  Raises when ``g++`` fails."""
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libtiffcodec_{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    return so


def _load_codec():
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.lzw_decode.restype = ctypes.c_long
    lib.lzw_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
    lib.packbits_decode.restype = ctypes.c_long
    lib.packbits_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
    for fn in (lib.undo_hpredict_u8, lib.undo_hpredict_u16, lib.undo_hpredict_u32):
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long]
    return lib


def _load_zstd():
    """System libzstd via ctypes (CPython <3.14 has no stdlib zstd)."""
    for name in ("libzstd.so.1", "libzstd.so"):
        try:
            z = ctypes.CDLL(name)
            break
        except OSError:
            z = None
    if z is None:
        return None
    try:
        z.ZSTD_decompress.restype = ctypes.c_size_t
        z.ZSTD_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
        ]
        z.ZSTD_compress.restype = ctypes.c_size_t
        z.ZSTD_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_int,
        ]
        z.ZSTD_compressBound.restype = ctypes.c_size_t
        z.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        z.ZSTD_isError.restype = ctypes.c_uint
        z.ZSTD_isError.argtypes = [ctypes.c_size_t]
    except AttributeError:
        return None
    return z


def _libs():
    """(codec library or None, libzstd or None), loaded on first use."""
    global _loaded, _LIB, _ZSTD
    with _lock:
        if not _loaded:
            _LIB = _load_codec()
            _ZSTD = _load_zstd()
            _loaded = True
    return _LIB, _ZSTD


class _Codec:
    """Decode kernels (native when available).  ``native`` and
    ``zstd_available`` load the libraries on first access."""

    @property
    def native(self) -> bool:
        return _libs()[0] is not None

    @property
    def zstd_available(self) -> bool:
        return _libs()[1] is not None

    @staticmethod
    def lzw_decode(data: bytes, expected: int) -> bytes:
        lib = _libs()[0]
        if lib is not None:
            out = ctypes.create_string_buffer(expected)
            n = lib.lzw_decode(data, len(data), out, expected)
            if n < 0:
                raise ValueError("malformed LZW stream")
            return out.raw[:n]
        return _py_lzw_decode(data, expected)

    @staticmethod
    def packbits_decode(data: bytes, expected: int) -> bytes:
        lib = _libs()[0]
        if lib is not None:
            out = ctypes.create_string_buffer(expected)
            n = lib.packbits_decode(data, len(data), out, expected)
            return out.raw[:n]
        return _py_packbits_decode(data, expected)

    @staticmethod
    def zstd_decode(data: bytes, expected: int) -> bytes:
        """Decompress one zstd-compressed TIFF strip/tile (COMPRESSION 50000,
        as written by tifffile/imagecodecs — shared_modules/utils.py:69-72
        reads such inputs through tifffile)."""
        z = _libs()[1]
        if z is None:
            raise ValueError(
                "zstd-compressed TIFF but libzstd is not available on this system"
            )
        out = ctypes.create_string_buffer(expected)
        n = z.ZSTD_decompress(out, expected, data, len(data))
        if z.ZSTD_isError(n):
            raise ValueError("malformed zstd stream in TIFF block")
        return out.raw[:n]

    @staticmethod
    def zstd_encode(data: bytes, level: int = 3) -> bytes:
        """Compress (used by tests to build zstd fixtures without tifffile)."""
        z = _libs()[1]
        if z is None:
            raise ValueError("libzstd is not available on this system")
        cap = z.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = z.ZSTD_compress(out, cap, data, len(data), level)
        if z.ZSTD_isError(n):
            raise ValueError("zstd compression failed")
        return out.raw[:n]

    @staticmethod
    def undo_horizontal_predictor(arr: np.ndarray) -> np.ndarray:
        """Cumulative sum along the row axis (per sample plane)."""
        a = np.ascontiguousarray(arr)
        if not a.flags.writeable:
            a = a.copy()
        rows = a.shape[0]
        stride = int(np.prod(a.shape[1:]))
        lib = _libs()[0]
        if lib is not None and a.dtype.itemsize in (1, 2, 4) and a.dtype.kind in "ui":
            fn = {1: lib.undo_hpredict_u8, 2: lib.undo_hpredict_u16, 4: lib.undo_hpredict_u32}[
                a.dtype.itemsize
            ]
            fn(a.ctypes.data, rows, stride)
            return a
        # numpy fallback: wrap-around cumsum in the unsigned domain
        return np.cumsum(a.reshape(rows, stride), axis=1, dtype=a.dtype).reshape(a.shape)


codec = _Codec()


def _py_lzw_decode(data: bytes, expected: int) -> bytes:
    """Pure-Python TIFF LZW (MSB-first, early change)."""
    CLEAR, EOI, FIRST = 256, 257, 258
    out = bytearray()
    table: list[bytes] = []
    code_bits = 9
    bitpos = 0
    nbits = len(data) * 8
    prev: bytes | None = None

    def reset():
        nonlocal table, code_bits
        table = [bytes([i]) for i in range(256)] + [b"", b""]
        code_bits = 9

    reset()
    while bitpos + code_bits <= nbits and len(out) < expected:
        byte = bitpos >> 3
        chunk = int.from_bytes(data[byte : byte + 3].ljust(3, b"\0"), "big")
        code = (chunk >> (24 - code_bits - (bitpos & 7))) & ((1 << code_bits) - 1)
        bitpos += code_bits
        if code == EOI:
            break
        if code == CLEAR:
            reset()
            prev = None
            continue
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("malformed LZW stream")
        out += entry
        prev = entry
        if len(table) == (1 << code_bits) - 1 and code_bits < 12:
            code_bits += 1
    return bytes(out[:expected])


def _py_packbits_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        b = data[i]
        i += 1
        if b < 128:
            out += data[i : i + b + 1]
            i += b + 1
        elif b != 128:
            out += data[i : i + 1] * (257 - b)
            i += 1
    return bytes(out[:expected])
