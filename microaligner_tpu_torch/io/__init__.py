"""Host I/O: self-contained TIFF/OME-TIFF stack.

The reference reads/writes via the ``tifffile`` package
(shared_modules/utils.py:69-95, __main__.py:116-132); this environment does
not ship it, so the framework carries its own implementation:

* ``tiff.TiffFile``    — classic + BigTIFF reader (strips/tiles; none, LZW,
  deflate, PackBits compression; horizontal predictor), one page at a time.
* ``tiff.MemmapWriter``— contiguous BigTIFF TCZYX writer with OME-XML in the
  first page's ImageDescription; planes are written through a numpy memmap,
  mirroring the reference's ``tif.memmap`` output path.
* a C++ codec (``_native/tiffcodec.cpp``) accelerates LZW/PackBits decode,
  with a pure-Python fallback.

Copied from ``microaligner_tpu/io/__init__.py``, which imports no JAX, with its
imports rewritten to this package (importing anything under
``microaligner_tpu`` would run its ``__init__``, which imports JAX).
"""

from microaligner_tpu_torch.io.tiff import MemmapWriter, TiffFile, read_tiff_page

__all__ = ["TiffFile", "MemmapWriter", "read_tiff_page"]
