"""The port's copy of the TIFF / OME-TIFF stack against the JAX package's.

* Every case of ``tests/test_io_tiff.py`` runs once more against the port:
  that file's source is compiled here with its ``microaligner_tpu.`` imports
  pointed at ``microaligner_tpu_torch.``, and its test classes are collected
  under this module.  (The JPEG 2000 and WebP cases decode through cv2, as
  the JAX package does.)
* Files written by one package's ``MemmapWriter`` read back identically
  through the other's ``TiffFile``, pixels and OME-XML alike.
"""

from pathlib import Path

import numpy as np
import pytest

from microaligner_tpu.io import MemmapWriter as JWriter, TiffFile as JTiff
from microaligner_tpu_torch._native import BUILD_DIR, codec
from microaligner_tpu_torch.io import MemmapWriter, TiffFile


def port_copy_of(test_file: str) -> dict:
    """Namespace of ``tests/<test_file>`` compiled against the port."""
    path = Path(__file__).with_name(test_file)
    src = path.read_text().replace("from microaligner_tpu.", "from microaligner_tpu_torch.")
    ns = {"__name__": f"port_copy_of_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    return ns


_CASES = port_copy_of("test_io_tiff.py")
TestPortWriterReaderRoundtrip = _CASES["TestWriterReaderRoundtrip"]
TestPortReadForeignTiffs = _CASES["TestReadForeignTiffs"]
TestPortOmeParsing = _CASES["TestOmeParsing"]


def test_native_codec_builds_into_the_build_dir():
    assert codec.native
    assert list(BUILD_DIR.glob("libtiffcodec_*.so")), "no codec library under _build/"


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.float32])
@pytest.mark.parametrize("writer,reader", [(JWriter, TiffFile), (MemmapWriter, JTiff)],
                         ids=["jax-writes-port-reads", "port-writes-jax-reads"])
def test_files_cross_read(tmp_path, rng, dtype, writer, reader):
    ome = _CASES["_ome"](2, 3, 21, 34, np.dtype(dtype).name)
    data = (rng.random((1, 2, 3, 21, 34)) * 250).astype(dtype)
    path = tmp_path / "x.ome.tif"
    mm = writer(path, data.shape, dtype, description=ome)
    for c in range(2):
        for z in range(3):
            mm[0, c, z] = data[0, c, z]
    mm.close()
    with reader(path) as tf:
        assert tf.ome_metadata == ome
        s = tf.series[0]
        assert (s.shape, s.axes, s.dtype) == ((2, 3, 21, 34), "CZYX", np.dtype(dtype))
        for p in range(6):
            np.testing.assert_array_equal(tf.read_page(p), data[0, p // 3, p % 3])


def test_writers_write_the_same_bytes(tmp_path, rng):
    ome = _CASES["_ome"]()
    data = rng.integers(0, 65535, (1, 2, 3, 40, 50)).astype(np.uint16)
    paths = []
    for name, writer in (("jax", JWriter), ("port", MemmapWriter)):
        path = tmp_path / f"{name}.ome.tif"
        mm = writer(path, data.shape, np.uint16, description=ome)
        mm[0] = data[0]
        mm.close()
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
