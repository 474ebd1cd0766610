"""The port's copy of ``io/ome.py`` against the JAX package's.

Every case of ``tests/test_ome_meta.py`` runs once more against the port
(that file's source compiled with its imports pointed at the port), and
``create_new_meta`` returns the same OME-XML byte for byte as the JAX
package's, in each of its four modes.
"""

import pytest

from microaligner_tpu.io import ome as jome
from microaligner_tpu_torch.io import ome as tome
from test_torch_io_tiff import port_copy_of

_CASES = port_copy_of("test_ome_meta.py")
TestPortHelpers = _CASES["TestHelpers"]
TestPortCreateNewMeta = _CASES["TestCreateNewMeta"]

_xml = _CASES["_xml"]


def _stack():
    return _xml(size_c=4, channels=("c01 DAPI", "c01 Cy5", "c02 DAPI", "c02 Cy5"), size_z=3)


@pytest.mark.parametrize("in_stack,out_stack", [(True, True), (False, True), (True, False), (False, False)])
def test_create_new_meta_byte_equal(in_stack, out_stack):
    metas = ({1: _stack(), 2: _stack()} if in_stack
             else {1: _xml(size_z=3), 2: _xml(channels=("DAPI", "GFP"), size_z=3)})
    want = jome.create_new_meta({k: jome.str_to_xml(tome.xml_to_string(v)) for k, v in metas.items()},
                                (70, 80), in_stack, out_stack)
    got = tome.create_new_meta(metas, (70, 80), in_stack, out_stack)
    assert got == want
    assert all(isinstance(v, str) and v for v in got.values())
