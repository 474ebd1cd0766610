"""Host-side helpers: validation, page reading, worker config.

The JAX package's ``utils`` surface (``microaligner_tpu/utils/__init__.py``),
which mirrors the reference's shared_modules surface.  The port's other
helpers (``device``, ``logging``, ``parity``) are imported from their
modules.
"""

from microaligner_tpu_torch.utils.img_checks import (
    check_img_dims_match,
    check_img_is_2d_grey,
    check_img_is_provided,
    check_input_has_proper_dimensions,
    check_number_of_input_img_paths,
)
from microaligner_tpu_torch.utils.pages import read_and_max_project_pages
from microaligner_tpu_torch.utils.workers import (
    get_worker_devices,
    set_number_of_dask_workers,
    set_number_of_workers,
)

__all__ = [
    "check_img_dims_match",
    "check_img_is_2d_grey",
    "check_img_is_provided",
    "check_input_has_proper_dimensions",
    "check_number_of_input_img_paths",
    "read_and_max_project_pages",
    "set_number_of_workers",
    "set_number_of_dask_workers",
    "get_worker_devices",
]
