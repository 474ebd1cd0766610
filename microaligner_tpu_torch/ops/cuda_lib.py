"""Build, load and call the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``microaligner_tpu_torch/_build/`` under a name that holds a
hash of the sources and flags, so an edited source rebuilds and an unchanged
one is reused.  Nothing here runs at import time: this module only imports
``torch`` and the standard library.

Every C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``; :func:`call`
raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["build", "library", "call", "require_cuda", "check_grid"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of each entry point; the trailing pointer is the stream
SIGNATURES = {
    "ma_sample_displaced": (_P, _P, _P, _P, _I, _I, _I, _P),
    "ma_sample_displaced_multi": (_P, _P, _P, _P, _I, _I, _I, _P),
    "ma_poly_pair_m": (_P, _P, _P, _P, _P, _I, _I, _I) + (_F,) * 8 + (_P,),
    "ma_smooth5_solve": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ma_smooth_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
    "ma_update_matrices": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
}

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` into one library unless it is already built.

    Returns ``(path, compiler output)``; the output is empty when the library
    was reused.  ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and
    spills of every kernel) to a fresh build.
    """
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libma_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file
    return lib_path, proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"expected CUDA tensors, got device {dev}")
    for t in tensors[1:]:
        if t.device != dev:
            raise RuntimeError(f"tensors on different devices: {dev} and {t.device}")


def check_grid(name: str, z: int, y: int) -> None:
    """Raise unless a launch grid of ``z`` blocks along z and ``y`` along y
    fits CUDA's limit of 65535 on those axes."""
    if z > 65535 or y > 65535:
        raise ValueError(f"{name}: a grid of {z} x {y} blocks exceeds CUDA's 65535 on y and z")


def call(name: str, device: torch.device, *args) -> None:
    """Launch entry point ``name`` on ``device``'s current stream.

    Tensors are passed as pointers, Python ints as ``int`` and floats as
    ``float``; the stream is appended.  Raises if the launch was refused.
    """
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        rc = fn(*cargs, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
