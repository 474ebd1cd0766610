"""The port never imports JAX.  Checked in a fresh interpreter, because this
test process imports JAX itself (tests/conftest.py)."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import microaligner_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
pkg.OptFlowRegistrator, pkg.Warper, pkg.FeatureRegistrator, pkg.transform_img_with_tmat
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "microaligner_tpu.")))
print(len(names))
print(",".join(bad))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = (out.stdout.splitlines() + [""])[:2]
    # every module of the package was imported: 26 with the registration
    # path, 36 with the CLI's host layer (io, _native, pipeline, __main__),
    # 45 with the feature engine (features/, ops/affine_tiled, tiles/compat),
    # 46 with utils/device, 48 with parallel/mesh and parallel/step
    assert int(count) >= 48, out.stdout
    assert bad == "", f"port modules pulled in: {bad}"
