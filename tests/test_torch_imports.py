"""The port imports neither JAX (nor flax, optax) nor the JAX package.

Each module of fasterseg_tpu_torch, and chip_smoke.py, is imported in a
fresh interpreter in which those packages cannot be imported at all.
"""

import os
import pkgutil
import subprocess
import sys

import fasterseg_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, sys
for banned in ("jax", "jaxlib", "flax", "optax", "fasterseg_tpu"):
    sys.modules[banned] = None
for name in sys.argv[1:]:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "fasterseg_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("ok", len(sys.argv) - 1)
"""


def _modules():
    names = [fasterseg_tpu_torch.__name__]
    for info in pkgutil.walk_packages(fasterseg_tpu_torch.__path__,
                                      prefix="fasterseg_tpu_torch."):
        names.append(info.name)
    return names


def test_port_imports_without_jax():
    names = _modules()
    assert "fasterseg_tpu_torch.models.fast_body" in names
    assert "fasterseg_tpu_torch.kernels.build" in names
    out = subprocess.run([sys.executable, "-c", _PROBE, *names], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", str(len(names))]
