"""The port imports neither JAX (nor flax, optax) nor the JAX package, and
needs no cv2 (the GPU host has none).

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
import importlib, os, sys
for banned in ("jax", "jaxlib", "flax", "optax", "fasterseg_tpu",
               *os.environ.get("ALSO_BANNED", "").split()):
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


_EVAL_MODULES = ["fasterseg_tpu_torch.eval", "fasterseg_tpu_torch.eval.metrics",
                 "fasterseg_tpu_torch.eval.evaluator",
                 "fasterseg_tpu_torch.data", "fasterseg_tpu_torch.data.datasets",
                 "fasterseg_tpu_torch.data.preprocess",
                 "fasterseg_tpu_torch.data.procgen"]

_NO_CV2 = """
import numpy as np
from fasterseg_tpu_torch.data import datasets, preprocess, procgen
assert not preprocess._HAS_CV2 and not datasets._HAS_CV2
img, label = procgen.render_scene(0, 0, (32, 64))
assert preprocess._resize(img, (48, 24), nearest=False).shape == (24, 48, 3)
try:
    procgen.write_dataset("unused", n_train=1, n_val=1, hw=(8, 16))
except ImportError as e:
    assert "cv2" in str(e)
else:
    raise AssertionError("write_dataset ran without cv2")
print("ok")
"""


def test_eval_and_data_import_without_cv2():
    """Every module of the eval slice imports where cv2 cannot be imported
    (and JAX neither); the eval preprocessing then takes its numpy fallback
    and write_dataset raises."""
    names = _modules()
    assert set(_EVAL_MODULES) <= set(names)
    env = dict(os.environ, ALSO_BANNED="cv2")
    out = subprocess.run([sys.executable, "-c", _PROBE, *names], cwd=REPO,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", str(len(names))]
    out = subprocess.run([sys.executable, "-c",
                          "import sys; sys.modules['cv2'] = None\n" + _NO_CV2],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok"]


_TRAIN_MODULES = ["fasterseg_tpu_torch.train", "fasterseg_tpu_torch.train.loss",
                  "fasterseg_tpu_torch.train.loop",
                  "fasterseg_tpu_torch.train.driver",
                  "fasterseg_tpu_torch.data.loader",
                  "fasterseg_tpu_torch.data.native",
                  "fasterseg_tpu_torch.utils.checkpoint",
                  "fasterseg_tpu_torch.utils.logging",
                  "fasterseg_tpu_torch.utils.visualize",
                  "fasterseg_tpu_torch.cli.train", "fasterseg_tpu_torch.cli.eval"]

_TRAIN_NO_CV2 = """
import numpy as np
from fasterseg_tpu_torch.data import preprocess, native
from fasterseg_tpu_torch.data.procgen import render_scene
assert not preprocess._HAS_CV2
img, label = render_scene(0, 0, (48, 96))
pre = preprocess.TrainPre((0.5,) * 3, (0.25,) * 3, (32, 64))
x, y = pre(np.random.default_rng(0), img, label)
assert x.shape == (32, 64, 3) and y.shape == (32, 64)
print("ok", pre.uses_native())
"""


def test_train_modules_import_without_jax_and_cv2():
    """The training slice's modules are among those the probes above import
    with JAX, the JAX package and cv2 banned; TrainPre runs without cv2 on
    the native kernels (g++ builds them here)."""
    assert set(_TRAIN_MODULES) <= set(_modules())
    out = subprocess.run([sys.executable, "-c",
                          "import sys; sys.modules['cv2'] = None\n"
                          + _TRAIN_NO_CV2],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "True"]
