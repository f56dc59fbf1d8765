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
    assert "fasterseg_tpu_torch.parallel.spatial" in names
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


_SEARCH_MODULES = ["fasterseg_tpu_torch.ops.slimmable",
                   "fasterseg_tpu_torch.latency",
                   "fasterseg_tpu_torch.latency.lut",
                   "fasterseg_tpu_torch.latency.tables",
                   "fasterseg_tpu_torch.latency.derived",
                   "fasterseg_tpu_torch.latency.estimator",
                   "fasterseg_tpu_torch.models.supernet",
                   "fasterseg_tpu_torch.search",
                   "fasterseg_tpu_torch.search.gumbel",
                   "fasterseg_tpu_torch.search.architect",
                   "fasterseg_tpu_torch.search.loop",
                   "fasterseg_tpu_torch.utils.weights",
                   "fasterseg_tpu_torch.utils.logging",
                   "fasterseg_tpu_torch.cli.train_search"]


def test_search_modules_import_without_jax():
    """The search slice's modules, among those the probes above import, on
    their own with JAX, the JAX package and cv2 banned; the reference LUT
    ships inside the package."""
    assert set(_SEARCH_MODULES) <= set(_modules())
    env = dict(os.environ, ALSO_BANNED="cv2")
    out = subprocess.run([sys.executable, "-c", _PROBE, *_SEARCH_MODULES],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", str(len(_SEARCH_MODULES))]
    from fasterseg_tpu_torch.latency.lut import REFERENCE_LUT
    assert os.path.dirname(REFERENCE_LUT) == os.path.join(
        os.path.dirname(fasterseg_tpu_torch.__file__), "latency")
    assert os.path.isfile(REFERENCE_LUT)


_LATENCY_MODULES = ["fasterseg_tpu_torch.latency.measure",
                    "fasterseg_tpu_torch.latency.cost_model",
                    "fasterseg_tpu_torch.utils.flops",
                    "fasterseg_tpu_torch.utils.profiling",
                    "fasterseg_tpu_torch.cli.latency_lut",
                    "fasterseg_tpu_torch.cli.run_latency",
                    "fasterseg_tpu_torch.cli.calibrate_latency",
                    "fasterseg_tpu_torch.cli.profile"]


class _Parsed(Exception):
    pass


def test_latency_modules_import_without_jax(monkeypatch):
    """The latency slice's modules on their own with JAX, the JAX package
    and cv2 banned; the H100 table and its calibration ship inside the
    package, and the entry points default to the card."""
    import argparse
    import inspect
    assert set(_LATENCY_MODULES) <= set(_modules())
    env = dict(os.environ, ALSO_BANNED="cv2")
    out = subprocess.run([sys.executable, "-c", _PROBE, *_LATENCY_MODULES],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", str(len(_LATENCY_MODULES))]
    from fasterseg_tpu_torch.cli import (calibrate_latency, latency_lut,
                                         profile, run_latency)
    from fasterseg_tpu_torch.latency.lut import H100_LUT
    from fasterseg_tpu_torch.utils.profiling import serving_segments, trace
    assert os.path.dirname(H100_LUT) == os.path.join(
        os.path.dirname(fasterseg_tpu_torch.__file__), "latency")
    assert os.path.isfile(H100_LUT)
    assert os.path.isfile(calibrate_latency.calibration_path(H100_LUT))
    for fn in (serving_segments, trace):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    defaults = []

    def parse(self, *args, **kwargs):
        defaults.append(self.get_default("device"))
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    for cli in (calibrate_latency, latency_lut, profile, run_latency):
        try:
            cli.main([])
        except _Parsed:
            pass
    assert defaults == ["cuda"] * 4


_INT8_STUDY_MODULES = ["fasterseg_tpu_torch.models.quantize",
                       "fasterseg_tpu_torch.cli.miou_study",
                       "fasterseg_tpu_torch.cli.int8_check",
                       "fasterseg_tpu_torch.utils.prng"]


def test_int8_and_study_modules_import_without_jax():
    """The int8 and mIoU-study modules and the JAX package's draw in numpy
    on their own, with JAX, the JAX package and cv2 banned (the GPU host
    has none of them)."""
    assert set(_INT8_STUDY_MODULES) <= set(_modules())
    env = dict(os.environ, ALSO_BANNED="cv2")
    out = subprocess.run([sys.executable, "-c", _PROBE,
                          *_INT8_STUDY_MODULES], cwd=REPO,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", str(len(_INT8_STUDY_MODULES))]


_PARALLEL_MODULES = ["fasterseg_tpu_torch.parallel",
                     "fasterseg_tpu_torch.parallel.mesh",
                     "fasterseg_tpu_torch.parallel.dryrun"]


def test_parallel_modules_and_rank_helper_import_without_jax():
    """The data-parallel modules on their own with JAX, the JAX package and
    cv2 banned, and the tests' rank helper too: spawned ranks import it
    (never tests/conftest.py, which imports JAX)."""
    assert set(_PARALLEL_MODULES) <= set(_modules())
    env = dict(os.environ, ALSO_BANNED="cv2")
    out = subprocess.run([sys.executable, "-c", _PROBE, *_PARALLEL_MODULES],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", str(len(_PARALLEL_MODULES))]
    env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.join(REPO, "tests")])
    out = subprocess.run([sys.executable, "-c", _PROBE,
                          "_torch_parallel_workers"], cwd=REPO,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "1"]
