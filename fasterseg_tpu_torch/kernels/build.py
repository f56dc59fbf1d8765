"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C function and is compiled on first use
into its own shared library,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o build/<name>-<hash>.so csrc/<name>.cu

where <hash> covers the source and the flags, so an edited source builds
anew and an unchanged one is loaded from `fasterseg_tpu_torch/build/`.
`build_all` starts one nvcc per source at once and waits for all of them.
nvcc's output (with the -Xptxas=-v register and shared-memory report) is kept
beside each library as `<name>-<hash>.log`. A failed build or load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Optional, Tuple

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")
SOURCES = ("conv3x3_bn_relu", "upsample8_argmax")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's kernels need the CUDA toolkit to build")
    return path


def lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD, f"{name}-{digest.hexdigest()[:16]}.so")


def _build_one(nvcc: str, name: str) -> Tuple[float, Optional[str]]:
    """Compile csrc/<name>.cu unless its library exists; returns (seconds,
    None) or (seconds, the error report)."""
    out = lib_path(name)
    if os.path.exists(out):
        return 0.0, None
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    with open(out[:-3] + ".log", "w") as log:
        rc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT).returncode
    seconds = time.perf_counter() - t0
    if rc != 0:
        with open(out[:-3] + ".log") as f:
            return seconds, f"{name} (nvcc exit {rc}):\n{f.read()}"
    os.replace(tmp, out)
    return seconds, None


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Build every missing library, one nvcc per source, all at once;
    returns the seconds each build took (0.0 for one already built)."""
    os.makedirs(BUILD, exist_ok=True)
    nvcc = nvcc_path()
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        results = dict(zip(names, pool.map(lambda n: _build_one(nvcc, n),
                                           names)))
    failed = [err for _, err in results.values() if err]
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {name: seconds for name, (seconds, _) in results.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(lib_path(name))
            _libs[name] = lib
        return lib
