"""A checkout-shaped copy of the benchmark's data at a size the CPU holds.

`tiny_root(dst)` copies BENCHMARK.json and the data folders of gpubench/
(configs, traffic, metrics, families) under `dst`, with every traffic file cut
to a few small images; `run_cell(root, cell, ...)` runs the harness on the
CPU there and returns (exit code, the last line's JSON or None, stdout).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
DATA = ("configs", "traffic", "metrics", "families")

TINY = {
    "stream": {"height": 64, "width": 128, "frames": 2, "warmup_frames": 1,
               "trace_frames": 2, "check_frames": 2, "check_from": 2},
    # check_from 1: the kept pass is the window's first, which every window
    # holds, however loaded the host (two passes may not fit in 0.5 s)
    "eval": {"images": 2, "height": 64, "width": 128, "warmup_passes": 1,
             "trace_passes": 1, "check_from": 1},
    "train": {"batch_size": 2, "crop": [64, 128], "samples": 2,
              "sample_hw": [96, 192], "trace_steps": 1},
}


def tiny_root(dst: str) -> str:
    os.makedirs(os.path.join(dst, "gpubench"), exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    for d in DATA:
        shutil.copytree(os.path.join(REPO, "gpubench", d),
                        os.path.join(dst, "gpubench", d), dirs_exist_ok=True)
    tdir = os.path.join(dst, "gpubench", "traffic")
    for name in os.listdir(tdir):
        path = os.path.join(tdir, name)
        with open(path) as f:
            t = json.load(f)
        t.update(TINY[t["kind"]])
        with open(path, "w") as f:
            json.dump(t, f)
    return dst


def run_cell(root: str, cell: str, seed: int = 7, trace: int = 0,
             seconds: float = 0.5, control: bool = False):
    from gpubench import run
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                         str(seconds), "--trace", str(trace)], root=root,
                        device="cpu", control=control,
                        t_start=time.perf_counter())
    text = buf.getvalue()
    lines = text.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = None
    return code, last, text
