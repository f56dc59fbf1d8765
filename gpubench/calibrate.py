"""Readings of a cell's comparison over many seeds, in one process.

    python3 gpubench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--plant half_batch --plant-seeds 7,8,9] \
        [--seconds 2] [--trace-seeds 1] [--out FILE]

Runs the cell once per seed as `run.py` does (set-up, window, check), then
once per control seed with the reference in the precision below the stated
one judged in the program's place, then once per plant seed with a fault
planted under the program (`half_batch`: the training step on half of the
batch, the mean taken over the rest), and prints each run's result line,
tagged with its seed and what it ran. The limits in each
traffic file's `check` are set from these readings: above the largest that
the program's runs give, below the smallest that the control gives. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def _plant(name):
    """Plant a fault under the port; returns the undo."""
    from fasterseg_tpu_torch.train import driver as session_module
    real = session_module.train_step
    if name != "half_batch":
        raise SystemExit(f"unknown plant {name!r}")

    def half(state, images, labels, *a, **kw):
        n = images.shape[0] // 2
        return real(state, images[:n], labels[:n], *a, **kw)
    session_module.train_step = half
    return lambda: setattr(session_module, "train_step", real)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--trace-seeds", type=_seeds, default=[])
    p.add_argument("--plant", default=None)
    p.add_argument("--plant-seeds", type=_seeds, default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from gpubench import run
    runs = ([(s, False, None) for s in args.seeds]
            + [(s, True, None) for s in args.control_seeds]
            + [(s, False, args.plant) for s in args.plant_seeds])
    out = open(args.out, "a") if args.out else None
    code = 0
    try:
        for seed, control, plant in runs:
            buf = io.StringIO()
            argv_run = ["--workload", args.workload, "--seed", str(seed),
                        "--seconds", str(args.seconds), "--trace",
                        "1" if seed in args.trace_seeds and not control
                        else "0"]
            undo = _plant(plant) if plant else None
            try:
                with contextlib.redirect_stdout(buf):
                    rc = run.main(argv_run, control=control,
                                  t_start=time.perf_counter())
            finally:
                if undo is not None:
                    undo()
            lines = buf.getvalue().strip().splitlines()
            line = {"workload": args.workload, "seed": seed,
                    "control": control, "plant": plant, "rc": rc,
                    "result": json.loads(lines[-1]) if rc == 0 else None}
            text = json.dumps(line)
            print(text, flush=True)
            if out is not None:
                out.write(text + "\n")
                out.flush()
            code = code or rc
    finally:
        if out is not None:
            out.close()
    return code


if __name__ == "__main__":
    sys.exit(main())
