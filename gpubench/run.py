"""Run one cell of the benchmark once and print its result.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything is found by name from
`BENCHMARK.json`: the cell's configuration file, its traffic file
`gpubench/traffic/<traffic>.json` (whose `kind` names the module in
`gpubench/cells/`, and whose `check` holds the comparison's limits and
control), the configuration's family module `gpubench/families/<family>.py`
(see `harness.py`) and each metric's reader `gpubench/metrics/<metric>.py`.
A new cell of a known kind is a new `workloads` entry and a traffic file; a
configuration of another architecture adds its family module.

The run makes its weights and inputs from the seed on the card, warms up,
measures for `--seconds`, with `--trace 1` then profiles a few more units,
then compares what the measured window produced with the plain reference
of its family. The last line of standard output is one JSON object:
correct, attempted, failed, metrics (end-to-end ones, or with `--trace 1`
the per-layer ones), device (and a trace's breakdown), and last the numbers
compared with their limits, which also end standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 3 and prints no result; if JAX or the JAX package is loaded once
the window has closed, with code 4.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "fasterseg_tpu")
CACHE = ".gpubench_cache"


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _load(path):
    with open(path) as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric, cell, end_to_end_names):
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in end_to_end_names


def _reader(root, name):
    from gpubench.harness import load_file
    return load_file(os.path.join(root, "gpubench", "metrics", f"{name}.py"),
                     "gpubench_metric_" + name.replace(".", "_")).read


def _cache_dirs(root):
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(root, CACHE)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None, root: str = ROOT, device=None, control: bool = False,
         t_start: float = None) -> int:
    """`device` other than None skips the look for a card (tests); `control`
    judges the reference in the precision below the stated one in the
    program's place."""
    args = _args(argv)
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    cell = _named(bench["workloads"], args.workload, "workload")
    config_entry = _named(bench["configs"], cell["config"], "config")
    config = _load(os.path.join(root, config_entry["file"]))
    traffic = _load(os.path.join(root, "gpubench", "traffic",
                                 f"{cell['traffic']}.json"))
    _cache_dirs(root)

    import torch
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            print(f"gpubench: the cell needs {cell['chips']} CUDA card(s); "
                  f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda":
        torch.empty(0, device=device)     # the allocator, before its stats
        torch.cuda.reset_peak_memory_stats(device)

    from gpubench.harness import Ctx
    ctx = Ctx(root=root, workload=cell, config=config, traffic=traffic,
              check=traffic["check"], seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=device,
              t_start=T_START if t_start is None else t_start,
              control=control)
    ctx.log(f"{cell['name']}: {config['name']} under {cell['traffic']} "
            f"({traffic['kind']}), seed {args.seed}, trace {args.trace}")
    cell_module = importlib.import_module(f"gpubench.cells.{traffic['kind']}")
    out = cell_module.run(ctx)
    out.device_type = device.type

    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    if loaded:
        print(f"gpubench: loaded in the run's process: {', '.join(loaded)}",
              file=sys.stderr)
        return 4

    e2e = [m for m in bench["end_to_end"] if _applies(m, cell, ())]
    e2e_names = {m["name"] for m in e2e}
    wanted = (e2e if not args.trace else
              [m for m in bench["per_layer"]
               if _applies(m, cell, e2e_names)])
    metrics = {}
    for m in wanted:
        value = _reader(root, m["name"])(out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    compared = {}
    for name, limit in traffic["check"]["limits"].items():
        value = out.checks.get(name)
        if value is not None and not math.isfinite(value):
            value = None
        compared[name] = {"value": value, "limit": limit}
    correct = (out.failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in compared.values()))

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if out.trace is not None:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.wall_s
        result["breakdown"] = {"device_ops": out.trace.top_ops(),
                               "idle_gaps": out.trace.top_gaps()}
    result["readings"] = dict(out.readings, **{
        k: v for k, v in out.checks.items() if k not in compared})
    result["check"] = compared
    for name, c in compared.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
