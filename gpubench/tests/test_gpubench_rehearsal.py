"""Each cell end to end on the CPU at a tiny size, on the port's plain
versions: one JSON last line of the contract's shape; a cell added as data
alone is found by name; without a card the measurement path fails."""

import json
import os
import subprocess
import sys

import pytest

from .rehearse import REPO, run_cell, tiny_root

CELLS = ("student-stream-graph", "student-stream-eager", "student-eval-fp32",
         "teacher-train", "teacher-stream-graph")
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


def _bench(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _shape(last, trace):
    keys = list(last)
    assert keys[:5] == REQUIRED and keys[-1] == "check"
    assert set(keys) <= set(REQUIRED) | {"breakdown", "readings", "check"}
    assert ("breakdown" in keys) == bool(trace)
    assert last["device"]["platform"] == "cpu" and last["device"]["count"] == 1
    for c in last["check"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_cpu(root, cell):
    code, last, _ = run_cell(root, cell)
    assert code == 0
    _shape(last, trace=False)
    bench = _bench(root)
    want = {m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(last["metrics"]) == want
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cell_on_cpu_reports_no_device_number(root, cell):
    """The CPU has no device trace: only host-clock and span metrics come
    out, and busy_s is 0."""
    code, last, _ = run_cell(root, cell, trace=1)
    assert code == 0
    _shape(last, trace=True)
    host_only = {m["name"] for m in _bench(root)["per_layer"]
                 if cell in m["workloads"] and m["name"].startswith(
                     ("loader_wait_ms", "frame_p50_ms"))}
    assert set(last["metrics"]) == host_only
    assert last["device"]["busy_s"] == 0.0


def test_a_cell_added_as_data_is_found_by_name(root):
    bench = _bench(root)
    bench["workloads"].append({
        "name": "student-stream-graph-small", "config": "fasterseg-student",
        "traffic": "graph-stream-small", "chips": 1,
        "why": "a smaller frame through the same graph-served path"})
    for m in bench["end_to_end"]:
        if m["name"] == "fps":
            m["workloads"].append("student-stream-graph-small")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    tdir = os.path.join(root, "gpubench", "traffic")
    with open(os.path.join(tdir, "graph-stream-1024x2048.json")) as f:
        t = json.load(f)
    t.update(height=32 * 2, width=64 * 2, frames=3)
    with open(os.path.join(tdir, "graph-stream-small.json"), "w") as f:
        json.dump(t, f)
    code, last, _ = run_cell(root, "student-stream-graph-small")
    assert code == 0 and set(last["metrics"]) == {"fps", "setup_s"}


def _cli(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "gpubench", "run.py"),
         "--workload", "student-stream-graph", "--seed", "3", "--seconds",
         "1", *extra], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_without_a_card_it_fails_and_prints_no_result():
    p = _cli(REPO)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "CUDA card" in p.stderr


def test_only_the_benchmark_files_fail(tmp_path):
    """A directory with BENCHMARK.json and gpubench/ alone has no program."""
    import shutil
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(str(tmp_path))
    assert p.returncode != 0 and not p.stdout.strip()


def test_seeds_beyond_32_bits(root):
    code, last, _ = run_cell(root, "student-eval-fp32", seed=2 ** 31 + 12345)
    assert code == 0 and last["correct"] is True


@pytest.mark.cuda
def test_cells_on_the_card():
    """On a card: each cell at its own size, a short window."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for cell in CELLS:
        p = subprocess.run(
            [sys.executable, os.path.join(REPO, "gpubench", "run.py"),
             "--workload", cell, "--seed", "5", "--seconds", "2"],
            cwd=REPO, capture_output=True, text=True, timeout=900)
        assert p.returncode == 0, p.stderr[-2000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
