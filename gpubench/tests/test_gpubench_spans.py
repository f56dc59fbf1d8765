"""The per-layer metrics that read the port's spans and counters
(`gpubench/spans.py`): a traced window's idle gap is named by the program's
span; off the card each reads None; from a recorder filled by hand each
reads its total a unit."""

import json
import os
import time
import types

import pytest

from fasterseg_tpu_torch.utils import profiling
from gpubench import run, trace

from .rehearse import REPO

# metric -> (the spans it sums, units of its cell's traced sub-window)
SPAN_METRICS = {
    "cells_host_ms.eager": (("infer.cells",), 50),
    "aggregate_host_ms.eager": (("infer.aggregate",), 50),
    "head_host_ms.eager": (("infer.head", "infer.upsample"), 50),
    "upload_host_ms.eval": (("eval.upload",), 8),     # self: less eval.copy
    "forward_host_ms.eval": (("eval.forward",), 8),
    "readback_host_ms.eval": (("eval.readback",), 8),
    "forward_host_ms.train": (("train.forward",), 5),
    "loss_host_ms.train": (("train.loss",), 5),
    "backward_host_ms.train": (("train.backward",), 5),
    "optimizer_host_ms.train": (("train.optimizer",), 5),
}
SELF_METRICS = {"upload_host_ms.eval"}
# span -> (its child span, ms the child takes in each)
CHILDREN = {"eval.upload": ("eval.copy", 0.75)}
# metric -> (the counter it reads, MB a byte, units)
COUNTER_METRICS = {"upload_mb.eval": ("eval.upload_bytes", 1e-6, 8)}
NEW = sorted(SPAN_METRICS) + sorted(COUNTER_METRICS)
STAGES = sorted({s for spans, _ in SPAN_METRICS.values() for s in spans})


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _out(units, device_type="cuda"):
    return types.SimpleNamespace(device_type=device_type,
                                 trace=types.SimpleNamespace(units=units))


def test_the_benchmark_lists_each_new_metric_for_its_one_cell():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["better"] == "lower" and len(m["workloads"]) == 1
        assert m["source"] == ("program_counter" if name in COUNTER_METRICS
                               else "program_span")


def test_a_traced_gap_is_named_by_the_programs_span():
    def unit(i):
        with profiling.span("stage.sleep"):
            time.sleep(0.02)

    t = trace.profile(unit, 1, lambda: None)
    assert t.units == 1 and t.n_ops == 0
    (name, seconds), = t.top_gaps()
    assert name == "stage.sleep" and seconds >= 0.019


@pytest.mark.parametrize("name", NEW)
def test_off_the_card_it_reads_none(name):
    read = run._reader(REPO, name)
    with profiling.recording():
        for stage in STAGES:
            with profiling.span(stage):
                pass
        profiling.count("eval.upload_bytes", 10)
    assert read(_out(5, "cpu")) is None
    assert read(types.SimpleNamespace(device_type="cuda", trace=None)) is None
    assert read(_out(5)) is not None


@pytest.mark.parametrize("name", NEW)
def test_a_port_without_spans_reads_none(name, monkeypatch):
    """Over a checkout of the port from before its spans (no `summary`),
    every new metric reads None and raises nothing."""
    read = run._reader(REPO, name)
    with profiling.recording():
        for stage in STAGES:
            with profiling.span(stage):
                pass
        profiling.count("eval.upload_bytes", 10)
    monkeypatch.delattr(profiling, "summary")
    assert read(_out(5)) is None


@pytest.mark.parametrize("name", NEW)
def test_it_reads_the_recorders_total_a_unit(name, monkeypatch):
    """Spans of known lengths on a fake clock (an upload with its copy
    inside), and a counter, beside spans and counters the metric does not
    read; nothing read before they are recorded."""
    read = run._reader(REPO, name)
    units = (SPAN_METRICS.get(name) or COUNTER_METRICS[name])[-1]
    assert read(_out(units)) is None
    now = [0]
    monkeypatch.setattr(profiling, "_clock", lambda: now[0])
    lengths_ms = (1.5, 2.25, 4.0)
    stages = STAGES + ["other"]
    with profiling.recording():
        for k, stage in enumerate(stages):
            for ms in lengths_ms:
                with profiling.span(stage):
                    now[0] += int((ms + k) * 1e6)
                    if stage in CHILDREN:
                        child, child_ms = CHILDREN[stage]
                        with profiling.span(child):
                            now[0] += int(child_ms * 1e6)
        profiling.count("eval.upload_bytes", 6_291_456)
        profiling.count("eval.upload_bytes", 2_097_152)
        profiling.count("other_bytes", 1)
    if name in COUNTER_METRICS:
        want = (6_291_456 + 2_097_152) * COUNTER_METRICS[name][1] / units
    else:
        want = sum(ms + stages.index(s)
                   + (CHILDREN[s][1] if s in CHILDREN
                      and name not in SELF_METRICS else 0)
                   for s in SPAN_METRICS[name][0]
                   for ms in lengths_ms) / units
    assert read(_out(units)) == pytest.approx(want, rel=1e-12)
