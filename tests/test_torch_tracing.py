"""The port's spans and counters (utils/profiling.py) on the CPU: off, they
are one shared no-op; in `recording()` they nest with parents, unit ids and
self time; under torch.profiler each main-thread span is a host event of
the profile and a worker thread's is not; and the runner, the evaluator,
the training step and the loader record the stages they name."""

import contextlib
import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from fasterseg_tpu_torch import kernels
from fasterseg_tpu_torch.core.config import (DataConfig,
                                             cityscapes_teacher_config)
from fasterseg_tpu_torch.data import InMemoryDataset, get_train_loader
from fasterseg_tpu_torch.eval import Evaluator
from fasterseg_tpu_torch.models import (DerivedNet, InferenceRunner,
                                        student_plan)
from fasterseg_tpu_torch.train import TrainSession
from fasterseg_tpu_torch.utils import profiling
from fasterseg_tpu_torch.utils.weights import init_random_
from _torch_search_common import few_threads  # noqa: F401

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
HW = (64, 128)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
INFER = {"infer.stem", "infer.cells", "infer.aggregate", "infer.head",
         "infer.upsample"}


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def runner():
    plan = student_plan()
    net = init_random_(DerivedNet(plan), 0)
    return InferenceRunner(plan, net, dtype=torch.float32, device="cpu")


def _image(seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((1, *HW, 3), generator=g)


def _by_name():
    out = {}
    for r in profiling.spans():
        out.setdefault(r.name, []).append(r)
    return out


def _unit_of(name):
    """The one span named `name`, and every span of its unit."""
    (top,) = _by_name()[name]
    return top, [r for r in profiling.spans() if r.unit == top.id]


def test_off_span_is_the_shared_noop_and_records_nothing(monkeypatch):
    """Off, no clock is read, no profiler range is entered, and nothing is
    recorded or counted."""
    def refuse(*a, **k):
        raise AssertionError("called while tracing is off")
    monkeypatch.setattr(profiling, "_clock", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = profiling.span("a")
    assert first is profiling.span("b")
    with first as entered:
        with profiling.span("c"):
            profiling.count("bytes", 10)
    assert entered is None
    s = profiling.summary()
    assert profiling.spans() == [] and s["spans"] == {} and s["counters"] == {}


def test_recording_nests_with_parents_units_and_self_time():
    with profiling.recording():
        with profiling.span("outer"):
            time.sleep(0.004)
            with profiling.span("inner"):
                time.sleep(0.01)
            with profiling.span("inner"):
                with profiling.span("leaf"):
                    time.sleep(0.002)
        with profiling.span("outer"):
            pass
    assert profiling.span("x") is profiling.span("y")     # off again
    recs = profiling.spans()
    assert [r.name for r in recs] == ["inner", "leaf", "inner", "outer",
                                      "outer"]
    inner1, leaf, inner2, outer1, outer2 = recs
    assert outer1.parent is None and outer1.unit == outer1.id
    assert inner1.parent == inner2.parent == outer1.id
    assert leaf.parent == inner2.id
    assert {r.unit for r in recs[:4]} == {outer1.id}
    assert outer2.unit == outer2.id != outer1.id
    assert {r.thread for r in recs} == {threading.get_ident()}
    for r in recs:
        assert r.end_ns >= r.start_ns
    s = profiling.summary()["spans"]
    assert s["inner"]["count"] == 2 and s["outer"]["count"] == 2
    dur = lambda r: (r.end_ns - r.start_ns) * 1e-6
    assert s["outer"]["total_ms"] == pytest.approx(dur(outer1) + dur(outer2))
    assert s["outer"]["self_ms"] == pytest.approx(
        dur(outer1) + dur(outer2) - dur(inner1) - dur(inner2))
    assert s["inner"]["self_ms"] == pytest.approx(
        dur(inner1) + dur(inner2) - dur(leaf))
    assert s["outer"]["self_ms"] >= 3.5 and s["inner"]["self_ms"] >= 9.5
    assert s["leaf"]["self_ms"] == pytest.approx(s["leaf"]["total_ms"])


def test_counters_launches_and_reset(monkeypatch):
    """Counters add up while on; launches are counted from the first span
    after a reset; reset clears everything."""
    profiling.count("off", 5)
    kernels.conv.launches[1] += 3                  # before the recording
    with profiling.recording():
        profiling.count("bytes", 100)
        profiling.count("bytes", 23)
        with profiling.span("a"):
            kernels.conv.launches[1] += 2
        kernels.fused.launches["upsample8_argmax"] += 1
    s = profiling.summary()
    assert s["counters"] == {"bytes": 123}
    assert s["launches"]["conv3x3_bn_relu_s1"] == 2
    assert s["launches"]["upsample8_argmax"] == 1
    assert s["launches"]["conv3x3_bn_relu_s2"] == 0 and s["dropped"] == 0
    kernels.reset_launch_counts()
    profiling.reset()
    s = profiling.summary()
    assert s["counters"] == {} and s["spans"] == {}
    assert set(s["launches"].values()) == {0}


def test_a_full_list_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording():
        for _ in range(5):
            with profiling.span("s"):
                pass
    assert len(profiling.spans()) == 3
    assert profiling.summary()["dropped"] == 2


def test_each_thread_opens_its_own_units():
    done = []

    def worker():
        with profiling.span("w.outer"):
            with profiling.span("w.inner"):
                done.append(threading.get_ident())

    with profiling.recording():
        with profiling.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
    assert not t.is_alive() and done
    names = _by_name()
    (w_outer,), (w_inner,), (main,) = (names["w.outer"], names["w.inner"],
                                       names["main"])
    assert w_outer.parent is None and w_outer.unit == w_outer.id != main.unit
    assert w_inner.parent == w_outer.id and w_inner.unit == w_outer.id
    assert w_outer.thread == done[0] != main.thread


def _host_events(prof):
    return [e for e in prof.events()
            if e.device_type != torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("also_recording", [False, True])
def test_profiler_sees_main_thread_spans_and_not_worker_ones(
        also_recording):
    """Under torch.profiler every main-thread span is a host event of the
    same name and duration (within 0.1 ms + 5 %); the profiler does not
    follow a thread it was not started on, so a worker thread's span is
    recorded only inside `recording()` and is never a profiler event. The
    process's first profiler range pays a one-off set-up outside the span's
    clock, so a warm-up range comes first."""
    def worker():
        with profiling.span("worker.batch"):
            time.sleep(0.003)

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("warm-up"):    # the process's first range
            pass
    profiling.reset()
    ctx = (profiling.recording() if also_recording
           else contextlib.nullcontext())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with ctx:
            with profiling.span("main.unit"):
                with profiling.span("main.stage"):
                    time.sleep(0.005)
                    torch.ones(8, 8) @ torch.ones(8, 8)
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=10)
                with profiling.span("main.stage"):
                    time.sleep(0.002)
    assert not t.is_alive()
    events = _host_events(prof)
    recs = profiling.spans()
    main = [r for r in recs if r.name.startswith("main.")]
    assert len(main) == 3
    for r in main:
        ms = (r.end_ns - r.start_ns) * 1e-6
        durs = [e.cpu_time_total / 1e3 for e in events if e.name == r.name]
        assert any(abs(d - ms) <= 0.1 + 0.05 * ms for d in durs), (r, durs)
    assert not [e for e in events if e.name == "worker.batch"]
    worker_recs = [r for r in recs if r.name == "worker.batch"]
    assert len(worker_recs) == (1 if also_recording else 0)


def test_runner_classmap_and_logits_record_the_serving_stages(runner):
    x = _image()
    with profiling.recording():
        runner.classmap(x)
    top, unit = _unit_of("infer.classmap")
    assert {r.name for r in unit} == INFER | {"infer.classmap"}
    for r in unit:
        if r is not top:
            assert r.parent == top.id, r
            assert top.start_ns <= r.start_ns <= r.end_ns <= top.end_ns
    profiling.reset()
    with profiling.recording():
        runner.logits(x)
    top, unit = _unit_of("infer.logits")
    assert {r.name for r in unit} == INFER | {"infer.logits"}


def _dataset(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"data": rng.integers(0, 256, (*HW, 3), dtype=np.uint8),
             "label": rng.integers(0, 19, HW, dtype=np.uint8)}
            for _ in range(n)]


@pytest.mark.parametrize("batch", [1, 2])
def test_evaluator_run_records_its_stages_and_upload_bytes(runner, batch):
    ds = _dataset(3)

    def forward(x):                # the runner serves one image a call
        return torch.cat([runner.logits(x[i:i + 1]) for i in range(len(x))])

    ev = Evaluator(ds, 19, MEAN, STD, forward, batch_size=batch,
                   device="cpu")
    with profiling.recording():
        res = ev.run()
    top, unit = _unit_of("eval.run")
    names = {r.name for r in unit}
    assert names == {"eval.run", "eval.upload", "eval.copy", "eval.forward",
                     "eval.score", "eval.readback", "infer.logits"} | INFER
    batches = -(-len(ds) // batch)
    counts = {n: sum(r.name == n for r in unit) for n in names}
    assert (counts["eval.upload"] == counts["eval.copy"]
            == counts["eval.forward"] == batches)
    assert counts["eval.readback"] == 1
    uploads = {r.id for r in unit if r.name == "eval.upload"}
    assert {r.parent for r in unit if r.name == "eval.copy"} == uploads
    s = profiling.summary()["spans"]
    assert s["eval.upload"]["self_ms"] == pytest.approx(
        s["eval.upload"]["total_ms"] - s["eval.copy"]["total_ms"])
    forwards = {r.id for r in unit if r.name == "eval.forward"}
    assert {r.parent for r in unit if r.name == "infer.logits"} == forwards
    # the padded tail is uploaded too: every batch holds `batch` images;
    # each batch staged once; on the CPU no copy is pending, so no
    # `eval.stage_wait`
    per_image = HW[0] * HW[1] * (3 + 1)    # uint8 image, uint8 label
    assert profiling.summary()["counters"] == {
        "eval.upload_bytes": batches * batch * per_image,
        "eval.upload_staged": batches}
    assert res.hist.sum() > 0


def _tiny_teacher():
    data = DataConfig(synthetic=True, synthetic_length=4, image_height=32,
                      image_width=64, batch_size=2)
    cfg = dataclasses.replace(cityscapes_teacher_config(), data=data,
                              niters_per_epoch=2)
    return cfg, TrainSession(cfg, ASSETS, device="cpu")


def test_train_step_records_its_stages():
    _, session = _tiny_teacher()
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 32, 64, 3), generator=g)
    y = torch.randint(0, 19, (2, 32, 64), generator=g)
    with profiling.recording():
        session.step(x, y)
    top, unit = _unit_of("train.step")
    assert {r.name for r in unit} == {"train.step", "train.forward",
                                      "train.loss", "train.backward",
                                      "train.optimizer"}
    assert {r.parent for r in unit if r is not top} == {top.id}
    s = profiling.summary()["spans"]
    assert s["train.optimizer"]["count"] == 2      # zero_grad, the update
    covered = sum(s[n]["total_ms"] for n in ("train.forward", "train.loss",
                                             "train.backward",
                                             "train.optimizer"))
    assert covered == pytest.approx(s["train.step"]["total_ms"]
                                    - s["train.step"]["self_ms"])


def test_loader_waits_on_the_main_thread_and_makes_batches_list_only():
    rng = np.random.default_rng(0)
    samples = [{"data": rng.integers(0, 256, (48, 96, 3), dtype=np.uint8),
                "label": rng.integers(0, 19, (48, 96), dtype=np.uint8),
                "fn": f"s{i}"} for i in range(4)]
    data = DataConfig(image_height=32, image_width=64, batch_size=2)
    cfg = dataclasses.replace(cityscapes_teacher_config(), data=data)
    loader = get_train_loader(cfg, InMemoryDataset.bind(samples))
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with profiling.recording():
                it = iter(loader)
                for _ in range(2):
                    next(it)
    finally:
        loader.close()
    names = _by_name()
    assert len(names["loader.wait"]) == 2
    assert {r.thread for r in names["loader.wait"]} == {
        threading.get_ident()}
    assert names["loader.make_batch"]
    assert threading.get_ident() not in {
        r.thread for r in names["loader.make_batch"]}
    host = {e.name for e in _host_events(prof)}
    assert "loader.wait" in host and "loader.make_batch" not in host
