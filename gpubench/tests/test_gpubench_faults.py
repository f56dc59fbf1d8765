"""The comparison that decides `correct` fails what it must.

The control: the reference computed in the precision below the stated one,
judged in the program's place, comes out not correct in every cell. Faults
planted under the timed path (the harness's look for a card skipped, the
rest of a run driven on the CPU at a tiny size) come out not correct too:
a served class map altered where it is made; an evaluation's hist altered
where it is made; a training step that leaves its state unchanged; a step
on half the batch, the mean taken over the rest. The cells run on one card,
so no exchange between cards exists to leave out."""

import numpy as np
import pytest
import torch

from .rehearse import run_cell, tiny_root

CELLS = ("student-stream-graph", "student-stream-eager", "student-eval-fp32",
         "teacher-train", "teacher-stream-graph")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


def _judged(root, cell, **kw):
    code, last, _ = run_cell(root, cell, **kw)
    assert code == 0
    return last


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    assert _judged(root, cell)["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    assert _judged(root, cell, control=True)["correct"] is False


@pytest.mark.parametrize("cell", ["student-stream-graph",
                                  "student-stream-eager",
                                  "teacher-stream-graph"])
def test_altered_class_map_is_not_correct(root, cell, monkeypatch):
    from fasterseg_tpu_torch.models.infer import InferenceRunner
    real = InferenceRunner.classmap

    def altered(self, x):
        y = real(self, x).clone()
        y[..., :4, :] = (y[..., :4, :] + 1) % self.plan.num_classes
        return y
    monkeypatch.setattr(InferenceRunner, "classmap", altered)
    assert _judged(root, cell)["correct"] is False


def test_altered_hist_is_not_correct(root, monkeypatch):
    from fasterseg_tpu_torch.eval import evaluator
    real = evaluator.Evaluator.run

    def altered(self, *a, **kw):
        r = real(self, *a, **kw)
        h = r.hist.copy()
        i = int(np.argmax(np.diag(h)))
        h[i, i] -= 4
        h[i, (i + 1) % h.shape[0]] += 4
        r.hist = h
        return r
    monkeypatch.setattr(evaluator.Evaluator, "run", altered)
    assert _judged(root, "student-eval-fp32")["correct"] is False


def test_step_leaving_its_state_unchanged_is_not_correct(root, monkeypatch):
    from fasterseg_tpu_torch.train import driver as session_module
    real = session_module.train_step

    def unchanged(state, *a, **kw):
        before = [p.detach().clone() for p in state.model.parameters()]
        out = real(state, *a, **kw)
        with torch.no_grad():
            for p, b in zip(state.model.parameters(), before):
                p.copy_(b)
        return out
    monkeypatch.setattr(session_module, "train_step", unchanged)
    assert _judged(root, "teacher-train")["correct"] is False


def test_step_on_half_the_batch_is_not_correct(root, monkeypatch):
    from fasterseg_tpu_torch.train import driver as session_module
    real = session_module.train_step

    def half(state, images, labels, *a, **kw):
        n = images.shape[0] // 2
        return real(state, images[:n], labels[:n], *a, **kw)
    monkeypatch.setattr(session_module, "train_step", half)
    assert _judged(root, "teacher-train")["correct"] is False
