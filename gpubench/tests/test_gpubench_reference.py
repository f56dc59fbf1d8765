"""The benchmark's plain reference against the port's plain path (CPU)."""

import json
import os

import pytest
import torch

from gpubench import harness, weights
from gpubench.reference import evaluate as ref_eval
from gpubench.reference import net as ref_net
from gpubench.reference import train as ref_train
from gpubench.reference.plan import build_plan

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIGS = ("fasterseg-student", "fasterseg-teacher")


def _config(name):
    with open(os.path.join(REPO, "gpubench", "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CONFIGS)
def test_parameters_are_the_port_state_dict(name):
    from fasterseg_tpu_torch.models import DerivedNet
    c = _config(name)
    net = DerivedNet(harness.program_plan(c))
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    got = {n: tuple(s) for n, s, _ in ref_net.param_specs(build_plan(c))}
    assert got == want


@pytest.mark.parametrize("name", CONFIGS)
def test_eval_logits_match_the_port_plain_path(name):
    c = _config(name)
    plan = build_plan(c)
    w = weights.make(plan, 5, "cpu")
    _, net = harness.program_net(c, w, "cpu")
    x = torch.randn(1, 64, 128, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        port = net(x).permute(0, 3, 1, 2)
    ref = ref_net.logits(plan, w, x.permute(0, 3, 1, 2).contiguous())
    # fp32 rounding: the port resizes by fp32 matrices, the reference by
    # F.interpolate (whose CPU downsampling is ~2e-5 off the exact value)
    assert torch.allclose(port, ref, atol=1e-4, rtol=1e-4)


def test_first_train_step_matches_the_port_in_float64():
    """Loss and gradients of one teacher step; the port's resize matrices
    hold fp32 weights, so float64 agrees to ~1e-7, not to 1e-15."""
    from fasterseg_tpu_torch.models import DerivedNet
    from fasterseg_tpu_torch.train.loop import (TrainState, make_optimizer,
                                                train_step)
    c = _config("fasterseg-teacher")
    plan = build_plan(c)
    w = {k: v.double() if v.is_floating_point() else v
         for k, v in weights.make(plan, 3, "cpu").items()}
    net = DerivedNet(harness.program_plan(c)).double()
    net.load_state_dict(w)
    opt = make_optimizer(net.parameters(), 0.01, 0.9, 5e-4, 0.992, 1000)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 128, 3, generator=g, dtype=torch.float64)
    y = torch.randint(0, 19, (2, 64, 128), generator=g)
    y[:, :8] = 255
    mk = 2 * 64 * 128 // 16
    loss = float(train_step(TrainState(net, opt), x, y, min_kept=mk,
                            ignore_label=255, aux_weight=0.2,
                            num_classes=19)["loss"])
    hp = dict(lr=0.01, momentum=0.9, weight_decay=5e-4, aux_weight=0.2,
              ohem_thresh=0.7, ignore_label=255, min_kept=mk)
    ref = ref_train.run_steps(plan, w, [(x, y)], hp)
    assert abs(loss - ref["losses"][0]) <= 1e-6 * abs(loss)
    names = {id(p): n for n, p in net.named_parameters()}
    for p in net.parameters():
        g_port = opt.state[p]["momentum_buffer"] - 5e-4 * w[names[id(p)]]
        g_ref = ref["first_grads"][names[id(p)]]
        assert torch.allclose(g_port, g_ref, rtol=1e-3,
                              atol=1e-3 * float(g_ref.abs().max()) + 1e-12)


def test_ohem_keeps_the_hardest_pixels():
    logits = torch.zeros(1, 2, 1, 4)
    logits[0, 0] = torch.tensor([4.0, 2.0, 0.0, -2.0])
    labels = torch.zeros(1, 1, 4, dtype=torch.long)
    # thresh 0.5 keeps the pixels whose p(true) <= 0.5: the last two
    loss = ref_train.ohem(logits, labels, 255, 0.5, 1)
    p = torch.log_softmax(logits, 1)[0, 0, 0]
    assert torch.isclose(loss, -(p[2] + p[3]) / 2)


def test_hist_and_gap():
    pred = torch.tensor([[0, 1, 1, 2]])
    label = torch.tensor([[0, 1, 255, 1]])
    h = ref_eval.hist(pred, label, 3, 255)
    assert h.tolist() == [[1, 0, 0], [0, 1, 1], [0, 0, 0]]
    assert ref_eval.hist_distance(h, h) == 0.0
    logits = torch.tensor([[[[1.0, 0.0]], [[0.5, 2.0]]]])  # (1, 2, 1, 2)
    gap = ref_eval.classmap_gap(logits, torch.tensor([[[1, 1]]]))
    assert gap["widest"] == 0.5 and gap["flipped"] == 0.5
