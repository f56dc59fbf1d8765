"""The benchmark's frozen FLOP count and bounds."""

import json
import os

import pytest

from gpubench import flops
from gpubench.reference.plan import build_plan

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _plan(name):
    with open(os.path.join(REPO, "gpubench", "configs", f"{name}.json")) as f:
        return build_plan(json.load(f))


@pytest.mark.parametrize("name,hw,gflop", [
    ("fasterseg-student", (1024, 2048), 55.54),
    ("fasterseg-teacher", (1024, 2048), 215.56),
    ("fasterseg-teacher", (512, 1024), 53.89)])
def test_plan_flops_pinned(name, hw, gflop):
    assert round(flops.plan_flops(_plan(name), hw) / 1e9, 2) == gflop


@pytest.mark.parametrize("name", ["fasterseg-student", "fasterseg-teacher"])
def test_plan_flops_equals_the_port_count(name):
    from fasterseg_tpu_torch.utils.flops import plan_flops
    from gpubench import harness
    with open(os.path.join(REPO, "gpubench", "configs", f"{name}.json")) as f:
        c = json.load(f)
    assert flops.plan_flops(build_plan(c)) == plan_flops(
        harness.program_plan(c))


def test_student_runs_forty_3x3_convs():
    """The port's conv kernel launches once a 3x3 conv: 40 a student
    forward (PERF.md's 72 + 8 over a .logits and a .classmap)."""
    assert len(flops.convs3x3(_plan("fasterseg-student"), (1024, 2048))) == 40


def test_bounds():
    # a 256x512 64->64 bf16 conv is bound by its bytes: 0.0101 ms (PERF.md)
    b = flops.conv_bound_s(256, 512, 64, 64, 3, 1, 2)
    assert abs(b * 1e3 - 0.0101) < 0.0005
    # the fused upsample at 1024x2048, 19 classes, bf16: 0.0029 ms (bytes)
    u = flops.upsample_bound_s(128, 256, 19, 1024, 2048, 2)
    assert abs(u * 1e3 - 0.00288) < 0.0001
