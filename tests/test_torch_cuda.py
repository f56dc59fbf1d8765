"""fasterseg_tpu_torch CUDA kernels against their plain versions on the card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one.
The file imports neither JAX nor the JAX package, so it also runs on a GPU
host that has no JAX; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from fasterseg_tpu_torch import kernels
from fasterseg_tpu_torch.kernels import (conv3x3_bn_relu,
                                         conv3x3_bn_relu_plain,
                                         upsample8_argmax,
                                         upsample8_argmax_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _conv_args(gen, H, W, ci, co, device):
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return [t(gen.standard_normal((1, H, W, ci))),
            t(gen.standard_normal((3, 3, ci, co)) * 0.1),
            t(gen.random(co) + 0.5), t(gen.standard_normal(co) * 0.1)]


# Ci=3 (stem), Ci/Co not multiples of the 16-channel chunk or the 32-channel
# block, odd sizes, teacher width 384, and a concat width (64+32); in bf16,
# Ci % 16 == 0 runs the tensor-core kernel (a half chunk at Ci=48 and 16,
# an odd Co and a row wider than its 128-pixel tile included)
@pytest.mark.parametrize("H,W,ci,co,stride", [
    (64, 128, 3, 32, 2), (32, 64, 64, 64, 1), (16, 32, 384, 384, 1),
    (32, 64, 48, 16, 2), (8, 24, 20, 40, 1), (17, 33, 96, 64, 1),
    (17, 33, 32, 64, 2), (9, 300, 16, 19, 1)])
@pytest.mark.parametrize("relu", [True, False])
def test_conv_kernel_matches_plain(cuda_device, gen, H, W, ci, co, stride,
                                   relu):
    x, w, s, b = _conv_args(gen, H, W, ci, co, cuda_device)
    key = f"conv3x3_bn_relu_s{stride}"
    before = kernels.launch_counts()[key]
    got = conv3x3_bn_relu(x, w, s, b, stride=stride, relu=relu)
    want = conv3x3_bn_relu_plain(x, w, s, b, stride=stride, relu=relu)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[key] == before + 1
    # the JAX package's bars (tests/test_pallas_conv.py:33,66)
    tol = 1e-4 if stride == 1 else 2e-4
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    # bf16 activations against the fp32 plain version of the same rounded
    # inputs: bf16 output rounding plus another order of summation
    xb = x.bfloat16()
    got = conv3x3_bn_relu(xb, w, s, b, stride=stride, relu=relu)
    want = conv3x3_bn_relu_plain(xb.float(), w, s, b, stride=stride,
                                 relu=relu)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


def test_upsample_kernel_matches_plain(cuda_device, gen):
    lbl = gen.integers(0, 19, (1, 16, 32))
    onehot = np.full((1, 16, 32, 19), -5.0, np.float32)
    np.put_along_axis(onehot, lbl[..., None], 5.0, axis=-1)
    onehot = torch.from_numpy(onehot).to(cuda_device)
    before = kernels.launch_counts()["upsample8_argmax"]
    for p8 in (onehot, onehot.bfloat16()):
        torch.testing.assert_close(upsample8_argmax(p8),
                                   upsample8_argmax_plain(p8))
    assert kernels.launch_counts()["upsample8_argmax"] == before + 2
    p8 = torch.from_numpy(gen.standard_normal((1, 16, 32, 19))
                          .astype(np.float32)).to(cuda_device)
    got = upsample8_argmax(p8, out_hw=(100, 250))
    want = upsample8_argmax_plain(p8, out_hw=(100, 250))
    assert tuple(got.shape) == (1, 100, 250) and got.dtype == torch.int32
    # the Pallas kernel's bar (tests/test_pallas.py:17)
    assert (got == want).float().mean().item() >= 0.995


def test_runner_kernels_match_plain_on_card(cuda_device):
    """The student's kernel path against its plain path on the card, fp32,
    at 128x256 with seeded weights."""
    from fasterseg_tpu_torch.models import (DerivedNet, InferenceRunner,
                                            student_plan)
    from fasterseg_tpu_torch.utils import init_random_
    plan = student_plan()
    net = init_random_(DerivedNet(plan), 0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 128, 256, 3)).astype(np.float32))
    fast = InferenceRunner(plan, net, dtype=torch.float32, device=cuda_device)
    plain = InferenceRunner(plan, net, dtype=torch.float32,
                            device=cuda_device, fast_stem_enabled=False)
    kernels.reset_launch_counts()
    got = fast.logits(x)
    cm = fast.classmap(x)
    torch.cuda.synchronize()
    assert all(n > 0 for n in kernels.launch_counts().values())
    torch.testing.assert_close(got, plain.logits(x), rtol=5e-4, atol=5e-4)
    assert (cm == plain.classmap(x)).float().mean().item() >= 0.998


def test_graph_replay_matches(cuda_device):
    """A CUDA graph captured around the runner's class map (as chip_smoke.py
    times it) replays to the launch-by-launch result."""
    from fasterseg_tpu_torch.models import (DerivedNet, InferenceRunner,
                                            student_plan)
    from fasterseg_tpu_torch.utils import init_random_
    plan = student_plan()
    net = init_random_(DerivedNet(plan), 0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 128, 256, 3)).astype(np.float32)).to(cuda_device)
    runner = InferenceRunner(plan, net, device=cuda_device)
    want = runner.classmap(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        runner.classmap(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = runner.classmap(x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
