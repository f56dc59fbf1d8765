"""fasterseg_tpu_torch CUDA kernels against their plain versions on the card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one.
The file imports neither JAX nor the JAX package, so it also runs on a GPU
host that has no JAX; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from fasterseg_tpu_torch import kernels
from fasterseg_tpu_torch.kernels import fused
from fasterseg_tpu_torch.kernels import (conv3x3_bn_relu,
                                         conv3x3_bn_relu_plain,
                                         split_weights, upsample8_argmax,
                                         upsample8_argmax_plain)
from _torch_upsample_cases import UPSAMPLE_SHAPES, upsample_inputs

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


# Ci=3 (the stem kernel in bf16, at Co = 32 and 48, an odd width and one
# wider than a block's 128 outputs), Ci/Co not multiples of the 16-channel
# chunk or the 32-channel block, odd sizes, teacher widths 192 and 384, and a
# concat width (64+32). In bf16, Ci % 16 == 0 runs the wgmma kernel: half
# chunks (Ci = 48, 16), odd and padded Co (19, 48), maps that no tile
# divides (17x33), the small maps whose K is split (16x32, 32x64), a map
# large enough for resident weights and several tiles a block (136x260),
# and both strides.
@pytest.mark.parametrize("H,W,ci,co,stride", [
    (64, 128, 3, 32, 2), (32, 64, 64, 64, 1), (16, 32, 384, 384, 1),
    (32, 64, 48, 16, 2), (8, 24, 20, 40, 1), (17, 33, 96, 64, 1),
    (17, 33, 32, 64, 2), (9, 300, 16, 19, 1), (16, 32, 256, 256, 1),
    (32, 64, 384, 384, 1), (32, 64, 192, 192, 1), (17, 33, 48, 48, 1),
    (17, 33, 192, 19, 1), (136, 260, 64, 64, 1), (136, 260, 32, 64, 2),
    (136, 260, 32, 32, 1), (64, 128, 64, 64, 2), (37, 531, 3, 48, 2),
    (64, 128, 3, 64, 2)])
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


# the refine convs' two-input form (stride 1): the student's 64+32 and
# 128+64, the teacher's 96+96, a map no tile divides, and one whose K splits
@pytest.mark.parametrize("H,W,c1,c2,co", [
    (128, 256, 64, 32, 64), (64, 128, 128, 64, 128), (17, 33, 96, 96, 96),
    (16, 32, 192, 192, 192)])
def test_conv_kernel_two_inputs(cuda_device, gen, H, W, c1, c2, co):
    x, w, s, b = _conv_args(gen, H, W, c1 + c2, co, cuda_device)
    xb = x.bfloat16()
    a, c = xb[..., :c1].contiguous(), xb[..., c1:].contiguous()
    before = kernels.launch_counts()["conv3x3_bn_relu_s1"]
    got = conv3x3_bn_relu(a, split_weights(w, (c1, c2)), s, b, x2=c)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv3x3_bn_relu_s1"] == before + 1
    # the same kernel on the concat (its chunks may be cut elsewhere, so
    # the sums may differ by an output rounding: one bf16 ulp is 2^-8)
    torch.testing.assert_close(got.float(), conv3x3_bn_relu(xb, w, s, b).float(),
                               rtol=8e-3, atol=8e-3)
    want = conv3x3_bn_relu_plain(a.float(), w, s, b, x2=c.float())
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    # fp32 activations: the wrapper concatenates for the CUDA-core kernel
    got32 = conv3x3_bn_relu(x[..., :c1].contiguous(), w, s, b,
                            x2=x[..., c1:].contiguous())
    torch.testing.assert_close(got32, conv3x3_bn_relu_plain(x, w, s, b),
                               rtol=1e-4, atol=1e-4)


# Halo mode (a block of an image split over H, a neighbour's row above and/or
# below it): every route in fp32 (the CUDA-core kernel) and bf16 (the Ci = 3
# stem kernel; the wgmma kernel with one and two inputs, resident weights
# and a split K), both strides, odd blocks at stride 2 that read the row
# below, and blocks at the image's top or bottom (one halo).
@pytest.mark.parametrize("h,W,ci,ci2,co,stride,halo", [
    (64, 128, 3, 0, 32, 2, (1, 0)), (33, 130, 3, 0, 48, 2, (1, 1)),
    (32, 64, 64, 0, 64, 1, (1, 1)), (17, 33, 32, 0, 64, 2, (1, 1)),
    (40, 64, 32, 0, 64, 2, (1, 0)), (16, 32, 64, 32, 64, 1, (1, 1)),
    (136, 260, 64, 0, 64, 1, (0, 1)), (16, 32, 256, 0, 256, 1, (1, 0)),
    (9, 300, 16, 0, 19, 1, (1, 1)), (8, 24, 20, 0, 40, 1, (0, 1))])
def test_conv_kernel_halo_mode(cuda_device, gen, h, W, ci, ci2, co, stride,
                               halo):
    top, bottom = halo
    x, w, s, b = _conv_args(gen, h + top + bottom, W, ci + ci2, co,
                            cuda_device)
    key = f"conv3x3_bn_relu_s{stride}"
    for dtype, tol in ((torch.float32, 1e-4 if stride == 1 else 2e-4),
                       (torch.bfloat16, 2e-2)):
        xd = x.to(dtype)
        xa, x2 = ((xd, None) if not ci2 else
                  (xd[..., :ci].contiguous(), xd[..., ci:].contiguous()))
        before = kernels.halo_launch_counts()[key]
        got = conv3x3_bn_relu(xa, w, s, b, stride=stride, x2=x2, halo=halo)
        torch.cuda.synchronize()
        assert kernels.halo_launch_counts()[key] == before + 1
        assert got.shape[1] == (h - 1) // stride + 1
        want = conv3x3_bn_relu_plain(xd.float(), w, s, b, stride=stride,
                                     halo=halo)
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


def test_spatial_logits_on_card_match_unsplit(cuda_device):
    """The student's fp32 logits of a 256x128 image split over two ranks
    (threads of this process sharing the card, `_torch_spatial_workers`)
    equal its unsplit logits bit for bit (the conv kernel's halo mode reads
    the rows the whole image's conv reads; the products sum in float64),
    each rank's convs in halo mode."""
    from _torch_spatial_workers import on_threads
    from fasterseg_tpu_torch.models import (DerivedNet, InferenceRunner,
                                            student_plan)
    from fasterseg_tpu_torch.parallel.spatial import Block, partition
    from fasterseg_tpu_torch.utils import init_random_
    plan = student_plan()
    runner = InferenceRunner(plan, init_random_(DerivedNet(plan), 0),
                             dtype=torch.float32, device=cuda_device)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 256, 128, 3)).astype(np.float32)).to(cuda_device)
    want = runner.logits(x)
    part = partition(256, 2, runner.row_multiple)
    kernels.reset_launch_counts()

    def rank(ex):
        lo, hi = part.block(ex.rank)
        return runner.logits(Block(x[:, lo:hi].contiguous(), part, ex)).t

    got = torch.cat(on_threads(2, rank), dim=1)
    torch.cuda.synchronize()
    assert sum(kernels.halo_launch_counts().values()) > 0
    assert torch.equal(got, want), (got - want).abs().max().item()


def test_conv_kernel_repeats_bit_for_bit(cuda_device, gen):
    """A split K adds its partial sums in a fixed order."""
    x, w, s, b = _conv_args(gen, 16, 32, 256, 256, cuda_device)
    xb, cw = x.bfloat16(), split_weights(w)
    first = conv3x3_bn_relu(xb, cw, s, b)
    for _ in range(5):
        assert torch.equal(conv3x3_bn_relu(xb, cw, s, b), first)


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
    assert torch.equal(got, want)


@pytest.mark.parametrize("h8,w8,c,out_hw", UPSAMPLE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_kernel_edge_shapes(cuda_device, gen, h8, w8, c, out_hw,
                                     dtype):
    """Both kernels round as the plain version does (H pass then W pass,
    fma(t, b, rn((1 - t) * a))), so they return its map pixel for pixel, on
    random logits as on one-hot ones."""
    onehot, rand = (torch.from_numpy(a).to(cuda_device).to(dtype)
                    for a in upsample_inputs(gen, h8, w8, c))
    before = kernels.launch_counts()["upsample8_argmax"]
    got = upsample8_argmax(onehot, out_hw)
    want = upsample8_argmax_plain(onehot, out_hw)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    got = upsample8_argmax(rand, out_hw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["upsample8_argmax"] == before + 2
    assert torch.equal(got, upsample8_argmax_plain(rand, out_hw))


@pytest.mark.parametrize("c", [1, 19, 23, 24])
def test_upsample_tile_kernel_every_channel_wins(cuda_device, c):
    """Logits that rise with the channel: every channel sets a new maximum,
    so the tile kernel's index sum holds all of its c powers of two."""
    assert fused._plan(16, 32, c, 128, 256)[0] > 0
    p8 = torch.arange(c, dtype=torch.float32, device=cuda_device) \
        .expand(1, 16, 32, c).contiguous()
    got = upsample8_argmax(p8)
    assert torch.equal(got, upsample8_argmax_plain(p8))
    assert bool((got == c - 1).all())


@pytest.mark.parametrize("h8,w8,c,out_hw", [
    s for s in UPSAMPLE_SHAPES if fused._plan(*s[:3], *(
        s[3] or (8 * s[0], 8 * s[1])))[0]])
def test_upsample_tile_kernel_equals_pixel_kernel(cuda_device, gen,
                                                  monkeypatch, h8, w8, c,
                                                  out_hw):
    """The two kernels of the source round alike: the same map, bit for
    bit, whichever the host's plan takes."""
    _, rand = upsample_inputs(gen, h8, w8, c)
    p8 = torch.from_numpy(rand).to(cuda_device).bfloat16()
    tiled = upsample8_argmax(p8, out_hw)
    monkeypatch.setattr(fused, "_plan", lambda *shape: (0, 0, 0))
    assert torch.equal(upsample8_argmax(p8, out_hw), tiled)


def test_upsample_graph_replay_repeats_bit_for_bit(cuda_device, gen):
    _, rand = upsample_inputs(gen, 32, 64, 19)
    p8 = torch.from_numpy(rand).to(cuda_device).bfloat16()
    want = upsample8_argmax(p8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        upsample8_argmax(p8)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = upsample8_argmax(p8)
    for _ in range(3):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


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


def test_quantized_runner_kernels_match_plain_on_card(cuda_device):
    """QuantizedRunner (int8 weights) through the kernels against its own
    plain path on the card, fp32, at 128x256 with seeded weights: every
    kernel launched, the runner's bars; the bf16 kernel path finite."""
    from fasterseg_tpu_torch.models import (DerivedNet, QuantizedRunner,
                                            quantize_variables, student_plan)
    from fasterseg_tpu_torch.utils import init_random_
    plan = student_plan()
    net = init_random_(DerivedNet(plan), 0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 128, 256, 3)).astype(np.float32))
    qvars, fast = quantize_variables(plan, net, dtype=torch.float32,
                                     device=cuda_device)
    plain = QuantizedRunner(plan, qvars, dtype=torch.float32,
                            device=cuda_device, fast_stem_enabled=False)
    kernels.reset_launch_counts()
    got = fast.logits(x)
    cm = fast.classmap(x)
    torch.cuda.synchronize()
    assert all(n > 0 for n in kernels.launch_counts().values())
    torch.testing.assert_close(got, plain.logits(x), rtol=5e-4, atol=5e-4)
    assert (cm == plain.classmap(x)).float().mean().item() >= 0.998
    bf16 = QuantizedRunner(plan, qvars, device=cuda_device)
    assert bool(torch.isfinite(bf16.logits(x).float()).all())
    assert bf16.classmap(x).shape == (1, 128, 256)


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


# ---- the eval slice on the card ----


def test_confusion_hist_on_card_is_exact(cuda_device, gen):
    """The card's histogram counts equal numpy's, ignore and out-of-range
    labels dropped, at a full Cityscapes frame; counting reads nothing back
    to the host."""
    from fasterseg_tpu_torch.eval import confusion_hist
    n = 19
    pred = gen.integers(0, n, (1, 1024, 2048)).astype(np.int32)
    label = gen.integers(0, n + 2, (1, 1024, 2048)).astype(np.uint8)
    label[gen.random(label.shape) < 0.1] = 255
    pred_d = torch.from_numpy(pred).to(cuda_device)
    label_d = torch.from_numpy(label).to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = confusion_hist(pred_d, label_d, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.device.type == "cuda" and got.dtype == torch.int64
    valid = label < n
    want = np.bincount(n * label[valid].astype(np.int64) + pred[valid],
                       minlength=n * n).reshape(n, n)
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("shape,out_hw", [((1, 96, 192, 19), (128, 256)),
                                          ((1, 160, 320, 19), (128, 256)),
                                          ((2, 37, 53, 5), (50, 41))])
def test_resize_halfpixel_on_card_matches_cpu(cuda_device, gen, shape, out_hw):
    from fasterseg_tpu_torch.ops.resize import resize_bilinear_halfpixel
    x = torch.from_numpy(gen.random(shape).astype(np.float32))
    want = resize_bilinear_halfpixel(x, out_hw)
    got = resize_bilinear_halfpixel(x.to(cuda_device), out_hw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


def test_resize_nearest_on_card_matches_cpu(cuda_device, gen):
    from fasterseg_tpu_torch.ops.resize import resize_nearest
    x = torch.from_numpy(gen.integers(0, 256, (2, 37, 53, 3)).astype(np.uint8))
    for out_hw in ((50, 41), (128, 256), (12, 20)):
        want = resize_nearest(x, out_hw)
        assert torch.equal(resize_nearest(x.to(cuda_device), out_hw).cpu(),
                           want)


def test_evaluator_kernel_path_agrees_with_plain(cuda_device):
    """Evaluator.run over two ProcCity scenes: the student's kernel path in
    fp32 against its plain path, at single scale and with two scales and the
    flip. d = 1/2 |hist_K - hist_P|_1 / labeled and the share of pixels on
    which the class maps differ are at most 1e-4 (the bf16 kernel path reads
    about 4e-4 at 1024x2048)."""
    from fasterseg_tpu_torch.data.procgen import ProcCity
    from fasterseg_tpu_torch.eval import Evaluator
    from fasterseg_tpu_torch.models import (DerivedNet, InferenceRunner,
                                            student_plan)
    from fasterseg_tpu_torch.utils import init_random_
    plan = student_plan()
    net = init_random_(DerivedNet(plan), 0)
    ds = [ProcCity(length=2, hw=(256, 512), seed=0)[i] for i in range(2)]
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    for kw in ({}, {"eval_scales": (0.75, 1.0), "eval_flip": True}):
        hists, maps = [], []
        for fast in (True, False):
            runner = InferenceRunner(plan, net, dtype=torch.float32,
                                     device=cuda_device,
                                     fast_stem_enabled=fast)
            ev = Evaluator(ds, 19, mean, std, runner.logits,
                           device=cuda_device, **kw)
            kernels.reset_launch_counts()
            hists.append(ev.run().hist)
            launched = kernels.launch_counts()["conv3x3_bn_relu_s1"] > 0
            assert launched == fast
            # the kernel path takes batch 1: one image a prediction
            maps.append(torch.cat([ev._predict_whole(s["data"][None])
                                   for s in ds]))
        labeled = hists[1].sum()
        assert hists[0].sum() == labeled > 0
        d = 0.5 * np.abs(hists[0] - hists[1]).sum() / labeled
        assert d <= 1e-4, d
        diff = (maps[0] != maps[1]).float().mean().item()
        assert diff <= 1e-4, diff


def _one_step(net, teacher, x, y, device, dtype):
    """One student step of copies of `net` / `teacher` on `device`, from a
    fresh optimizer; returns the loss and the floating state."""
    import copy
    from fasterseg_tpu_torch.train import TrainState, make_optimizer, train_step
    net = copy.deepcopy(net).to(device=device, dtype=dtype)
    teacher = copy.deepcopy(teacher).to(device=device, dtype=dtype)
    state = TrainState(net, make_optimizer(net.parameters()))
    m = train_step(state, x.to(device=device, dtype=dtype), y.to(device),
                   teacher, min_kept=x.shape[0] * x.shape[1] * x.shape[2] // 16)
    return float(m["loss"]), {k: v.detach().cpu().double()
                              for k, v in net.state_dict().items()
                              if v.is_floating_point()}


def test_train_step_on_card_matches_cpu(cuda_device):
    """One student step (KL from the teacher) at batch 2, 128x256: the same
    function on the card and the CPU, held in float64 (the loss to rtol
    1e-8, every tensor within atol 1e-10 + rtol 1e-8), and the fp32 loss to
    rtol 1e-4. (In fp32 the
    card's cuDNN algorithms round differently from the CPU's; train-mode BN
    at random init amplifies that to ~1e-5 on some tensors.)"""
    from fasterseg_tpu_torch.models import DerivedNet, student_plan, teacher_plan
    from fasterseg_tpu_torch.utils import init_training_
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 128, 256, 3))
                         .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 19, (2, 128, 256)))
    net = init_training_(DerivedNet(student_plan()), 1)
    teacher = init_training_(DerivedNet(teacher_plan()), 0).eval()
    card = _one_step(net, teacher, x, y, cuda_device, torch.float32)
    cpu = _one_step(net, teacher, x, y, "cpu", torch.float32)
    assert card[0] == pytest.approx(cpu[0], rel=1e-4)
    card = _one_step(net, teacher, x, y, cuda_device, torch.float64)
    cpu = _one_step(net, teacher, x, y, "cpu", torch.float64)
    assert card[0] == pytest.approx(cpu[0], rel=1e-8)
    for k, want in cpu[1].items():
        torch.testing.assert_close(card[1][k], want, rtol=1e-8, atol=1e-10,
                                   msg=k)


def test_session_evaluate_launches_conv_kernels(cuda_device):
    """TrainSession.evaluate after a step: the fp32 runner of the current
    weights launches both conv kernels (36 + 4 a student forward) and its
    hist is within 1e-4 of the plain fp32 network's."""
    import dataclasses
    from fasterseg_tpu_torch.core.config import (DataConfig,
                                                 cityscapes_student_config)
    from fasterseg_tpu_torch.data.procgen import ProcCity
    from fasterseg_tpu_torch.eval import Evaluator
    from fasterseg_tpu_torch.models import InferenceRunner
    from fasterseg_tpu_torch.train import TrainSession
    cfg = dataclasses.replace(cityscapes_student_config(), data=DataConfig(
        image_height=64, image_width=128, batch_size=2))
    assets = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
    session = TrainSession(cfg, assets, device=cuda_device)
    rng = np.random.default_rng(0)
    session.step(torch.from_numpy(rng.standard_normal((2, 64, 128, 3))
                                  .astype(np.float32)).to(cuda_device),
                 torch.from_numpy(rng.integers(0, 19, (2, 64, 128)))
                 .to(cuda_device))
    ds = [ProcCity(length=2, hw=(256, 512), seed=0)[i] for i in range(2)]
    kernels.reset_launch_counts()
    res = session.evaluate(ds)
    counts = kernels.launch_counts()
    assert counts["conv3x3_bn_relu_s1"] == 72
    assert counts["conv3x3_bn_relu_s2"] == 8
    plain = InferenceRunner(session.plans[1], session.model,
                            dtype=torch.float32, device=cuda_device,
                            fast_stem_enabled=False)
    d = cfg.data
    want = Evaluator(ds, 19, d.image_mean, d.image_std, plain.logits,
                     device=cuda_device).run()
    labeled = want.hist.sum()
    assert res.hist.sum() == labeled > 0
    assert 0.5 * np.abs(res.hist - want.hist).sum() / labeled <= 1e-4


@pytest.mark.parametrize("op_idx,stride", [(0, 2), (3, 1), (4, 2)])
def test_slim_op_on_card_matches_cpu(cuda_device, gen, op_idx, stride):
    """A slim primitive in float64, train mode then eval mode, on the card
    and on the CPU at every width pair: outputs and the moved BN rows within
    1e-10 + 1e-8 |ref|."""
    from fasterseg_tpu_torch.ops.slimmable import SLIM_OP_CLASSES
    from fasterseg_tpu_torch.utils.weights import init_training_
    wml = (4.0 / 12, 6.0 / 12, 8.0 / 12, 10.0 / 12, 1.0)
    c_out = 96 if stride == 2 else 48
    cpu = init_training_(SLIM_OP_CLASSES[op_idx](48, c_out, stride, wml), 0)
    cpu = cpu.double()
    card = SLIM_OP_CLASSES[op_idx](48, c_out, stride, wml).double()
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda_device)
    x = torch.from_numpy(gen.standard_normal((2, 16, 24, 48)))
    for i in range(5):
        for o in range(5):
            for train in (True, False):
                cpu.train(train)
                card.train(train)
                want = cpu(x, torch.tensor(i), torch.tensor(o))
                got = card(x.to(cuda_device), torch.tensor(i, device=cuda_device),
                           torch.tensor(o, device=cuda_device)).cpu()
                torch.testing.assert_close(got, want, rtol=1e-8, atol=1e-10)
    for k, v in card.state_dict().items():
        torch.testing.assert_close(v.cpu(), cpu.state_dict()[k], rtol=1e-8,
                                   atol=1e-10)


def test_search_steps_on_card_match_cpu(cuda_device):
    """An arch step and a weight step of search at a tiny size (5 layers,
    Fch 4, batch 2 at 64x128) in float64 from one state and the same draws,
    on the card and on the CPU: every tensor within 1e-10 + 1e-8 |ref|."""
    from fasterseg_tpu_torch.core.config import (DataConfig,
                                                 cityscapes_search_config)
    from fasterseg_tpu_torch.latency import LatencyLUT
    from fasterseg_tpu_torch.search import SearchEngine, draw_noise, to_device
    cfg = cityscapes_search_config(layers=5, Fch=4, data=DataConfig(
        image_height=64, image_width=128, batch_size=2, gt_down_sampling=8))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 64, 128, 3)))
    y = torch.from_numpy(rng.integers(0, 19, (2, 8, 16)))
    g = torch.Generator().manual_seed(0)
    lut = LatencyLUT(provider=lambda key: 0.01 + len(key) * 1e-3)
    states, noise = [], None
    for device in (torch.device("cpu"), cuda_device):
        e = SearchEngine(cfg, lut=lut, device=device)
        e.model.double()
        for ap in e.arch_params.values():
            for t in ap.tensors():
                t.data = t.data.double()
        e.tables = {k: v.double() for k, v in e.tables.items()}
        if noise is None:
            fw = e.forwards(False)
            noise = (e.draw_noise(fw, g),
                     {i: draw_noise(ap.ratios, e.prun_modes[i], e.nw, g)
                      for i, ap in e.arch_params.items()},
                     e.draw_noise(fw, g))
        n = to_device(noise, device)
        e.arch_step(x.to(device), y.to(device), noise=n[0],
                    latency_noise=n[1])
        e.weight_step(x.to(device), y.to(device), False, noise=n[2])
        states.append({**{k: v.cpu() for k, v in
                          e.model.state_dict().items()},
                       **{f"arch{i}.{j}": t.detach().cpu()
                          for i, ap in e.arch_params.items()
                          for j, t in enumerate(ap.tensors())}})
    for k, v in states[1].items():
        if v.is_floating_point():
            torch.testing.assert_close(v, states[0][k], rtol=1e-8,
                                       atol=1e-10, msg=k)


# ---------------------------------------------------------------- latency


def _graph_ms(fn, reps=20):
    """Device ms of one call: CUDA events around a replay of a graph of
    `reps` calls, median of 5 (chip_smoke.py's `graph_ms`)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def test_graph_slope_ms_floored_and_near_graph_ms(cuda_device, gen):
    from fasterseg_tpu_torch.latency.measure import graph_slope_ms
    x, w, scale, bias = _conv_args(gen, 256, 512, 64, 64, cuda_device)
    xb, cw = x.bfloat16(), split_weights(w)
    fn = lambda: conv3x3_bn_relu(xb, cw, scale, bias)
    slope, spread, kind = graph_slope_ms(fn, n1=4, n2=24, reps=5,
                                         floor_ms=1e-3)
    assert slope >= 1e-3 and np.isfinite(spread) and kind == "raw_minmax"
    assert abs(slope / _graph_ms(fn) - 1.0) <= 0.2


# a stride-2 op at 1/32 onto 16x32 with Co 768, a zoomed op whose convs run
# at 1/64, and the head
@pytest.mark.parametrize("key", [
    "BasicResidual2x_H32_W64_Cin384_Cout768_stride2_dilation1",
    "BasicResidual_downup_2x_H32_W64_Cin384_Cout384_stride1_dilation1",
    "head_H128_W256_Cin192_Cout19"])
def test_measured_provider_keys_on_card(cuda_device, key):
    from fasterseg_tpu_torch.latency.measure import (build_key,
                                                     measured_provider,
                                                     serving_route)
    from fasterseg_tpu_torch.utils.weights import init_random_
    kernels.reset_launch_counts()
    ms = measured_provider(device="cuda", verbose=False)(key)
    torch.cuda.synchronize()
    assert np.isfinite(ms) and ms >= 1e-3
    counts = kernels.launch_counts()
    assert counts["conv3x3_bn_relu_s1"] + counts["conv3x3_bn_relu_s2"] > 0
    # the same route in fp32 on the card against its plain version
    op = build_key(key)
    init_random_(op.module, 0)
    x = torch.randn(op.shape, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        got = serving_route(op, "cuda")(x.to(cuda_device)).cpu()
        want = serving_route(op, "cpu")(x)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_cost_model_calibrate_raises(cuda_device, monkeypatch):
    from fasterseg_tpu_torch.latency import measure
    from fasterseg_tpu_torch.latency.cost_model import H100CostModel
    fitted = H100CostModel.calibrate()
    assert np.isfinite(fitted.peak_tflops) and fitted.peak_tflops > 0

    def broken(*args, **kwargs):
        raise RuntimeError("measurement failed")

    monkeypatch.setattr(measure, "graph_slope_ms", broken)
    with pytest.raises(RuntimeError, match="measurement failed"):
        H100CostModel.calibrate()


# ---------------------------------------------------------------- self-search


def _rel(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _tiny_bf16_supernet():
    """The tiny supernet (5 layers, Fch 8, five widths, stem and head
    width 8/12) computing in bf16 on fp32 weights, its BN rows and
    statistics and its heads' 1x1 biases random; arch parameters and width
    draws from one seed."""
    from fasterseg_tpu_torch.models.supernet import (ArchParamSet, Supernet,
                                                     init_supernet)
    from fasterseg_tpu_torch.search import sample_ratios
    from _torch_search_common import randomize_bn_
    wml = (4.0 / 12, 6.0 / 12, 8.0 / 12, 10.0 / 12, 1.0)
    net = randomize_bn_(init_supernet(Supernet(
        layers=5, Fch=8, width_mult_list=wml,
        stem_head_width=((8.0 / 12, 8.0 / 12),), dtype=torch.bfloat16), 0), 1)
    ap = ArchParamSet.create(5, num_widths=len(wml))
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for t in ap.tensors():
            t.copy_(torch.randn(t.shape, generator=g))
        for head in net.heads[0].values():
            head.conv_1x1.bias.copy_(torch.randn(head.conv_1x1.bias.shape,
                                                 generator=g))
    x = torch.randn((2, 64, 128, 3), generator=g)
    ratios = sample_ratios(ap.ratios, "random", len(wml), noise=[
        torch.randint(0, len(wml), (r.shape[0],), generator=g)
        for r in ap.ratios])
    return net, ap, x, ratios


def _share_equal(a, b) -> float:
    """The share of elements of two bf16 tensors that are bit-equal."""
    assert a.dtype == b.dtype == torch.bfloat16
    return float((a.cpu() == b.cpu()).double().mean())


@pytest.mark.parametrize("train", [False, True])
def test_bf16_supernet_forward_on_card_matches_cpu(cuda_device, train):
    """A forward of the tiny supernet computing in bf16 on fp32 weights,
    on the card and on the CPU from the same weights, input and widths,
    against the CPU's bf16 and fp32 forwards. Train mode (BN on batch
    statistics): each head's logits within twice the CPU's bf16-vs-fp32
    spread (relative L2). Eval mode, where the rounding is deterministic
    (tests/test_torch_search_bf16.py holds the CPU to the JAX package's
    bf16 there at these bars): the card's logits bit-equal to the CPU's
    bf16 logits on at least 0.65 of elements, which the CPU's fp32 logits
    rounded to bf16 miss, and within 3/4 of the spread; so a card forward
    that computed in fp32 fails."""
    import copy
    from fasterseg_tpu_torch.models.supernet import ArchParamSet
    net, ap, x, ratios = _tiny_bf16_supernet()
    outs = {}
    for name, device, dtype in (("cpu32", "cpu", None),
                                ("cpu16", "cpu", torch.bfloat16),
                                ("card16", cuda_device, torch.bfloat16)):
        m = copy.deepcopy(net).to(device).train(train)
        m.dtype = dtype
        a = ArchParamSet(*([None if t is None else t.detach().to(device)
                            for t in ts] for ts in (ap.alphas, ap.betas,
                                                    ap.ratios)))
        r = [tuple(v.to(device) for v in s) for s in ratios]
        with torch.no_grad():
            outs[name] = [p.cpu() for p in m(x.to(device), 0, a.alphas,
                                             a.betas, r)]
    readings = []
    for k in range(5):
        cpu32, cpu16, card16 = (outs[n][k] for n in ("cpu32", "cpu16",
                                                     "card16"))
        spread = _rel(cpu16, cpu32)
        assert 0 < spread < 0.1 and card16.dtype == torch.bfloat16
        rel = _rel(card16, cpu16)
        shares = (_share_equal(card16, cpu16),
                  _share_equal(cpu32.to(torch.bfloat16), cpu16))
        readings.append((rel / spread, *shares))
        if train:
            assert rel <= 2 * spread, (k, rel, spread)
        else:
            assert rel <= 0.75 * spread, (k, rel, spread)
            assert shares[0] >= 0.65 > shares[1], (k, shares)
    print(f"train={train}: (card16-vs-cpu16 over the spread, bit-equal "
          f"share, fp32's share) per head: {readings}")


@pytest.mark.parametrize("case", ["stem", "cell", "head", "scale_by_8",
                                  "beta_mix"])
def test_bf16_op_on_card_rounds_as_on_cpu(cuda_device, case):
    """Each op of the bf16 supernet (eval-mode BN) on one bf16 input, on the
    card and on the CPU: the card's output bit-equal to the CPU's on at
    least 0.99 of elements (0.95 for the stem's five stacked convs), a bar
    that the same op computed in fp32 and rounded once misses on the CPU.
    The CPU's rounding points are held to the JAX package's in
    tests/test_torch_search_bf16.py."""
    import copy
    from fasterseg_tpu_torch.models import supernet
    from fasterseg_tpu_torch.ops.resize import scale_by
    net = _tiny_bf16_supernet()[0].eval()
    g = torch.Generator().manual_seed(7)
    rand = lambda *shape: torch.randn(shape, generator=g).to(torch.bfloat16)
    if case == "stem":
        fn, args = (lambda m, x: m.stems[0](x)), (rand(2, 64, 128, 3),)
    elif case == "head":
        fn = lambda m, x: m.heads[0]["head0"](x)
        args = (rand(2, 16, 32, net.heads[0]["head0"].conv_3x3.conv
                     .in_channels),)
    elif case == "cell":
        cell = net.cells["1_1"]
        alpha = torch.softmax(torch.randn(5, generator=g), -1)
        r = [(torch.tensor(i), torch.tensor(v)) for i, v in
             ((2, 0.8125), (3, 0.6), (4, 0.9))]
        fn = lambda m, x, a, *r: torch.cat([t.flatten() for t in m.cells[
            "1_1"](x, a, *r)])
        args = (rand(2, 16, 32, next(cell.parameters()).shape[1]), alpha, *r)
    elif case == "scale_by_8":
        fn, args = (lambda m, x: scale_by(x, 8)), (rand(2, 16, 32, 19),)
    else:
        fn = lambda m, a, b, w: supernet.beta_mix(a, b, w)
        args = (rand(2, 8, 16, 16), rand(2, 8, 16, 16),
                torch.softmax(torch.randn(2, generator=g), -1))
    to = lambda v, dev, f32=False: (tuple(to(t, dev, f32) for t in v)
                                    if isinstance(v, tuple) else v.to(
                                        dev, torch.float32) if f32
                                    and v.dtype == torch.bfloat16
                                    else v.to(dev))
    with torch.no_grad():
        cpu = fn(net, *args)
        card = fn(copy.deepcopy(net).to(cuda_device),
                  *(to(a, cuda_device) for a in args)).cpu()
        fp32 = fn(net, *(to(a, "cpu", True) for a in args)).to(
            torch.bfloat16)
    share, fault = _share_equal(card, cpu), _share_equal(fp32, cpu)
    bar = 0.95 if case == "stem" else 0.99
    print(f"{case}: card-vs-cpu bit-equal {share:.5f}, fp32 {fault:.5f}")
    assert share >= bar > fault, (case, share, fault)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round4_student_conv_shapes_through_the_kernels(cuda_device, gen,
                                                        dtype):
    """Every 3x3 conv shape of the JAX chain's searched student
    (evidence/self_search_r4, 8 classes, stem and head width 8/12) at
    1024x2048, read off its runner's forward on the card, through the
    kernel against its plain version: fp32 1e-4 (stride 1) / 2e-4 (stride
    2), bf16 2e-2."""
    import fasterseg_tpu_torch.models.fast_body as fast_body
    from fasterseg_tpu_torch.cli.self_search import searched_student_plan
    from fasterseg_tpu_torch.models import DerivedNet, InferenceRunner
    from fasterseg_tpu_torch.utils import init_random_
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    plan, lasts = searched_student_plan(os.path.join(
        repo, "evidence", "self_search_r4", "search", "arch_1.npz"))
    assert lasts == [2, 0] and plan.num_classes == 8
    runner = InferenceRunner(plan, init_random_(DerivedNet(plan), 0),
                             dtype=dtype, device=cuda_device)
    shapes, real = set(), fast_body.conv3x3_bn_relu

    def spy(x, w, scale, bias, stride=1, relu=True, x2=None):
        y = real(x, w, scale, bias, stride=stride, relu=relu, x2=x2)
        shapes.add((x.shape[1], x.shape[2], x.shape[3],
                    0 if x2 is None else x2.shape[3], y.shape[3], stride,
                    relu))
        return y

    fast_body.conv3x3_bn_relu = spy
    try:
        runner.classmap(torch.zeros((1, 1024, 2048, 3), device=cuda_device))
    finally:
        fast_body.conv3x3_bn_relu = real
    assert len(shapes) >= 8
    for H, W, c1, c2, co, stride, relu in sorted(shapes):
        x, w, s, b = _conv_args(gen, H, W, c1 + c2, co, cuda_device)
        want = conv3x3_bn_relu_plain(x.to(dtype).float(), w, s, b,
                                     stride=stride, relu=relu)
        xs = x.to(dtype)
        if c2:
            a, c = xs[..., :c1].contiguous(), xs[..., c1:].contiguous()
            wk = split_weights(w, (c1, c2)) if dtype == torch.bfloat16 else w
            got = conv3x3_bn_relu(a, wk, s, b, stride=stride, relu=relu,
                                  x2=c)
        else:
            got = conv3x3_bn_relu(xs, w, s, b, stride=stride, relu=relu)
        assert got.dtype == dtype
        tol = (2e-2 if dtype == torch.bfloat16
               else 1e-4 if stride == 1 else 2e-4)
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol,
                                   msg=f"{(H, W, c1, c2, co, stride)}")
