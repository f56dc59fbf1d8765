"""Spatial evaluation of the port on the CPU: images split over H across
ranks (fasterseg_tpu_torch/parallel/spatial.py), against whole images and
against the JAX package's spatial mesh axis.

* The partitioner, the plain conv's halo mode and every row-window resize,
  in this process: the exchange runs on threads that stand in for ranks
  (`_torch_spatial_workers.on_threads`), through the same `Exchange` code a
  process group runs.
  Bars: the halo conv and the resizes within 1e-6 of the whole map's rows.
* One spawn of two gloo ranks and one of three (an uneven partition) run
  `_torch_spatial_workers`: the student's spatial logits at 256x128 against
  the same ranks' unsplit forward (atol 1e-5) and against the JAX package's
  `model.apply` on the same weights (2e-4, tests/test_parallel.py's bar);
  the toy one-conv `Evaluator(spatial=True)` hist-exact against the JAX
  `Evaluator(spatial=True, mesh=make_mesh(8, (SPATIAL_AXIS,)))` at single
  scale and at (0.75, 1, 1.25) + flip; the student's spatial evaluation
  within hist distance 1e-4 of one process's.

`cli/eval.py --devices 2 --spatial` is tested in tests/test_torch_parallel.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasterseg_tpu.data import SyntheticDataset as JaxSyntheticDataset
from fasterseg_tpu.eval.evaluator import Evaluator as JaxEvaluator
from fasterseg_tpu.models import create_derived
from fasterseg_tpu.models import student_plan as jax_student_plan
from fasterseg_tpu.parallel import SPATIAL_AXIS as JAX_SPATIAL_AXIS
from fasterseg_tpu.parallel import make_mesh as jax_make_mesh
import _torch_spatial_workers as W
from fasterseg_tpu_torch.kernels import (conv3x3_bn_relu,
                                         conv3x3_bn_relu_plain,
                                         halo_launch_counts,
                                         reset_launch_counts)
from fasterseg_tpu_torch.models import student_plan
from fasterseg_tpu_torch.ops import resize
from fasterseg_tpu_torch.parallel import launch, spatial
from fasterseg_tpu_torch.parallel.spatial import (Block, Partition,
                                                  conv_partition, partition)
from fasterseg_tpu_torch.utils import from_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "tests", "assets")
ROW_ATOL = 1e-6                  # a block's rows against the whole map's
LOGITS_ATOL = 1e-5               # spatial vs unsplit logits, same process
JAX_TOL = 2e-4                   # tests/test_parallel.py:72-73
HIST_D = 1e-4                    # chip_smoke.py's EVAL_DIFF_FP32


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads while this module's one-process references run
    (the ranks hold themselves to two)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _blocks(x, part, ex):
    lo, hi = part.block(ex.rank)
    return Block(x[:, lo:hi].contiguous(), part, ex)


def _gather(blocks):
    return torch.cat([b.t for b in blocks], dim=1)


# ---- (a) the partitioner ----


@pytest.mark.parametrize("height,world,multiple,bounds", [
    (64, 2, 1, (0, 32, 64)),              # even
    (80, 3, 8, (0, 32, 56, 80)),          # uneven: 10 units over 3
    (100, 2, 32, (0, 64, 100)),           # the last takes 4 rows over
    (48, 8, 1, (0, 6, 12, 18, 24, 30, 36, 42, 48)),
    (1024, 2, 64, (0, 512, 1024)),        # the student at full resolution
    (1280, 2, 64, (0, 640, 1280)),
])
def test_partition(height, world, multiple, bounds):
    part = partition(height, world, multiple)
    assert part.bounds == bounds
    assert part.world == world and part.height == height
    assert all(b % multiple == 0 for b in bounds[:-1])


def test_partition_raises_naming_the_numbers():
    with pytest.raises(ValueError, match="128 rows holds 2 blocks of 64 "
                                         "rows.*fewer than the 3 ranks"):
        partition(128, 3, 64)


def test_derived_partitions():
    part = Partition((0, 64, 96, 131))
    assert conv_partition(part, 1) == part
    assert conv_partition(part, 2) == Partition((0, 32, 48, 66))
    assert part.map(lambda b: b // 2, 65) == Partition((0, 32, 48, 65))


def test_student_row_multiple():
    """Stem x8, cells to 1/32, the zoomed cells' 1/64: 64 input rows."""
    from fasterseg_tpu_torch.models.fast_body import row_multiple
    assert row_multiple(student_plan()) == 64


# ---- (b) the conv's halo mode ----


def _conv_inputs(h, w, ci, co, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((1, h, w, ci), generator=g),
            torch.randn((3, 3, ci, co), generator=g) * 0.3,
            torch.rand(co, generator=g) + 0.5, torch.randn(co, generator=g))


@pytest.mark.parametrize("stride,bounds,ci2", [
    (1, (0, 7, 15, 21), 0),       # both halos, uneven blocks
    (2, (0, 8, 14, 21), 0),       # top halo; the last block odd
    (2, (0, 6, 13), 0),           # an odd block that is not last
    (1, (0, 5, 16), 3),           # two inputs (the refine concat)
])
def test_plain_conv_with_halos_matches_whole_rows(stride, bounds, ci2):
    """conv3x3_bn_relu_plain of a block with its neighbours' rows around it
    (and the wrapper, which takes it on the CPU) = the rows of the whole
    map's conv; no launch counts on the CPU."""
    x, w, scale, bias = _conv_inputs(bounds[-1], 9, 4 + ci2, 6, stride)
    x1, x2 = (x, None) if not ci2 else (x[..., :4], x[..., 4:])
    whole = conv3x3_bn_relu_plain(x, w, scale, bias, stride=stride)
    part = Partition(bounds)
    out = conv_partition(part, stride)
    reset_launch_counts()
    for r in range(part.world):
        lo, hi = part.block(r)
        h = hi - lo
        top = int(lo > 0)
        bottom = int((h - 1) // stride * stride + 1 >= h and hi < bounds[-1])
        rows = slice(lo - top, hi + bottom)
        xb2 = None if x2 is None else x2[:, rows].contiguous()
        for fn in (conv3x3_bn_relu_plain, conv3x3_bn_relu):
            got = fn(x1[:, rows].contiguous(), w, scale, bias, stride=stride,
                     x2=xb2, halo=(top, bottom))
            olo, ohi = out.block(r)
            torch.testing.assert_close(got, whole[:, olo:ohi],
                                       atol=ROW_ATOL, rtol=0)
    assert set(halo_launch_counts().values()) == {0}


def test_conv_halo_argument_is_checked():
    x, w, scale, bias = _conv_inputs(4, 4, 3, 2, 0)
    for halo in ((2, 0), (0, -1), (1, 1)):
        with pytest.raises(ValueError, match="halo"):
            conv3x3_bn_relu(x[:, :2] if halo == (1, 1) else x, w, scale,
                            bias, halo=halo)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("stride", [1, 2])
def test_block_conv_exchanges_halos(world, stride):
    """spatial.conv3x3_bn_relu on each rank's Block (halos through the
    exchange, one collective a conv) = the whole map's conv, with a second
    input too at stride 1."""
    x, w, scale, bias = _conv_inputs(26, 7, 5, 4, world)
    part = partition(26, world, 2)
    whole = conv3x3_bn_relu_plain(x, w, scale, bias, stride=stride)

    def rank(ex):
        got = spatial.conv3x3_bn_relu(_blocks(x, part, ex), w, scale, bias,
                                      stride=stride)
        two = None
        if stride == 1:
            two = spatial.conv3x3_bn_relu(
                _blocks(x[..., :2], part, ex), w, scale, bias,
                x2=_blocks(x[..., 2:], part, ex))
        return got, two, ex.exchanges

    out = W.on_threads(world, rank)
    assert out[0][0].part == conv_partition(part, stride)
    torch.testing.assert_close(_gather([o[0] for o in out]), whole,
                               atol=ROW_ATOL, rtol=0)
    if stride == 1:
        torch.testing.assert_close(_gather([o[1] for o in out]), whole,
                                   atol=ROW_ATOL, rtol=0)
    assert [o[2] for o in out] == [1 + (stride == 1)] * world


def test_stride_two_refuses_an_odd_block_start():
    x, w, scale, bias = _conv_inputs(9, 4, 2, 2, 0)

    def rank(ex):
        return spatial.conv3x3_bn_relu(_blocks(x, Partition((0, 3, 9)), ex),
                                       w, scale, bias, stride=2)

    with pytest.raises(ValueError, match="odd row 3"):
        W.on_threads(2, rank)


# ---- (c) the row-window resizes ----


def _map(h, w=6, c=3, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, h, w, c)).astype(np.float32))


@pytest.mark.parametrize("form,h,bounds,out_bounds", [
    ("align_corners", 10, (0, 3, 7, 10), (0, 12, 30, 37)),    # up, uneven
    ("align_corners", 37, (0, 12, 30, 37), (0, 3, 7, 10)),    # down
    ("align_corners", 40, (0, 16, 40), (0, 5, 10)),           # windows past
    ("downsample_half", 21, (0, 8, 14, 21), None),            # one row
    ("scale_by", 5, (0, 2, 5), None),                         # x8 logits
    ("halfpixel", 48, (0, 16, 32, 48), (0, 24, 40, 64)),      # x4/3
    ("halfpixel", 80, (0, 32, 56, 80), (0, 24, 40, 64)),      # x4/5
    ("halfpixel", 64, (0, 30, 64), (0, 30, 64)),              # identity
])
def test_row_window_resize_matches_whole_rows(form, h, bounds, out_bounds):
    """Each rank's rows of the row-window form (the global matrix's rows,
    the input window they touch, fetched from the ranks that hold it) = the
    whole map's resize rows."""
    x = _map(h)
    part = Partition(bounds)
    world = part.world
    if form == "downsample_half":
        whole = resize.downsample_half(x)
        fn = resize.downsample_half_rows
    elif form == "scale_by":
        whole = resize.scale_by(x, 8)
        fn = lambda b: resize.scale_by_rows(b, 8)        # noqa: E731
    else:
        out_hw = (out_bounds[-1], 5)
        half = form == "halfpixel"
        whole = (resize.resize_bilinear_halfpixel(x, out_hw) if half
                 else resize.resize_bilinear(x, out_hw))
        fn = lambda b: resize.resize_bilinear_rows(       # noqa: E731
            b, out_hw, Partition(out_bounds), half_pixel=half)
    out = W.on_threads(world, lambda ex: fn(_blocks(x, part, ex)))
    assert out[0].height == whole.shape[1]
    torch.testing.assert_close(_gather(out), whole, atol=ROW_ATOL, rtol=0)
    if out_bounds:
        assert out[0].part == Partition(out_bounds)


def test_row_window_reaches_past_one_row():
    """A 40 -> 5 row resize: output row 1 reads input rows 9 and 10, so the
    second rank's window (rows 3-4 of the output) starts in the first
    rank's block of 20 rows."""
    assert resize.row_window(40, 5, 3, 5) == (29, 40)
    assert resize.row_window(40, 5, 0, 2) == (0, 11)
    assert resize.row_window(21, 10, 4, 7) == (8, 15)
    assert resize.row_window(10, 10, 2, 4) == (2, 4)


def test_blocks_resize_by_contraction_whole_maps_by_the_kernel_wrapper():
    """Split over two ranks (threads), the student's fp32 logits take the
    row-window contraction for each of its 25 resizes and the x8 on every
    rank, counted as `resize.contraction`; the whole image counts none
    (its resizes run `kernels.resize_bilinear`) and its rows agree with the
    blocks'."""
    from fasterseg_tpu_torch.models import DerivedNet, InferenceRunner
    from fasterseg_tpu_torch.utils import init_random_, profiling
    plan = student_plan()
    runner = InferenceRunner(plan, init_random_(DerivedNet(plan), 0),
                             dtype=torch.float32, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, *W.STUDENT_HW, 3)).astype(np.float32))
    part = partition(W.STUDENT_HW[0], 2, runner.row_multiple)

    def rank(ex):
        lo, hi = part.block(ex.rank)
        return runner.logits(Block(x[:, lo:hi].contiguous(), part, ex)).t

    profiling.reset()
    with profiling.recording():
        blocks = W.on_threads(2, rank)
        split = profiling.summary()["counters"].get("resize.contraction")
        whole = runner.logits(x)
        after = profiling.summary()["counters"].get("resize.contraction")
    profiling.reset()
    assert split == after == 2 * 26
    torch.testing.assert_close(torch.cat(blocks, dim=1), whole,
                               atol=LOGITS_ATOL, rtol=0)


# ---- (d) ranks in processes, against one process and against JAX ----


@pytest.fixture(scope="module")
def jax_student():
    """The JAX package's student (seed 0, BN statistics from one train-mode
    pass) at 256x128, its eval-mode logits of a seeded image, and the
    payload the ranks take: the port's state_dict of the same weights, the
    image, the toy conv's weights (tests/test_parallel.py's draws)."""
    jplan, tplan = jax_student_plan(), student_plan()
    model, variables = create_derived(jplan, jax.random.PRNGKey(0),
                                      input_hw=W.STUDENT_HW,
                                      dtype=jnp.float32)
    x = np.random.default_rng(1).standard_normal(
        (1, *W.STUDENT_HW, 3)).astype(np.float32)
    _, upd = model.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": variables["params"], **upd})
    logits = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    toy_w = {name: np.asarray(jax.random.normal(jax.random.PRNGKey(k),
                                                (3, 3, 3, W.TOY_CLASSES))
                              * 0.3)
             for name, k in (("single_flip", 4), ("multi_flip", 8))}
    payload = {"state": from_jax_variables(tplan, variables),
               "x": torch.from_numpy(x), "toy_w": toy_w}
    return {"logits": logits, "payload": payload}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_student):
    """Every case on two gloo ranks (with the student's evaluation) and on
    three (the student's 4 blocks of 64 rows split 2, 1, 1)."""
    out = {}
    for n in (2, 3):
        payload = dict(jax_student["payload"], student_eval=n == 2)
        out[n] = launch(W.rank_job, n, "gloo", ["cpu"] * n, args=(payload,),
                        store_dir=str(tmp_path_factory.mktemp("store")))
    return out


@pytest.mark.parametrize("n", [2, 3])
def test_student_spatial_logits(ranks, jax_student, n):
    res = ranks[n]
    assert res[0]["logits"]["bounds"] == ((0, 128, 256) if n == 2
                                          else (0, 128, 192, 256))
    for r in res:
        assert r["logits"]["vs_unsplit"] <= LOGITS_ATOL
        # one collective a 3x3 conv and a resize, the same on every rank
        assert r["logits"]["exchanges"] == res[0]["logits"]["exchanges"] > 20
    got = torch.cat([r["logits"]["block"] for r in res], dim=1).numpy()
    assert got.shape == jax_student["logits"].shape
    np.testing.assert_allclose(got, jax_student["logits"], rtol=JAX_TOL,
                               atol=JAX_TOL)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("name", ["single_flip", "multi_flip"])
def test_toy_spatial_eval_equals_jax_spatial(ranks, jax_student, n, name):
    """The port's toy conv, each image split over n ranks, against the JAX
    Evaluator on the 8-device spatial mesh (XLA's halo exchange), as
    tests/test_parallel.py:103 and :134 hold it against one device."""
    ds, scales = {k: (d, s) for k, d, s in W.toy_datasets()}[name]
    w = jax_student["payload"]["toy_w"][name]

    def fwd(variables, images):
        return jax.lax.conv_general_dilated(
            images, variables["w"], (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    jds = JaxSyntheticDataset(length=ds.length, hw=ds.hw,
                              num_classes=W.TOY_CLASSES, seed=ds.seed)
    want = JaxEvaluator(
        jds, num_classes=W.TOY_CLASSES, image_mean=W.TOY_MEAN,
        image_std=W.TOY_STD, forward_fn=fwd, eval_scales=scales,
        eval_flip=True, mesh=jax_make_mesh(8, axis_names=(JAX_SPATIAL_AXIS,)),
        spatial=True).run({"w": jnp.asarray(w)})
    for r in ranks[n]:
        got = r["toy"][name]
        np.testing.assert_array_equal(got["hist"], want.hist)
        assert got["pixel_acc"] == want.pixel_acc
        assert got["mean_iu"] == want.mean_iu
    assert want.hist.sum() > 0


@pytest.mark.parametrize("name", ["single_flip", "multi_flip"])
def test_student_spatial_eval_matches_one_process(ranks, jax_student, name):
    """The student's evaluation split over two ranks against one process
    on whole images: hist distance d = |hist_A - hist_B|_1 / 2 / labeled
    within 1e-4, the ranks' hists equal."""
    want = W.student_eval(None, jax_student["payload"])[name]["hist"]
    res = [r["student_eval"][name] for r in ranks[2]]
    np.testing.assert_array_equal(res[0]["hist"], res[1]["hist"])
    d = np.abs(res[0]["hist"] - want).sum() / 2 / want.sum()
    assert d <= HIST_D
    assert res[0]["hist"].sum() == want.sum() > 0
    assert res[0]["exchanges"] > 0
