"""fasterseg_tpu_torch.eval and the eval resizes against the JAX package on the
CPU.

Metrics are exact. The resizes match at 1e-6. Both evaluators get one cheap
forward written in both frameworks (a fixed 3->C channel map plus a
per-pixel bias, so the flip matters): single-scale counts are equal;
multi-scale and sliding class maps may differ only at near-ties of the JAX
probability sum, since the resizes' fp32 sums round in another order. Last,
the real networks: the JAX DerivedNet against the port's kernel path on
ProcCity scenes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasterseg_tpu.eval.metrics as jm
from fasterseg_tpu.data.procgen import ProcCity as JaxProcCity
from fasterseg_tpu.eval.evaluator import Evaluator as JaxEvaluator
from fasterseg_tpu.ops import resize as jresize
import fasterseg_tpu_torch.eval.metrics as tm
from fasterseg_tpu_torch.data.procgen import ProcCity
from fasterseg_tpu_torch.eval import Evaluator
from fasterseg_tpu_torch.models import InferenceRunner
from fasterseg_tpu_torch.ops import resize as tresize
from test_torch_weights import HW, _both

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
NEAR_TIE = 1e-5


def _maps(n, seed, shape=(2, 24, 40)):
    """pred in [-2, n+2) (clipped by the hist), labels with ignore 255 and
    out-of-range classes."""
    rng = np.random.default_rng(seed)
    pred = rng.integers(-2, n + 2, shape).astype(np.int32)
    label = rng.integers(0, n + 3, shape).astype(np.int32)
    label[rng.random(shape) < 0.1] = 255
    return pred, label


@pytest.mark.parametrize("n", [8, 11, 19])
def test_confusion_hist_and_stats_match_jax(n):
    pred, label = _maps(n, n)
    want = np.asarray(jm.confusion_hist(jnp.asarray(pred),
                                        jnp.asarray(label), n))
    got = tm.confusion_hist(torch.from_numpy(pred), torch.from_numpy(label), n)
    assert got.dtype == torch.int64 and tuple(got.shape) == (n, n)
    np.testing.assert_array_equal(got.numpy(), want)
    # a uint8 label map, and ignore inside the class range (CamVid's 11)
    lab8 = np.where(label == 255, 255, label % n).astype(np.uint8)
    for ignore in (255, n - 1):
        want = [np.asarray(a) for a in jm.hist_stats(
            jnp.asarray(pred), jnp.asarray(lab8.astype(np.int32)), n, ignore)]
        got = [t.numpy() for t in tm.hist_stats(
            torch.from_numpy(pred), torch.from_numpy(lab8), n, ignore)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[0].sum() == got[1]


@pytest.mark.parametrize("n", [8, 11, 19])
def test_compute_score_matches_jax(n):
    pred, label = _maps(n, 100 + n)
    pred[pred == 1] = 2            # class 1 never predicted
    label[label == 3] = 255        # class 3 never labeled
    hist, labeled, correct = tm.hist_stats(torch.from_numpy(pred),
                                           torch.from_numpy(label), n)
    got = tm.compute_score(hist, int(correct), int(labeled))
    want = jm.compute_score(hist.numpy(), int(correct), int(labeled))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert np.isfinite(got[1])
    assert np.isnan(tm.compute_score(hist)[3])


@pytest.mark.parametrize("n", [8, 11, 19])
def test_batch_intersection_union_and_seg_metrics_match_jax(n):
    rng = np.random.default_rng(200 + n)
    tmet, jmet = tm.SegMetrics(n), jm.SegMetrics(n)
    for step in range(3):
        logits = rng.standard_normal((2, 12, 20, n)).astype(np.float32)
        target = rng.integers(-1, n + 2, (2, 12, 20)).astype(np.int32)
        ji, ju = jm.batch_intersection_union(jnp.asarray(logits),
                                             jnp.asarray(target), n)
        ti, tu = tm.batch_intersection_union(torch.from_numpy(logits),
                                             torch.from_numpy(target), n)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        tmet.update(ti, tu)
        jmet.update(np.asarray(ji), np.asarray(ju))
        np.testing.assert_array_equal(tmet.total_inter, jmet.total_inter)
        np.testing.assert_array_equal(tmet.total_union, jmet.total_union)
        assert tmet.get_scores() == jmet.get_scores()
    tmet.reset()
    assert tmet.total_union.sum() == 0


# (input shape, out_hw): up, down, odd sizes both ways, HWC, one row
RESIZES = [((1, 7, 9, 5), (16, 21)), ((2, 32, 48, 3), (13, 17)),
           ((1, 20, 11, 4), (9, 30)), ((15, 26, 19), (30, 13)),
           ((1, 1, 6, 2), (3, 12))]


@pytest.mark.parametrize("shape,out_hw", RESIZES)
def test_resize_halfpixel_and_nearest_match_jax(shape, out_hw):
    x = np.random.default_rng(len(shape) + out_hw[0]).random(shape).astype(
        np.float32)
    want = np.asarray(jresize.resize_bilinear_halfpixel(jnp.asarray(x),
                                                        out_hw))
    got = tresize.resize_bilinear_halfpixel(torch.from_numpy(x), out_hw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tresize._hp_interp_matrix_np(shape[-3], out_hw[0]),
        jresize._hp_interp_matrix_np(shape[-3], out_hw[0]))
    for a in (x, (x * 19).astype(np.int32)):
        want = np.asarray(jresize.resize_nearest(jnp.asarray(a), out_hw))
        got = tresize.resize_nearest(torch.from_numpy(a), out_hw)
        np.testing.assert_array_equal(got.numpy(), want)


def test_resize_halfpixel_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    x = np.random.default_rng(5).random((24, 40, 19)).astype(np.float32)
    for out_hw in ((48, 80), (17, 31)):
        got = tresize.resize_bilinear_halfpixel(torch.from_numpy(x), out_hw)
        want = cv2.resize(x, out_hw[::-1], interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---- evaluator protocols on a shared forward ----


class SharedForward:
    """logits = x @ M + bias(H, W): a fixed channel map and a per-pixel bias
    (numpy constants, one for each input size), computed term by term in
    the same order in both frameworks."""

    def __init__(self, num_classes, seed=0):
        rng = np.random.default_rng(seed)
        self.m = (rng.standard_normal((3, num_classes)) * 3).astype(
            np.float32)
        self.c = num_classes
        self.seed = seed

    def bias(self, h, w):
        rng = np.random.default_rng((self.seed, h, w))
        return (rng.standard_normal((h, w, self.c)) * 2).astype(np.float32)

    def jax(self, variables, x):
        m = jnp.asarray(self.m)
        out = x[..., 0:1] * m[0] + x[..., 1:2] * m[1] + x[..., 2:3] * m[2]
        return out + jnp.asarray(self.bias(x.shape[1], x.shape[2]))

    def torch(self, x):
        m = torch.from_numpy(self.m)
        out = x[..., 0:1] * m[0] + x[..., 1:2] * m[1] + x[..., 2:3] * m[2]
        return out + torch.from_numpy(self.bias(x.shape[1], x.shape[2]))


def _evaluators(ds, n, fwd, **kw):
    common = dict(num_classes=n, image_mean=MEAN, image_std=STD, **kw)
    return (JaxEvaluator(ds, forward_fn=fwd.jax, **common),
            Evaluator(ds, forward_fn=fwd.torch, device="cpu", **common))


def _assert_near_ties(got, want, probs):
    """`got` and `want` class maps differ on at most 1e-4 of the pixels, and
    each such pixel is a near-tie of the JAX probability sum `probs`."""
    differ = got != want
    assert differ.mean() <= 1e-4, differ.sum()
    top2 = np.sort(probs, -1)[..., -2:]
    assert np.all((top2[..., 1] - top2[..., 0])[differ] < NEAR_TIE)


@pytest.mark.parametrize("flip,batch,n", [(False, 1, 8), (True, 1, 8),
                                          (True, 2, 8), (False, 2, 6)])
def test_single_scale_counts_equal_jax(flip, batch, n):
    """Fused single-scale protocol: hist, correct and labeled equal. Batch 2
    over 3 images pads the tail with a repeat that counts nothing; n = 6
    makes ProcCity's classes 6 and 7 out of range."""
    ds = ProcCity(length=3, hw=(48, 96), seed=3, split="val")
    fwd = SharedForward(n)
    jev, tev = _evaluators(ds, n, fwd, eval_flip=flip, batch_size=batch)
    want, got = jev.run({}), tev.run()
    assert got.hist.dtype == np.int64
    np.testing.assert_array_equal(got.hist, want.hist)
    assert got.mean_iu == want.mean_iu and got.pixel_acc == want.pixel_acc
    np.testing.assert_array_equal(got.iou_per_class, want.iou_per_class)
    labels = np.stack([ds[i]["label"] for i in range(3)])
    assert got.hist.sum() == ((labels != 255) & (labels < n)).sum()
    # the tail's repeat counts nothing: the padded run equals batch 1
    if batch == 2:
        one = _evaluators(ds, n, fwd, eval_flip=flip)[1].run()
        np.testing.assert_array_equal(got.hist, one.hist)
    assert str(got).startswith("mIoU ")


def _jax_multiscale_probs(jev, imgs):
    """The JAX evaluator's full-resolution probability sum over scales."""
    from fasterseg_tpu.data.preprocess import _resize, eval_preprocess
    H, W = imgs.shape[1:3]
    acc = 0
    for s in jev.eval_scales:
        sh, sw = int(H * s), int(W * s)
        batch = np.stack([eval_preprocess(
            _resize(im, (sw, sh), nearest=False) if s != 1.0 else im,
            MEAN, STD) for im in imgs])
        acc = acc + np.asarray(jev._probs_fullres_fn((sh, sw), (H, W))(
            {}, jnp.asarray(batch)))
    return acc


@pytest.mark.parametrize("flip", [False, True])
def test_multi_scale_matches_jax_up_to_near_ties(flip):
    n = 8
    ds = ProcCity(length=2, hw=(48, 96), seed=4, split="val")
    fwd = SharedForward(n, seed=1)
    jev, tev = _evaluators(ds, n, fwd, eval_flip=flip,
                           eval_scales=(0.5, 1.0, 1.5), batch_size=2)
    imgs = np.stack([ds[i]["data"] for i in range(2)])
    want = jev._predict_whole({}, imgs)
    got = tev._predict_whole(imgs)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    _assert_near_ties(got.numpy(), want, _jax_multiscale_probs(jev, imgs))
    # run(): the same protocol through the counts
    jr, tr = jev.run({}), tev.run()
    n_differ = int((got.numpy() != want).sum())
    assert np.abs(tr.hist - jr.hist).sum() <= 2 * n_differ
    assert tr.hist.sum() == jr.hist.sum()


def _jax_sliding_probs(jev, img, crop):
    """The JAX sliding protocol's averaged probabilities (evaluator.py
    sliding_eval, before its argmax)."""
    from fasterseg_tpu.data.preprocess import eval_preprocess, pad_image_to_shape
    H, W = img.shape[:2]
    img_pad, mg = pad_image_to_shape(img, (max(H, crop), max(W, crop)), 0)
    ph, pw = img_pad.shape[:2]
    acc = np.zeros((ph, pw, jev.num_classes), np.float32)
    count = np.zeros((ph, pw, 1), np.float32)
    stride = int(np.ceil(crop * 5.0 / 6))
    for r in range(int(np.ceil(max(ph - crop, 0) / stride)) + 1):
        for c in range(int(np.ceil(max(pw - crop, 0) / stride)) + 1):
            y, x = min(r * stride, ph - crop), min(c * stride, pw - crop)
            batch = eval_preprocess(img_pad[y:y + crop, x:x + crop],
                                    MEAN, STD)[None]
            acc[y:y + crop, x:x + crop] += np.asarray(
                jev._probs_fn((crop, crop))({}, jnp.asarray(batch)))[0]
            count[y:y + crop, x:x + crop] += 1
    acc = acc[mg[0]:mg[0] + H, mg[2]:mg[2] + W]
    count = count[mg[0]:mg[0] + H, mg[2]:mg[2] + W]
    return acc / np.maximum(count, 1)


# a 2 x 4 crop grid; a crop taller than the image (centre padding) with flip
@pytest.mark.parametrize("hw,crop,flip", [((48, 96), 32, False),
                                          ((24, 72), 32, True)])
def test_sliding_matches_jax_up_to_near_ties(hw, crop, flip):
    n = 8
    img = ProcCity(length=1, hw=hw, seed=5)[0]["data"]
    fwd = SharedForward(n, seed=2)
    jev, tev = _evaluators(None, n, fwd, eval_flip=flip)
    want = jev.sliding_eval({}, img, crop)
    got = tev.sliding_eval(img, crop)
    assert got.dtype == np.int32 and got.shape == want.shape == hw
    _assert_near_ties(got, want, _jax_sliding_probs(jev, img, crop))


def test_evaluator_defaults_to_cuda(monkeypatch):
    """Without a `device` the evaluator runs on the card, and raises where
    there is none rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Evaluator([], 8, MEAN, STD, forward_fn=lambda x: x)


def test_real_networks_match_jax():
    """The JAX DerivedNet (what TrainSession.evaluate passes) against the
    port's InferenceRunner kernel path (plain versions on the CPU), fp32,
    over three ProcCity scenes with the same converted weights."""
    _, model, variables, tplan, net, _ = _both("student")
    ds = ProcCity(length=3, hw=HW, seed=6, split="val")
    jds = JaxProcCity(length=3, hw=HW, seed=6, split="val")
    jev = JaxEvaluator(jds, 19, MEAN, STD,
                       lambda v, x: model.apply(v, x, train=False))
    runner = InferenceRunner(tplan, net, dtype=torch.float32, device="cpu")
    tev = Evaluator(ds, 19, MEAN, STD, runner.logits, device="cpu")
    want, got = jev.run(variables), tev.run()
    labeled = got.hist.sum()
    assert labeled == want.hist.sum() > 0
    d = 0.5 * np.abs(got.hist - want.hist).sum() / labeled
    assert d <= 0.001, d
    assert abs(got.mean_iu - want.mean_iu) <= 1e-3
    assert np.isfinite(got.mean_iu) and 0 < got.pixel_acc <= 1


@pytest.mark.parametrize("copies", [1, 3, 64, 100000])
def test_privatised_counts_equal_index_add(copies):
    """`_bincount` over private copies of the bins counts exactly what one
    `index_add_` into the bins counts (and numpy's bincount), including the
    extra bin that collects invalid pixels; so do the hists built on it."""
    rng = np.random.default_rng(copies)
    idx = torch.from_numpy(rng.integers(0, 21, 5001))
    plain = torch.zeros(21, dtype=torch.int64).index_add_(
        0, idx, torch.ones_like(idx))
    got = tm._bincount(idx, 21, copies)
    assert got.dtype == torch.int64
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.numpy(), np.bincount(idx.numpy(),
                                                           minlength=21))
    pred = torch.from_numpy(rng.integers(0, 19, (2, 33, 47)))
    label = torch.from_numpy(rng.integers(0, 19, (2, 33, 47)))
    label[torch.from_numpy(rng.random((2, 33, 47)) < 0.2)] = 255
    label[0, 0, :5] = -1
    n = 19
    valid = (label >= 0) & (label < n)
    flat = torch.where(valid, n * label + pred, n * n).reshape(-1)
    want = torch.zeros(n * n + 1, dtype=torch.int64).index_add_(
        0, flat, torch.ones_like(flat))[:n * n].reshape(n, n)
    assert torch.equal(tm.confusion_hist(pred, label, n), want)
