"""The port's train data pipeline against the JAX package's, exact:
`TrainPre` on the numpy/cv2 path, on the numpy path without cv2 and on the
native (C++) path; `TrainLoader` batches for a seed; `seek` reproducing an
epoch. The native kernels alone against cv2 with the JAX package's bars
(tests/test_native.py): bilinear within one level (cv2 rounds fixed-point
weights), the rest exact, normalisation to 1e-6.
"""

import dataclasses
import os

import numpy as np
import pytest

from fasterseg_tpu.core.config import DataConfig as JaxDataConfig
from fasterseg_tpu.core.config import cityscapes_teacher_config as jax_teacher
from fasterseg_tpu.data import get_train_loader as jax_get_train_loader
from fasterseg_tpu.data import native as jax_native
from fasterseg_tpu.data import preprocess as jpre
from fasterseg_tpu_torch.core.config import DataConfig, cityscapes_teacher_config
from fasterseg_tpu_torch.data import TrainLoader, get_train_loader, native
from fasterseg_tpu_torch.data import preprocess as tpre
from fasterseg_tpu_torch.data.procgen import ProcCity

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)

cv2 = pytest.importorskip("cv2")


def _scene(i, hw=(96, 192)):
    s = ProcCity(length=4, hw=hw, seed=3)[i]
    return s["data"], s["label"]


def _pair(crop_hw, gt_down, use_native):
    kw = dict(image_mean=MEAN, image_std=STD, crop_hw=crop_hw,
              gt_down_sampling=gt_down, use_native=use_native)
    return tpre.TrainPre(**kw), jpre.TrainPre(**kw)


# crops smaller than the scaled image (random origin) and larger (padding),
# the label downsampled x8 as in search
CASES = [((64, 128), 1), ((128, 256), 1), ((64, 128), 8)]


@pytest.mark.parametrize("crop_hw,gt_down", CASES)
@pytest.mark.parametrize("use_native", [False, True])
def test_train_pre_matches_jax(crop_hw, gt_down, use_native):
    assert native.available() and jax_native.available()
    port, ref = _pair(crop_hw, gt_down, use_native)
    assert port.uses_native() == use_native
    for seed in range(6):
        img, gt = _scene(seed % 4)
        a = port(np.random.default_rng(seed), img, gt)
        b = ref(np.random.default_rng(seed), img, gt)
        assert a[0].dtype == np.float32 and a[1].dtype == np.int32
        assert a[0].shape == (*crop_hw, 3)
        assert a[1].shape == (crop_hw[0] // gt_down, crop_hw[1] // gt_down)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("crop_hw,gt_down", CASES[:2])
def test_train_pre_numpy_fallback_matches_jax(monkeypatch, crop_hw, gt_down):
    """Both packages without cv2: the numpy resize fallback."""
    monkeypatch.setattr(tpre, "_HAS_CV2", False)
    monkeypatch.setattr(jpre, "_HAS_CV2", False)
    port, ref = _pair(crop_hw, gt_down, use_native=False)
    for seed in range(4):
        img, gt = _scene(seed)
        a = port(np.random.default_rng(seed), img, gt)
        b = ref(np.random.default_rng(seed), img, gt)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("hw", [(48, 80), (97, 61)])
def test_native_kernels_match_cv2(hw):
    img, gt = _scene(0, (64, 96))
    got = native.resize_bilinear_u8(img, *hw).astype(int)
    want = cv2.resize(img, hw[::-1], interpolation=cv2.INTER_LINEAR)
    assert np.abs(got - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(
        native.resize_nearest_u8(gt, *hw),
        cv2.resize(gt, hw[::-1], interpolation=cv2.INTER_NEAREST))
    np.testing.assert_array_equal(native.mirror_u8(img), img[:, ::-1])
    out = native.crop_pad_normalize(img, 10, 20, *hw, MEAN, STD)
    want, _ = tpre.pad_image_to_shape(
        tpre.normalize(img, MEAN, STD)[10:10 + hw[0], 20:20 + hw[1]], hw, 0.0)
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
    lab = native.crop_pad_u8(gt, 10, 20, *hw, pad=255)
    want, _ = tpre.pad_image_to_shape(gt[10:10 + hw[0], 20:20 + hw[1]], hw,
                                      255)
    np.testing.assert_array_equal(lab, want)


def _configs(batch_size=2):
    kw = dict(synthetic=True, synthetic_length=6, image_height=32,
              image_width=64, batch_size=batch_size)
    return (dataclasses.replace(cityscapes_teacher_config(),
                                data=DataConfig(**kw)),
            dataclasses.replace(jax_teacher(), data=JaxDataConfig(**kw)))


def test_loader_batches_match_jax():
    """The same seed gives the same batches in both packages, across an
    epoch boundary (3 batches an epoch)."""
    cfg, jcfg = _configs()
    a, b = get_train_loader(cfg, None), jax_get_train_loader(jcfg, None)
    try:
        ia, ib = iter(a), iter(b)
        for _ in range(5):
            (xa, ya), (xb, yb) = next(ia), next(ib)
            assert xa.shape == (2, 32, 64, 3) and ya.dtype == np.int32
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
    finally:
        a.close()
        b.close()
    assert a._thread is None


def test_loader_seek_reproduces_an_epoch():
    cfg, _ = _configs()
    a = get_train_loader(cfg, None)
    it = iter(a)
    epoch0 = [next(it) for _ in range(3)]
    epoch1 = [next(it) for _ in range(3)]
    a.seek(0)
    again = [next(iter(a)) for _ in range(3)]
    a.close()
    b = get_train_loader(cfg, None)
    b.seek(1)
    it = iter(b)
    resumed = [next(it) for _ in range(3)]
    b.close()
    for (x1, y1), (x2, y2) in zip(epoch0 + epoch1, again + resumed):
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(y1, y2)
    assert not np.array_equal(epoch0[0][0], epoch1[0][0])
    # make_batch is the same function, without the thread
    np.testing.assert_array_equal(b.make_batch(1, 2)[0], resumed[2][0])


def test_loader_on_proccity_native():
    """A ProcCity pool held in memory, as chip_smoke.py trains on it."""
    pool = [ProcCity(length=3, hw=(96, 192), seed=0)[i] for i in range(3)]
    pre = tpre.TrainPre(MEAN, STD, (64, 128))
    ref = jpre.TrainPre(MEAN, STD, (64, 128))
    a = TrainLoader(pool, pre, batch_size=4, seed=7)
    from fasterseg_tpu.data.loader import TrainLoader as JaxTrainLoader
    b = JaxTrainLoader(pool, ref, batch_size=4, seed=7)
    for step in range(2):
        xa, ya = a.make_batch(0, step)
        xb, yb = b._make_batch(0, step)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    assert set(np.unique(ya)) <= set(range(19)) | {255}


def test_loader_pool_matches_serial_and_jax():
    """The slot pool prepares a batch larger than the pool (so threads take
    several slots each, in whatever order they finish) bit-equal to the
    slots prepared one after another and to the JAX package's loader."""
    from fasterseg_tpu.data.loader import TrainLoader as JaxTrainLoader
    pool = [ProcCity(length=3, hw=(64, 128), seed=1)[i] for i in range(3)]
    pre = tpre.TrainPre(MEAN, STD, (32, 64), gt_down_sampling=2)
    a = TrainLoader(pool, pre, batch_size=(os.cpu_count() or 1) + 3, seed=5)
    assert a.pool_size < a.batch_size
    b = JaxTrainLoader(pool, jpre.TrainPre(MEAN, STD, (32, 64),
                                           gt_down_sampling=2),
                       batch_size=a.batch_size, seed=5)
    try:
        for epoch, step in ((0, 0), (2, 1)):
            x, y = a.make_batch(epoch, step)
            order = np.random.default_rng((5, epoch)).permutation(len(pool))
            for slot in range(a.batch_size):
                s = pool[int(order[(step * a.batch_size + slot) % len(pool)])]
                xs, ys = pre(np.random.default_rng((5, epoch, step, slot)),
                             s["data"], s["label"])
                np.testing.assert_array_equal(x[slot], xs)
                np.testing.assert_array_equal(y[slot], ys)
            xb, yb = b._make_batch(epoch, step)
            np.testing.assert_array_equal(x, xb)
            np.testing.assert_array_equal(y, yb)
        # the prefetch thread draws on the same pool; close stops both
        it = iter(a)
        np.testing.assert_array_equal(next(it)[0], a.make_batch(0, 0)[0])
    finally:
        a.close()
    assert a._thread is None and a._pool is None
