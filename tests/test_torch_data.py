"""fasterseg_tpu_torch.data against the JAX package's data modules on the CPU.

Eval preprocessing (with cv2 and with the numpy fallback that a host without
cv2 takes), the ProcCity renderer, the synthetic and file-list datasets and
the shipped file lists must give identical arrays in both packages.
"""

import os
import sys

import numpy as np
import pytest

import fasterseg_tpu.data.datasets as jds
import fasterseg_tpu.data.preprocess as jpre
import fasterseg_tpu.data.procgen as jproc
import fasterseg_tpu_torch.data.datasets as tds
import fasterseg_tpu_torch.data.preprocess as tpre
import fasterseg_tpu_torch.data.procgen as tproc

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.fixture(params=["cv2", "fallback"])
def cv2_mode(request, monkeypatch):
    """Both packages with cv2, or both on the numpy fallback."""
    if request.param == "cv2":
        pytest.importorskip("cv2")
    else:
        monkeypatch.setattr(jpre, "_HAS_CV2", False)
        monkeypatch.setattr(tpre, "_HAS_CV2", False)
    return request.param


def _image(seed, hw, channels=3):
    rng = np.random.default_rng(seed)
    shape = (*hw, channels) if channels else hw
    return rng.integers(0, 256, shape, dtype=np.uint8)


# (source hw, target (w, h)): down and up, the eval scales 0.75 and 1.25, odd
@pytest.mark.parametrize("hw,wh", [((48, 96), (72, 36)), ((48, 96), (120, 60)),
                                   ((37, 53), (29, 61)), ((20, 30), (7, 5))])
@pytest.mark.parametrize("nearest", [False, True])
def test_resize_matches_jax(cv2_mode, hw, wh, nearest):
    for channels in (3, 0):
        img = _image(1, hw, channels)
        want = jpre._resize(img, wh, nearest)
        got = tpre._resize(img, wh, nearest)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_fallback_differs_from_cv2_by_at_most_one_level(monkeypatch):
    """The numpy fallback truncates where cv2 rounds: a known difference
    between hosts with and without cv2, the same in both packages."""
    cv2 = pytest.importorskip("cv2")
    img, _ = tproc.render_scene(0, 0, (64, 128))
    with_cv2 = tpre._resize(img, (96, 48), nearest=False)
    assert np.array_equal(with_cv2, cv2.resize(img, (96, 48),
                                               interpolation=cv2.INTER_LINEAR))
    monkeypatch.setattr(tpre, "_HAS_CV2", False)
    fallback = tpre._resize(img, (96, 48), nearest=False)
    diff = np.abs(with_cv2.astype(int) - fallback.astype(int))
    assert diff.max() <= 1


def test_normalize_pad_and_eval_preprocess_match_jax(cv2_mode):
    img = _image(2, (30, 50))
    np.testing.assert_array_equal(tpre.normalize(img, MEAN, STD),
                                  jpre.normalize(img, MEAN, STD))
    got = tpre.eval_preprocess(img, MEAN, STD)
    want = jpre.eval_preprocess(img, MEAN, STD)
    assert got.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)
    for shape, value in (((41, 50), 0), ((30, 77), 0), ((35, 64), 255),
                         ((10, 10), 0)):
        for im in (img, img[..., 0]):
            (g, gm), (w, wm) = (tpre.pad_image_to_shape(im, shape, value),
                                jpre.pad_image_to_shape(im, shape, value))
            assert gm == wm
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("hw", [(64, 128), (37, 91)])
def test_render_scene_and_proccity_bit_equal(hw):
    for index in (0, 5):
        gi, gl = tproc.render_scene(3, index, hw)
        wi, wl = jproc.render_scene(3, index, hw)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    for split in ("train", "val"):
        t = tproc.ProcCity(length=3, hw=hw, seed=1, split=split)
        j = jproc.ProcCity(length=3, hw=hw, seed=1, split=split)
        assert len(t) == len(j) == 3
        for i in (0, 2, 4):               # 4 wraps around the real length
            a, b = t[i], j[i]
            assert a["fn"] == b["fn"] and a["n"] == b["n"]
            np.testing.assert_array_equal(a["data"], b["data"])
            np.testing.assert_array_equal(a["label"], b["label"])
    assert tproc.PROCCITY_CLASSES == jproc.PROCCITY_CLASSES
    assert tproc.NUM_CLASSES == jproc.NUM_CLASSES == 8


@pytest.mark.parametrize("portion", [None, 0.5, -0.25])
def test_synthetic_dataset_matches_jax(portion):
    kw = dict(length=8, hw=(16, 24), num_classes=11, seed=4, portion=portion)
    t, j = tds.SyntheticDataset(**kw), jds.SyntheticDataset(**kw)
    assert len(t) == len(j)
    for i in range(len(t)):
        a, b = t[i], j[i]
        assert a["fn"] == b["fn"] and a["n"] == b["n"]
        np.testing.assert_array_equal(a["data"], b["data"])
        np.testing.assert_array_equal(a["label"], b["label"])


def test_shipped_lists_and_constants_match_jax(tmp_path):
    names = sorted(os.listdir(jds.LISTS_DIR))
    assert sorted(os.listdir(tds.LISTS_DIR)) == names and len(names) == 4
    for name in names:
        assert (tds.FileListDataset._parse(os.path.join(tds.LISTS_DIR, name))
                == jds.FileListDataset._parse(os.path.join(jds.LISTS_DIR,
                                                           name)))
    # a missing list resolves to the shipped one of the same name; an
    # existing one, or one with no shipped twin, is kept
    missing = str(tmp_path / "nowhere" / "cityscapes_val_fine.txt")
    assert tds.resolve_source(missing) == os.path.join(
        tds.LISTS_DIR, "cityscapes_val_fine.txt")
    own = tmp_path / "own.txt"
    own.write_text("a b\n")
    for src in (str(own), str(tmp_path / "other.txt"), None):
        assert tds.resolve_source(src) == jds.resolve_source(src)
    for name in ("CITYSCAPES_CLASSES", "CITYSCAPES_TRAIN_TO_LABEL_ID",
                 "CITYSCAPES_COLORS", "CAMVID_CLASSES", "CAMVID_COLORS"):
        assert getattr(tds, name) == getattr(jds, name)
    pred = np.random.default_rng(0).integers(0, 19, (8, 8))
    np.testing.assert_array_equal(tds.Cityscapes.train_id_to_label_id(pred),
                                  jds.Cityscapes.train_id_to_label_id(pred))


def _setting(pkg, root):
    return pkg.DataSetting(img_root=str(root), gt_root=str(root),
                           train_source=str(root / "train.txt"),
                           eval_source=str(root / "val.txt"))


def test_write_dataset_reads_back_the_same_through_both(tmp_path):
    """A ProcCity tree written by the port reads back through the file-list
    datasets of both packages as the in-memory scenes."""
    pytest.importorskip("cv2")
    root = tmp_path / "proccity"
    tproc.write_dataset(str(root), n_train=2, n_val=3, hw=(32, 64), seed=2)
    ref = tproc.ProcCity(length=3, hw=(32, 64), seed=2, split="val")
    tcls, jcls = tproc.make_dataset_cls(), jproc.make_dataset_cls()
    for kw in ({}, {"portion": -0.5}, {"index_select": [2, 0],
                                       "file_length": 5}):
        t = tcls(_setting(tds, root), split="val", **kw)
        j = jcls(_setting(jds, root), split="val", **kw)
        assert len(t) == len(j) and t.pairs == j.pairs
        for i in range(len(t)):
            a, b = t[i], j[i]
            assert a["fn"] == b["fn"] and a["n"] == b["n"]
            np.testing.assert_array_equal(a["data"], b["data"])
            np.testing.assert_array_equal(a["label"], b["label"])
    t = tcls(_setting(tds, root), split="val")
    for i in range(3):
        np.testing.assert_array_equal(t[i]["data"], ref[i]["data"])
        np.testing.assert_array_equal(t[i]["label"], ref[i]["label"])
    assert t.num_classes == 8 and t.ignore_label == 255
    # integer down-sampling on load
    down = tds.DataSetting(**{**vars(_setting(tds, root)), "down_sampling": 2})
    jdown = jds.DataSetting(**vars(down))
    a, b = tcls(down, split="train")[1], jcls(jdown, split="train")[1]
    assert a["data"].shape == (16, 32, 3)
    np.testing.assert_array_equal(a["data"], b["data"])
    np.testing.assert_array_equal(a["label"], b["label"])


def test_without_cv2_file_lists_raise_and_write_dataset_raises(
        tmp_path, monkeypatch):
    """A host without cv2 reads no PNG and writes none: the file-list
    dataset and write_dataset raise an error that names cv2, instead of
    returning a wrong image or falling back."""
    root = tmp_path / "lists"
    root.mkdir()
    (root / "val.txt").write_text("img.png gt.png\n")
    monkeypatch.setattr(tds, "_HAS_CV2", False)
    ds = tds.Cityscapes(_setting(tds, root), split="val")
    with pytest.raises(ImportError, match="cv2"):
        ds[0]
    with pytest.raises(ImportError, match="cv2"):
        ds._load_label(str(root / "gt.png"), 1)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        tproc.write_dataset(str(tmp_path / "out"), n_train=1, n_val=1,
                            hw=(8, 16))
    assert not (tmp_path / "out").exists()
