"""Whole-image / multi-scale / sliding segmentation evaluator.

Counterpart of the JAX package's eval/evaluator.py (the reference's
tools/engine/evaluator.py and its SegEvaluator subclasses). Protocol
(whole_eval, evaluator.py:206-225 + val_func_process :297-318): normalize ->
forward (full-resolution logits) -> probabilities exp(log_softmax) -> optional
flip TTA (probabilities of the flipped image, flipped back, summed) ->
optional multi-scale (probabilities resized back to full resolution with
cv2's half-pixel sampling and summed) -> argmax (first maximum) -> confusion
hist.

At single scale the uint8 images and labels go to the device and only the
counts come back. Each batch is written once, straight from the samples,
into one of two reused host slots (pinned on a card, so the copies out of
it run without blocking the host); the labels keep their own integer dtype
where the ignore label fits it (uint8 with 255: every dataset of the package), and
the card widens them and normalises the images. Multi-scale resizes each
uint8 image on the host first, as the reference does. Sliding-window eval
accumulates crop probabilities on the host. The forward is any callable on
NHWC fp32 tensors on the evaluator's device, e.g.
`models.InferenceRunner(...).logits` (the hand-written kernels) or a plain
`DerivedNet`; the model holds its own weights.

With `mesh` (a `parallel.Mesh`) the items are sharded over the ranks as the
JAX package shards its batches: of each global batch of batch_size x world
items, rank r takes slots [r * batch_size, (r + 1) * batch_size), still
`batch_size` images a forward; the tail is padded with repeats whose labels
are all ignore, and a rank whose slots are all padding runs no forward (it
would count nothing). hist, correct and labeled are then summed over ranks,
so every rank returns the one-rank result.

With `spatial=True` (and a mesh) each image is split over H across the ranks
instead, the batch-1 full-resolution protocol of the JAX package's spatial
axis (its evaluator.py:47-77). Every rank walks every item and keeps its
block of rows: the image's rows are partitioned into contiguous blocks
starting at multiples of the forward's `row_multiple`
(`parallel.spatial.partition`), the rank normalises its block, runs the
forward on it and, for the flip TTA, on its block flipped along W (W is
whole on every rank); at multi-scale each scaled image (resized whole on
the host) is partitioned by the same rule and the probabilities reach this
rank's block of full-resolution rows through the row-window form of the
half-pixel resize; then the argmax and the counts of its block of labels.
The counts are summed over ranks. The forward is spatial-aware: it takes
this rank's `parallel.spatial.Block` of the normalised images (its rows,
the partition and the exchange; e.g. `InferenceRunner(...).logits`) and
returns its Block of the logits; blocks start at multiples of its
`row_multiple` (of the forward, or of the object a bound method belongs
to, such as the runner; else 1). Sliding-window eval is not split.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..data.preprocess import _resize, eval_preprocess, pad_image_to_shape
from ..kernels import resolve_device
from ..ops.resize import (in_float64, resize_bilinear_halfpixel,
                          resize_bilinear_halfpixel_rows)
from ..parallel.spatial import Block, Exchange, partition
from ..utils import profiling
from .metrics import compute_score, hist_stats


@dataclasses.dataclass
class EvalResult:
    mean_iu: float
    iou_per_class: np.ndarray
    pixel_acc: float
    hist: np.ndarray

    def __str__(self):
        return f"mIoU {self.mean_iu*100:.2f}% acc {self.pixel_acc*100:.2f}%"


# label dtypes uploaded as they are where the ignore label fits them; any
# other is cast to int32 on the host
_NARROW_LABELS = tuple(np.dtype(t) for t in (np.uint8, np.int8, np.int16,
                                             np.int32))


def _label_dtype(dtype, ignore_label: int) -> np.dtype:
    """The dtype in which labels of `dtype` go to the device: their own
    where it is an integer dtype of at most 32 bits that holds
    `ignore_label` (the padded tail's value), else int32."""
    dtype = np.dtype(dtype)
    if dtype in _NARROW_LABELS:
        info = np.iinfo(dtype)
        if info.min <= ignore_label <= info.max:
            return dtype
    return np.dtype(np.int32)


def _fill(dst: np.ndarray, arrays) -> None:
    """Copy each of `arrays` into a row of `dst`, cast as `astype` casts;
    each has a row's shape, as `np.stack` would insist."""
    for row, a in zip(dst, arrays):
        if a.shape != row.shape:
            raise ValueError(f"a batch mixes the shapes {a.shape} and "
                             f"{row.shape}")
        np.copyto(row, a, casting="unsafe")


class _Slot:
    """One batch's host arrays by name, pinned on a card, kept while their
    shape and dtype hold; and the event recorded after the copies out of
    them (none on the CPU, where a copy is done when it returns)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self.host = {}
        self.event = torch.cuda.Event() if self.pinned else None

    def array(self, name: str, shape, dtype) -> np.ndarray:
        """The slot's host array `name` of `shape` and `dtype`, allocated
        anew only when they change."""
        t = self.host.get(name)
        if t is None or t[1].shape != shape or t[1].dtype != dtype:
            host = torch.from_numpy(np.empty(shape, dtype))
            if self.pinned:
                host = host.pin_memory()
            t = self.host[name] = (host, host.numpy())
        return t[1]

    def send(self, *names: str):
        """Copy the arrays `names` to the device without blocking, then
        record the event; returns the device tensors. Counter
        `eval.upload_bytes`."""
        out = []
        for name in names:
            host = self.host[name][0]
            out.append(host.to(self.device, non_blocking=True))
            profiling.count("eval.upload_bytes", host.nbytes)
        if self.event is not None:
            self.event.record(torch.cuda.current_stream(self.device))
        return out

    def wait(self) -> None:
        """Return once the copies out of the slot have run: only then may
        the host write it again. Counter `eval.stage_wait`, span
        `eval.copy` around the wait."""
        if self.event is not None and not self.event.query():
            profiling.count("eval.stage_wait")
            with profiling.span("eval.copy"):
                self.event.synchronize()


def probabilities(logits: torch.Tensor) -> torch.Tensor:
    """exp(log_softmax) over the last axis in fp32: the probabilities the
    reference's val_func_process takes (torch.exp of its log-softmax
    output), rounded as the JAX protocol rounds them."""
    return torch.exp(torch.log_softmax(logits.float(), -1))


class Evaluator:
    """forward_fn(images NHWC fp32 on `device`) -> logits (N, H, W, C) at
    the input resolution. `device` defaults to CUDA and raises where there
    is none; tests pass "cpu". `mesh` shards the items over ranks (the
    forward runs on the mesh's device); with `spatial` it splits each image
    over H across them instead, and the forward takes and returns a
    `parallel.spatial.Block` (module docstring)."""

    def __init__(self, dataset, num_classes: int, image_mean, image_std,
                 forward_fn: Callable[[torch.Tensor], torch.Tensor],
                 eval_scales: Sequence[float] = (1.0,),
                 eval_flip: bool = False, batch_size: int = 1,
                 ignore_label: int = 255,
                 device: Union[str, torch.device] = "cuda",
                 mesh=None, spatial: bool = False):
        if spatial and mesh is None:
            raise ValueError("spatial evaluation splits images over the "
                             "ranks of a mesh: pass one")
        if mesh is not None:
            device = mesh.device
        self.mesh = mesh
        self.spatial = spatial
        # the row exchanges of a spatial forward, with their counts
        self.exchange = Exchange(mesh) if spatial else None
        self.row_multiple = getattr(getattr(forward_fn, "__self__",
                                            forward_fn), "row_multiple", 1)
        self.dataset = dataset
        self.num_classes = num_classes
        self.image_mean = image_mean
        self.image_std = image_std
        self.forward_fn = forward_fn
        self.eval_scales = tuple(eval_scales)
        self.eval_flip = eval_flip
        self.batch_size = batch_size
        self.ignore_label = ignore_label
        self.device = resolve_device(device)
        self._mean = torch.tensor(image_mean, dtype=torch.float32,
                                  device=self.device)
        self._std = torch.tensor(image_std, dtype=torch.float32,
                                 device=self.device)
        # two slots: a batch is written while the previous one's copies run
        self._slots = [_Slot(self.device) for _ in range(2)]

    # ---- device programs ----

    def _forward(self, x: torch.Tensor, part) -> torch.Tensor:
        """The forward's logits of images x, or with `part` of this rank's
        block x of images whose rows split as `part`."""
        if part is None:
            return self.forward_fn(x)
        return self.forward_fn(Block(x, part, self.exchange)).t

    def _probs(self, x: torch.Tensor, part=None) -> torch.Tensor:
        """Normalized images (or this rank's block of them, `part`) ->
        summed probabilities, with the flip TTA (val_func_process,
        evaluator.py:297-318). Spans: `eval.forward`, `eval.score`."""
        with profiling.span("eval.forward"):
            logits = self._forward(x, part)
        with profiling.span("eval.score"):
            p = probabilities(logits)
        del logits
        if self.eval_flip:
            with profiling.span("eval.forward"):
                lf = self._forward(torch.flip(x, [2]), part)
            with profiling.span("eval.score"):
                p = p + torch.flip(probabilities(lf), [2])
        return p

    def _partition(self, height: int):
        """How a spatial evaluation splits `height` rows (else None)."""
        return (partition(height, self.mesh.world, self.row_multiple)
                if self.spatial else None)

    def _rows(self, a: np.ndarray) -> np.ndarray:
        """This rank's block of rows of (N, H, ...) images or labels in a
        spatial evaluation, else all of them."""
        if not self.spatial:
            return a
        lo, hi = self._partition(a.shape[1]).block(self.mesh.rank)
        return a[:, lo:hi]

    def _fused_eval(self, x: torch.Tensor, labels: torch.Tensor, part=None):
        """Single scale: normalised images (or this rank's block of them)
        and their labels on the device -> (hist, labeled, correct), all
        computed there."""
        p = self._probs(x, part)
        with profiling.span("eval.score"):
            pred = torch.argmax(p, dim=-1).int()
            return hist_stats(pred, labels, self.num_classes,
                              self.ignore_label)

    # ---- host protocol ----

    @torch.inference_mode()
    def _predict_whole(self, imgs: np.ndarray) -> torch.Tensor:
        """Multi-scale whole-image prediction -> int32 class map (N, H, W)
        on the device (spatial: this rank's rows of it). Per scale: host
        resize of the uint8 images, then the probabilities resized to full
        resolution on the device and summed; one argmax at the end."""
        H, W = imgs.shape[1], imgs.shape[2]
        full = self._partition(H)
        acc = None
        for scale in self.eval_scales:
            sh, sw = int(H * scale), int(W * scale)
            with profiling.span("eval.upload"):
                batch = self._rows(np.stack([
                    eval_preprocess(
                        _resize(im, (sw, sh), nearest=False)
                        if scale != 1.0 else im,
                        self.image_mean, self.image_std)
                    for im in imgs]))
                with profiling.span("eval.copy"):
                    x = torch.from_numpy(batch).to(self.device)
                profiling.count("eval.upload_bytes", batch.nbytes)
            part = self._partition(sh)
            p = self._probs(x, part)
            with profiling.span("eval.score"):
                if (sh, sw) != (H, W):
                    # in float64: a block's rows get the whole map's bits
                    p = (in_float64(resize_bilinear_halfpixel, p, (H, W))
                         if part is None else
                         in_float64(resize_bilinear_halfpixel_rows,
                                    Block(p, part, self.exchange), (H, W),
                                    full).t)
                acc = p if acc is None else acc + p
        with profiling.span("eval.score"):
            return torch.argmax(acc, dim=-1).int()

    @torch.inference_mode()
    def run(self, max_items: Optional[int] = None) -> EvalResult:
        """Whole-image eval over the dataset, `batch_size` images a forward;
        the tail batch is padded with repeats whose labels are all
        `ignore_label`, so they count nothing. With a mesh, this rank's
        share of the items, the counts summed over ranks; spatial, every
        item, this rank's rows of each.

        Spans (utils/profiling.py): the pass is the unit `eval.run`; each
        batch's `eval.upload` (the samples written into the batch's host
        slot, the images normalised on the device; counters
        `eval.upload_bytes`, `eval.upload_staged` a batch and
        `eval.stage_wait` a wait on the slot) with its child `eval.copy`
        (the copies to the device, and any wait for the slot's earlier
        copies), `eval.forward` and `eval.score` (probabilities, argmax,
        counts); `eval.readback` (the counts summed over ranks and read to
        the host, the score)."""
        with profiling.span("eval.run"):
            return self._run(max_items)

    def _run(self, max_items: Optional[int]) -> EvalResult:
        n_total = min(len(self.dataset), max_items or len(self.dataset))
        batch = self.batch_size
        rank, world = ((0, 1) if self.mesh is None or self.spatial
                       else (self.mesh.rank, self.mesh.world))
        n = self.num_classes
        hist = torch.zeros((n, n), dtype=torch.int64, device=self.device)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        labeled = torch.zeros((), dtype=torch.int64, device=self.device)
        # the reference default, a single scale, runs on the device from the
        # uint8 images on; multi-scale resizes its inputs on the host
        fused = self.eval_scales == (1.0,)
        ring = 0
        for i in range(rank * batch, n_total, batch * world):
            with profiling.span("eval.upload"):
                idxs = list(range(i, min(i + batch, n_total)))
                n_real = len(idxs)
                idxs += [idxs[-1]] * (batch - n_real)
                samples = [self.dataset[k] for k in idxs]
                height = samples[0]["data"].shape[0]
                labels = [self._rows(s["label"][None])[0]
                          for s in samples[:n_real]]
                slot = self._slots[ring]
                ring = (ring + 1) % len(self._slots)
                slot.wait()
                profiling.count("eval.upload_staged")
                lab = slot.array("label", (batch, *labels[0].shape),
                                 _label_dtype(np.result_type(*labels),
                                             self.ignore_label))
                _fill(lab, labels)
                lab[n_real:] = self.ignore_label
                if fused:
                    rows = [self._rows(s["data"][None])[0] for s in samples]
                    _fill(slot.array("data", (batch, *rows[0].shape),
                                     np.uint8), rows)
                    with profiling.span("eval.copy"):
                        lb, xb = slot.send("label", "data")
                    x = (xb.float() / 255.0 - self._mean) / self._std
                else:
                    imgs = np.stack([s["data"] for s in samples])
                    with profiling.span("eval.copy"):
                        lb, = slot.send("label")
            if fused:
                h, l, c = self._fused_eval(x, lb, self._partition(height))
            else:
                wh = self._predict_whole(imgs)
                with profiling.span("eval.score"):
                    h, l, c = hist_stats(wh, lb, self.num_classes,
                                         self.ignore_label)
            hist += h
            correct += c
            labeled += l
        with profiling.span("eval.readback"):
            if self.mesh is not None:
                counts = self.mesh.all_reduce_(torch.cat(
                    [hist.reshape(-1), correct[None], labeled[None]]))
                hist = counts[:n * n].reshape(n, n)
                correct, labeled = counts[n * n], counts[n * n + 1]
            hist = hist.cpu().numpy()
            correct, labeled = int(correct), int(labeled)
            iou, mean_iu, _, _ = compute_score(hist, correct, labeled)
        return EvalResult(mean_iu=mean_iu, iou_per_class=np.asarray(iou),
                          pixel_acc=correct / max(labeled, 1), hist=hist)

    # ---- sliding-window protocol (evaluator.py:228-295) ----

    @torch.inference_mode()
    def sliding_eval(self, img: np.ndarray, crop_size: int,
                     stride_rate: float = 5.0 / 6) -> np.ndarray:
        """Crop-grid eval for images larger than the network input: the
        image is centre-padded to at least one crop, crops step by
        ceil(crop * stride_rate), and their probabilities are averaged on
        the host. Returns the int32 class map (H, W)."""
        H, W = img.shape[:2]
        img_pad, margin = pad_image_to_shape(img, (max(H, crop_size),
                                                   max(W, crop_size)), 0)
        ph, pw = img_pad.shape[:2]
        acc = np.zeros((ph, pw, self.num_classes), np.float32)
        count = np.zeros((ph, pw, 1), np.float32)
        stride = int(np.ceil(crop_size * stride_rate))
        rows = int(np.ceil(max(ph - crop_size, 0) / stride)) + 1
        cols = int(np.ceil(max(pw - crop_size, 0) / stride)) + 1
        for r in range(rows):
            for c in range(cols):
                y = min(r * stride, ph - crop_size)
                x = min(c * stride, pw - crop_size)
                crop = img_pad[y:y + crop_size, x:x + crop_size]
                batch = eval_preprocess(crop, self.image_mean,
                                        self.image_std)[None]
                p = self._probs(torch.from_numpy(batch).to(self.device))
                acc[y:y + crop_size, x:x + crop_size] += p[0].cpu().numpy()
                count[y:y + crop_size, x:x + crop_size] += 1
        acc = acc[margin[0]:margin[0] + H, margin[2]:margin[2] + W]
        count = count[margin[0]:margin[0] + H, margin[2]:margin[2] + W]
        return np.argmax(acc / np.maximum(count, 1), -1).astype(np.int32)
