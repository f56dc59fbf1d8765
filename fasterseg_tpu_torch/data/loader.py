"""Host-side training data loader: deterministic, prefetched, NHWC numpy.

Counterpart of the JAX package's data/loader.py, which replaces the
reference's DataLoader worker processes (search/dataloader.py:34-57) with a
thread that prepares batches ahead of the device step. That thread prepares
a batch's slots at once on a pool of threads: `TrainPre`'s native kernels
are called through ctypes, which releases the GIL, so the slots' resizes,
crops and normalisations run in parallel. Every sample's augmentation is
keyed by (seed, epoch, step, slot) instead of process RNG state, and each
result is placed by its slot index, so a batch is a pure function of its
position whatever the pool's schedule, and `seek` resumes a run exactly;
the port's batches equal the JAX package's for a seed.

`get_train_loader` keeps the reference's API shape, including the `portion`
split that carves disjoint halves for the weight/arch bi-level optimization
(train_search.py:109-112).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np

from .preprocess import TrainPre


class TrainLoader:
    """Infinite iterator of (images NHWC float32, labels NHW int32)."""

    def __init__(self, dataset, preprocess: TrainPre, batch_size: int,
                 seed: int = 0, shuffle: bool = True, prefetch: int = 2):
        self.dataset = dataset
        self.preprocess = preprocess
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.prefetch = prefetch
        self._stop = threading.Event()
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._start_epoch = 0
        # slot workers: one a slot, at most one a core
        self.pool_size = max(1, min(batch_size, os.cpu_count() or 1))
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()

    def __len__(self):
        return max(1, len(self.dataset) // self.batch_size)

    def _slot_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    self.pool_size, thread_name_prefix="train-slot")
            return self._pool

    def seek(self, epoch: int):
        """Restart batch production at (epoch, step 0).

        Batches are a pure function of (seed, epoch, step, slot), so seeking
        to a checkpoint's epoch reproduces the batches an unbroken run would
        see. Train loops call this at every epoch start."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10)
            self._queue = queue.Queue(maxsize=self.prefetch)
            self._stop = threading.Event()
            self._thread = None
        self._start_epoch = epoch

    def make_batch(self, epoch: int, step: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """The batch at (epoch, step), computed here (no prefetch), its
        slots prepared at once on the slot pool."""
        n = len(self.dataset)
        order_rng = np.random.default_rng((self.seed, epoch))
        order = (order_rng.permutation(n) if self.shuffle
                 else np.arange(n))

        def slot_sample(slot: int):
            idx = int(order[(step * self.batch_size + slot) % n])
            sample = self.dataset[idx]
            rng = np.random.default_rng((self.seed, epoch, step, slot))
            return self.preprocess(rng, sample["data"], sample["label"])

        # map yields in slot order whatever order the slots finish in
        out = list(self._slot_pool().map(slot_sample, range(self.batch_size)))
        return (np.stack([img for img, _ in out]),
                np.stack([gt for _, gt in out]))

    def _worker(self, stop: threading.Event, out: "queue.Queue"):
        # stop and out are bound when the thread starts, not read from self:
        # if seek() times out joining a slow worker and replaces
        # self._stop / self._queue, the orphan keeps testing its own stop
        # event and filling its own (discarded) queue, so it can never put a
        # stale epoch's batch into the new worker's stream, which exact
        # resume depends on.
        epoch, step = self._start_epoch, 0
        steps_per_epoch = len(self)
        while not stop.is_set():
            batch = self.make_batch(epoch, step)
            while not stop.is_set():
                try:
                    out.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue
            step += 1
            if step >= steps_per_epoch:
                step = 0
                epoch += 1

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker, args=(self._stop, self._queue),
                daemon=True)
            self._thread.start()
        while True:
            yield self._queue.get()

    def close(self):
        """Stop the prefetch thread and wait for it, then for the slot
        pool's threads."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None


def get_train_loader(config, dataset_cls, portion: Optional[float] = None,
                     seed: Optional[int] = None, test: bool = False,
                     index_select=None) -> TrainLoader:
    """Reference-shaped constructor (search/dataloader.py:34-57,
    train/dataloader.py:34-47): dataset + TrainPre + loader.

    `config` is a core.config SearchConfig/TrainConfig; `portion` carves
    the head (+) or tail (-) fraction of the file list; `index_select`
    reorders it first (the search driver passes one shared permutation so
    the two portions form a balanced disjoint split)."""
    from .datasets import DataSetting, SyntheticDataset

    d = config.data
    pre = TrainPre(image_mean=d.image_mean, image_std=d.image_std,
                   crop_hw=(d.image_height, d.image_width),
                   train_scale_array=d.train_scale_array,
                   gt_down_sampling=d.gt_down_sampling,
                   ignore_label=d.ignore_label)
    if d.synthetic:
        dataset = SyntheticDataset(length=d.synthetic_length,
                                   hw=(d.image_height, d.image_width),
                                   num_classes=d.num_classes,
                                   portion=portion)
    else:
        source = d.train_eval_source if test else d.train_source
        setting = DataSetting(
            img_root=d.dataset_path, gt_root=d.dataset_path,
            train_source=os.path.join(d.dataset_path, source),
            eval_source=os.path.join(d.dataset_path, d.eval_source),
            test_source=os.path.join(d.dataset_path, d.test_source),
            down_sampling=d.down_sampling)
        dataset = dataset_cls(setting, "train", portion=portion,
                              index_select=index_select)
    return TrainLoader(dataset, pre, d.batch_size,
                       seed=seed if seed is not None else getattr(
                           config, "seed", 0))
