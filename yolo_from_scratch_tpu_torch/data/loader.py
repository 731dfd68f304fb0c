"""Batched data loader with background prefetch: the port's copy of
`yolo_from_scratch_tpu/data/loader.py` (`DataLoader`), single-process.

A background thread prepares the next batch (decode, letterbox, dense
target assignment or compact labels, stacking) while the card runs the
current step. Batches are numpy; `data/device_queue.py` moves them to the
device.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class DataLoader:
    """Minimal shuffling/batching loader over a YoloDataset-like object.

    Yields (images (B, S, S, 3) float32, [t_p3, t_p4, t_p5]) per batch,
    each target stacked to (B, gs, gs, A, 5+nc), or (B, gs, gs, 5+nc) for
    the anchor-free head's dataset; with `compact` = K > 0, (images uint8,
    (labels (B, K, 5), counts (B,))) from `load_batch_compact`, the
    on-device assignment path (~1.3 KB of labels an image at K=64 instead
    of the dense maps). The final partial batch is kept (reference
    DataLoader default drop_last=False).
    """

    def __init__(self, dataset, batch_size=8, shuffle=False, seed=0,
                 prefetch=2, compact=0):
        self.compact = compact
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            yield idx[i : i + self.batch_size]

    def _make_batch(self, indices):
        if self.compact:
            images, labels, counts = self.dataset.load_batch_compact(
                indices, capacity=self.compact)
            return images, (labels, counts)
        # dataset-provided batch fast path when present
        load_batch = getattr(self.dataset, "load_batch", None)
        if load_batch is not None:
            return load_batch(indices)
        imgs, tgts = [], []
        for i in indices:
            img, t = self.dataset[int(i)]
            imgs.append(img)
            tgts.append(t)
        images = np.stack(imgs).astype(np.float32)
        targets = [
            np.stack([t[s] for t in tgts]).astype(np.float32)
            for s in range(3)
        ]
        return images, targets

    def __iter__(self):
        if self.prefetch <= 0:
            for indices in self._batch_indices():
                yield self._make_batch(indices)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        _SENTINEL = object()
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded put that aborts if the consumer went away, so an
            abandoned iterator can't leave this thread blocked forever."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for indices in self._batch_indices():
                    if not _put(self._make_batch(indices)):
                        return
            except BaseException as e:  # surface decode errors to consumer
                _put(e)
            else:
                # the sentinel MUST eventually land (blocking put with
                # stop-check) or the consumer would hang at epoch end
                _put(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer's pending put can observe the stop flag
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)
