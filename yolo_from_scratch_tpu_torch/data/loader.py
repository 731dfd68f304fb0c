"""Batched data loader with background prefetch: the port's copy of
`yolo_from_scratch_tpu/data/loader.py` (`shard_indices`, `DataLoader`),
held bit-equal to it (`tests/test_torch_parallel.py`).

A background thread prepares the next batch (decode, letterbox, dense
target assignment or compact labels, stacking; the dataset's batch fast
path, the native loader's threaded decode when its backend is native)
while the card runs the current step. Batches are numpy;
`data/device_queue.py` moves them to the device. With `process_shard`
each process of a data-parallel run loads its strided slice of every
epoch permutation (`parallel/distributed.py`).
"""

from __future__ import annotations

import queue
import threading

import numpy as np


def shard_indices(idx: np.ndarray, process_index: int,
                  process_count: int) -> np.ndarray:
    """This process's strided slice of an epoch permutation, padded (by
    wrapping) so EVERY process gets exactly ceil(n / pc) items.

    Strided (not contiguous) so that with a shuffle seed shared across
    processes every process permutes identically and the shards stay
    disjoint. The wrap-pad matters in a data-parallel run: every process
    must issue the same number of identically-shaped steps or the
    gradient collectives deadlock; a bare [pi::pc] slice gives shards
    whose sizes differ by one when pc does not divide n."""
    n, pc = len(idx), process_count
    per = -(-n // pc)  # ceil
    if n % pc:
        idx = np.resize(idx, pc * per)  # cyclic tile
    return idx[process_index::pc]


class DataLoader:
    """Minimal shuffling/batching loader over a YoloDataset-like object.

    Yields (images (B, S, S, 3) float32, [t_p3, t_p4, t_p5]) per batch,
    each target stacked to (B, gs, gs, A, 5+nc), or (B, gs, gs, 5+nc) for
    the anchor-free head's dataset; with `compact` = K > 0, (images uint8,
    (labels (B, K, 5), counts (B,))) from `load_batch_compact`, the
    on-device assignment path (~1.3 KB of labels an image at K=64 instead
    of the dense maps). The final partial batch is kept (reference
    DataLoader default drop_last=False).

    `process_shard` = (process_index, process_count): this loader yields
    only the strided slice [pi::pc] of each (identically seeded, hence
    identically shuffled) epoch permutation, so `batch_size` is the
    per-process batch; the slice is wrap-padded to equal sizes and
    cyclically tiled to a full last batch, so that every process takes
    the same number of equal steps. `pad_shard=False` keeps the bare
    slice instead (evaluation, where no collective runs a batch and a
    padded image would be counted twice).

    `pack_images`: the images space-to-depth packed 4x (`models/packed.py::
    pack_s2d_host`, (B, S/4, S/4, 48)) for a packed model, on the prefetch
    thread with the rest of the batch's preparation.
    """

    def __init__(self, dataset, batch_size=8, shuffle=False, seed=0,
                 prefetch=2, compact=0, process_shard=None, pad_shard=True,
                 pack_images=False):
        self.compact = compact
        self.pack_images = pack_images
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.process_shard = process_shard
        self.pad_shard = pad_shard
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self._epoch_indices(shuffled=False))
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self, shuffled=True):
        idx = np.arange(len(self.dataset))
        if self.shuffle and shuffled:
            self._rng.shuffle(idx)
        if self.process_shard is not None:
            pi, pc = self.process_shard
            if not self.pad_shard:
                return idx[pi::pc]
            # equal shard sizes AND a full final batch on every process:
            # data-parallel steps are collective, so all processes must
            # yield the same number of identically-sized batches
            idx = shard_indices(idx, pi, pc)
            if len(idx) % self.batch_size:
                # np.resize tiles cyclically: handles shards smaller than
                # a single batch too
                idx = np.resize(
                    idx, -(-len(idx) // self.batch_size) * self.batch_size)
        return idx

    def _batch_indices(self):
        idx = self._epoch_indices()
        for i in range(0, len(idx), self.batch_size):
            yield idx[i : i + self.batch_size]

    def _make_batch(self, indices):
        images, targets = self._load(indices)
        if self.pack_images:
            from yolo_from_scratch_tpu_torch.data.letterbox import (
                pack_s2d_host,
            )

            images = pack_s2d_host(images)
        return images, targets

    def _load(self, indices):
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
