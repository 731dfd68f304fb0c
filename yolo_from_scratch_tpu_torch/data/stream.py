"""Epoch streaming from the on-disk cache (`data/cache.py`) into the
scanned trainers (counterpart of `yolo_from_scratch_tpu/data/stream.py`),
with an optional device-resident sample pool for hosts whose ingest link
is slower than the card.

ChunkStream: a background thread gathers chunk k+1 (N steps x B images)
from the memmap into pinned memory and uploads it on its own CUDA stream
while the card runs chunk k; it records an event, and the consumer's
stream waits on that event before the trainer copies the chunk into its
graph's inputs. The queue holds two chunks, so about three are resident
on the card: a dataset of any size trains in O(chunk) device memory. On
the CPU the chunks are the gathered host arrays. In a job of several
processes (`process_shard`) every process walks the same permutation of
the cache in steps of the global batch and gathers and uploads only its
columns of each step, as the JAX package's stream places a chunk with
`P(None, DATA_AXIS)`.

PoolStream: the same cache feeding a pool of P images that lives on the
card as three tensors. Each step gathers its batch from the pool by index
(`train/steps.py::make_train_step_multi_pool`; the indices come from the
same numpy generator as the JAX package's), while a persistent background
thread stages slabs of fresh images from the cache, and the consumer
writes each finished slab into its pool slots in place, on the trainer's
stream, between dispatches: a shuffle buffer with data echoing (Choi et
al., 2019, arXiv:1907.05550). Both the trained-sample rate and the
fresh-ingest rate are reported.

Both feed the cache's images as they lie on disk: the packed (n, S/4,
S/4, 48) slabs of a packed cache (`data/cache.py`, `packed=True`) go to a
packed model's trainer unchanged.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch


def _epoch_chunks(n, chunk_images, shuffle, rng):
    """Epoch permutation split into equal chunks of `chunk_images`,
    wrap-padded (cyclic tile) so every chunk, hence every captured graph,
    has the same static shape."""
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    total = -(-n // chunk_images) * chunk_images
    if total != n:
        idx = np.resize(idx, total)
    return [idx[i : i + chunk_images] for i in range(0, total, chunk_images)]


class _Stager:
    """Rows of host arrays onto `device`: on a card, gathered straight into
    pinned memory and uploaded on a stream of this stager's own, with an
    event recorded after the uploads; on the CPU, gathered host tensors."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def put(self, arrays, rows, lead=None):
        """(tensors, event or None): `rows` of each array (a memmap or an
        ndarray), reshaped to `lead` + the row shape when given."""
        host = []
        for a in arrays:
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            t = torch.empty((len(rows), *a.shape[1:]), dtype=dtype,
                            pin_memory=self.stream is not None)
            # mode "clip" writes into `out` unbuffered; rows are in range
            np.take(a, rows, axis=0, out=t.numpy(), mode="clip")
            host.append(t if lead is None else t.reshape(*lead, *a.shape[1:]))
        if self.stream is None:
            return host, None
        with torch.cuda.stream(self.stream):
            staged = [t.to(self.device, non_blocking=True) for t in host]
            event = torch.cuda.Event()
            event.record()
        return staged, event

    @staticmethod
    def take(tensors, event):
        """Make the current stream wait for a staged upload and hand the
        tensors over to it (the allocator keeps their memory until the
        current stream's work on them is done)."""
        if event is None:
            return tensors
        stream = torch.cuda.current_stream()
        stream.wait_event(event)
        for t in tensors:
            t.record_stream(stream)
        return tensors


def _means(metrics_acc):
    """Epoch means of per-chunk metric dicts (one host sync)."""
    if not metrics_acc:
        return {}
    keys = list(metrics_acc[0])
    rows = torch.stack([torch.stack([m[k] for k in keys])
                        for m in metrics_acc]).cpu().numpy()
    n = max(len(metrics_acc), 1)
    # float32 running sums, as the JAX streams add float32 scalars
    return {k: float(sum(rows[:, j])) / n for j, k in enumerate(keys)}


class ChunkStream:
    """Iterate device-resident (images (N, B, S, S, 3), or the cache's
    packed (N, B, S/4, S/4, 48), labels (N, B, K, 5), counts (N, B)) chunks
    over an ImageCache, one chunk ahead of the consumer.

    `process_shard` (index, count): this process's part of a job of
    `count` processes, each with `batch_size` images a step, so that a
    step's global batch is batch_size x count. Every process draws the
    same permutation from `seed` and takes columns [index * batch_size,
    (index + 1) * batch_size) of each step's global batch."""

    def __init__(self, cache, batch_size=8, steps_per_chunk=16,
                 shuffle=True, seed=0, device="cuda", process_shard=None):
        self.cache = cache
        self.batch_size = batch_size
        self.steps_per_chunk = steps_per_chunk
        self.shuffle = shuffle
        self.device = torch.device(device)
        self.shard = process_shard or (0, 1)
        self._rng = np.random.default_rng(seed)

    @property
    def global_batch(self):
        return self.batch_size * self.shard[1]

    @property
    def steps_per_epoch(self):
        per = self.global_batch * self.steps_per_chunk
        return -(-len(self.cache) // per) * self.steps_per_chunk

    @property
    def images_per_epoch(self):
        """This process's images an epoch."""
        return self.steps_per_epoch * self.batch_size

    def _gather(self, stager, idx):
        c = self.cache
        b, index = self.batch_size, self.shard[0]
        idx = idx.reshape(self.steps_per_chunk, self.global_batch)
        idx = idx[:, index * b:(index + 1) * b].reshape(-1)
        return stager.put((c.images, c.labels, c.counts), idx,
                          lead=(self.steps_per_chunk, b))

    def __iter__(self):
        """One epoch of staged chunks (gather and upload run one chunk
        ahead on a background thread)."""
        chunks = _epoch_chunks(
            len(self.cache), self.global_batch * self.steps_per_chunk,
            self.shuffle, self._rng)
        stager = _Stager(self.device)
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()
        sentinel = object()

        def producer():
            try:
                for idx in chunks:
                    staged = self._gather(stager, idx)
                    while not stop.is_set():
                        try:
                            q.put(staged, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    else:
                        return
            except BaseException as e:  # surface IO errors to the consumer
                q.put(e)
            else:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield tuple(_Stager.take(*item))
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)

    def run_epoch(self, trainer, state):
        """One epoch through the scanned trainer. Returns (state,
        metrics_means: dict, n_images, seconds)."""
        metrics_acc = []
        t0 = time.perf_counter()
        for images, labels, counts in self:
            state, metrics = trainer(state, images, labels, counts)
            metrics_acc.append(metrics)
        means = _means(metrics_acc)
        return state, means, self.images_per_epoch, time.perf_counter() - t0


class PoolStream:
    """Device-resident sample pool over an ImageCache with background
    refresh. `run_epoch` drives the pool-sampling trainer
    (`train/steps.py::make_train_step_multi_pool`) for the step count a
    plain epoch would take, while a refresh thread cycles the cache's
    images through the pool's slots at the link's rate."""

    def __init__(self, cache, pool_size=1024, batch_size=8,
                 steps_per_chunk=16, seed=0, refresh_slab=128,
                 device="cuda", max_ingest_img_s=None,
                 clock=time.perf_counter):
        """`max_ingest_img_s`: optional ceiling on the refresher's ingest
        rate (images a second), which forces a chosen echo factor (trained
        rate / ingest rate) instead of the one the link sets. `clock`: the
        refresher's time source (seconds), for the cap's schedule."""
        if pool_size > len(cache):
            pool_size = len(cache)
        # the slab divides the pool, so slot writes never wrap
        while pool_size % refresh_slab:
            refresh_slab //= 2
        self.cache = cache
        self.pool_size = pool_size
        self.batch_size = batch_size
        self.steps_per_chunk = steps_per_chunk
        self.refresh_slab = refresh_slab
        self.max_ingest_img_s = max_ingest_img_s
        self.device = torch.device(device)
        self.clock = clock
        self._rng = np.random.default_rng(seed)
        self._cursor = pool_size  # next cache row to ingest
        self._slot = 0  # next pool slot to overwrite
        self._epoch_ingested = 0
        self.total_ingested = 0
        self._stager = _Stager(self.device)
        self._init_pool()
        # one persistent refresher: staging a slab through a slow link can
        # take longer than a short epoch, and a per-epoch thread would drop
        # its partial slab at every epoch's end, so the pool would never
        # refresh; run_epoch drains whatever slabs completed
        self._slab_q: queue.Queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- pool construction / refresh ------------------------------------

    def _init_pool(self):
        c, p = self.cache, self.pool_size
        # copies: the slab writer updates the pool in place, and the cache's
        # images are a read-only memmap
        self.pool = tuple(torch.from_numpy(np.array(a)).to(self.device)
                          for a in (c.images[:p], c.labels[:p], c.counts[:p]))

    def _stage_slab(self):
        """Read the next sequential slab from the cache and start its
        upload; returns (staged, event, slot). Sequential reads keep the
        memmap's access pattern friendly to the page cache."""
        c, s = self.cache, self.refresh_slab
        rows = np.arange(self._cursor, self._cursor + s) % len(c)
        self._cursor = int((self._cursor + s) % len(c))
        slot = self._slot
        self._slot = (self._slot + s) % self.pool_size
        staged, event = self._stager.put((c.images, c.labels, c.counts), rows)
        return staged, event, slot

    def _apply_slab(self, staged, event, slot):
        """Write a staged slab into its pool slots in place, on the current
        stream (the trainer's): a captured graph reads the pool where it
        lies."""
        for dst, src in zip(self.pool, _Stager.take(staged, event)):
            dst[slot : slot + self.refresh_slab].copy_(src)
        self._epoch_ingested += self.refresh_slab
        self.total_ingested += self.refresh_slab

    # -- training ---------------------------------------------------------

    @property
    def steps_per_epoch(self):
        per = self.batch_size * self.steps_per_chunk
        return -(-len(self.cache) // per) * self.steps_per_chunk

    @property
    def images_per_epoch(self):
        return self.steps_per_epoch * self.batch_size

    def _ensure_refresher(self):
        t = self._thread
        if t is not None:
            if not self._stop.is_set() and t.is_alive():
                return
            # a stop() that timed out may have left the thread mid-slab;
            # wait for it BEFORE clearing the stop event, or it would
            # resume and race a new refresher on the cursor and slot
            t.join()
            self._thread = None

        def refresher():
            t_start = self.clock()
            staged_imgs = 0
            while not self._stop.is_set():
                if self.max_ingest_img_s:
                    # stage slab k only when the capped schedule says its
                    # images are due
                    due = staged_imgs / self.max_ingest_img_s
                    while (not self._stop.is_set()
                           and self.clock() - t_start < due):
                        self._stop.wait(0.1)
                    if self._stop.is_set():
                        return
                staged = self._stage_slab()
                staged_imgs += self.refresh_slab
                # bounded put, so a shutdown cannot deadlock on a full queue
                while not self._stop.is_set():
                    try:
                        self._slab_q.put(staged, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._stop.clear()
        self._thread = threading.Thread(target=refresher, daemon=True)
        self._thread.start()

    def stop(self):
        """Stop the background refresher (after the last epoch, so it stops
        staging uploads during evaluation and checkpointing)."""
        self._stop.set()
        try:
            while True:
                self._slab_q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            if not self._thread.is_alive():
                self._thread = None
            # else keep the handle: _ensure_refresher joins it before it
            # starts another, so two refreshers never share the cursor

    def run_epoch(self, trainer, state):
        """One epoch (the step count of a plain epoch over the cache):
        dispatch chunks that sample from the pool, and between dispatches
        write in the slabs the refresher staged. Returns (state,
        metrics_means with ingest_img_s, n_images, seconds)."""
        n_chunks = self.steps_per_epoch // self.steps_per_chunk
        self._epoch_ingested = 0
        self._ensure_refresher()
        metrics_acc = []
        t0 = time.perf_counter()
        try:
            for _ in range(n_chunks):
                idx = self._rng.integers(
                    0, self.pool_size,
                    (self.steps_per_chunk, self.batch_size), np.int32)
                idx = torch.from_numpy(idx).to(self.device)
                state, metrics = trainer(state, *self.pool, idx)
                metrics_acc.append(metrics)
                # every slab that finished while the chunk ran
                try:
                    while True:
                        self._apply_slab(*self._slab_q.get_nowait())
                except queue.Empty:
                    pass
        except BaseException:
            # a failing trainer must not leave the persistent refresher
            # staging uploads for the rest of the process
            self.stop()
            raise
        means = _means(metrics_acc)
        dt = time.perf_counter() - t0
        means["ingest_img_s"] = self._epoch_ingested / max(dt, 1e-9)
        return state, means, self.images_per_epoch, dt
