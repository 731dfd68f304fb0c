"""One-time on-disk training cache: pre-letterboxed uint8 images and
compact labels, memory-mapped for epoch streaming (counterpart of
`yolo_from_scratch_tpu/data/cache.py`; numpy only).

Decode and letterbox are deterministic for a (file, img_size), so the
first pass writes `images.u8`, a raw (n, S, S, 3) uint8 memmap, or with
`packed` the space-to-depth packed (n, S/4, S/4, 48) one for a packed
model (`models/packed.py::pack_s2d_host`), beside the compact labels
`labels.f32` (n, K, 5), `counts.i32` (n,) and `meta.json`; every later
epoch is a fancy index into the page cache away from the card. The files,
their layout and the directory name (`.yolo_tpu_cache_s{S}_k{K}_p{1|4}`)
are the JAX package's, so a cache written by either package opens in the
other.

The cache is keyed by content: a fingerprint over the sorted image paths,
sizes and mtimes is stored in meta.json and checked on open, so a changed
dataset rebuilds instead of serving stale pixels; a cache of the other
layout is not opened.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path

import numpy as np

CACHE_VERSION = 1
PACK_FACTOR = 4  # models/packed.py's


def dataset_fingerprint(img_paths) -> str:
    """Content fingerprint: sorted (path, size, mtime_ns) triples hashed.
    Stat-only, no pixel reads, so validation on open is O(n) stats."""
    h = hashlib.sha1()
    for p in sorted(img_paths):
        st = os.stat(p)
        h.update(f"{p}\x00{st.st_size}\x00{st.st_mtime_ns}\n".encode())
    return h.hexdigest()


def cache_dir_for(img_dir: str, img_size: int, capacity: int,
                  packed: bool = False, root: str | None = None) -> str:
    """Default cache location: a sibling of the images dir (it lives with
    the dataset, like the labels dir), keyed by layout."""
    base = Path(root) if root else Path(img_dir).parent
    pk = PACK_FACTOR if packed else 1
    return str(base / f".yolo_tpu_cache_s{img_size}_k{capacity}_p{pk}")


class ImageCache:
    """An opened cache: `images` is a read-only uint8 memmap (n, S, S, 3),
    or (n, S/4, S/4, 48) when `packed`; `labels` (n, K, 5) float32 and
    `counts` (n,) int32 are small and loaded into RAM."""

    def __init__(self, cache_dir: str, meta: dict):
        self.dir = cache_dir
        self.meta = meta
        self.n = meta["n"]
        self.img_size = meta["img_size"]
        self.capacity = meta["capacity"]
        self.packed = meta["packed"]
        shape = tuple(meta["image_shape"])
        self.images = np.memmap(Path(cache_dir) / "images.u8", np.uint8,
                                "r", shape=(self.n, *shape))
        self.labels = np.fromfile(
            Path(cache_dir) / "labels.f32", np.float32
        ).reshape(self.n, self.capacity, 5)
        self.counts = np.fromfile(Path(cache_dir) / "counts.i32", np.int32)
        if self.counts.shape != (self.n,):
            raise ValueError(f"counts.i32 holds {self.counts.shape[0]} rows, "
                             f"meta.json says {self.n}")

    @property
    def image_nbytes(self) -> int:
        return int(np.prod(self.images.shape[1:]))

    def __len__(self):
        return self.n


def open_cache(cache_dir: str, fingerprint: str | None = None,
               packed: bool | None = None):
    """Open an existing cache; None when it is missing, of another version,
    stale against `fingerprint`, or of the other layout than `packed`
    (when given)."""
    meta_path = Path(cache_dir) / "meta.json"
    try:
        meta = json.loads(meta_path.read_text())
    except (OSError, ValueError):
        return None
    if meta.get("version") != CACHE_VERSION:
        return None
    if packed is not None and bool(meta.get("packed")) != packed:
        return None
    if fingerprint is not None and meta.get("fingerprint") != fingerprint:
        return None
    try:
        return ImageCache(cache_dir, meta)
    except (OSError, ValueError, KeyError):
        return None


def build_cache(dataset, cache_dir: str, capacity: int = 64,
                packed: bool = False, batch: int = 64, log=print):
    """One-time pass: decode and letterbox every image through the
    dataset's `load_batch_compact` and persist the uint8 pixels and compact
    labels, the images packed with `packed`. Returns the opened
    ImageCache."""
    n = len(dataset)
    if n == 0:
        raise ValueError("cannot cache an empty dataset")
    s = dataset.img_size
    if packed:
        from yolo_from_scratch_tpu_torch.models.packed import pack_s2d_host

        shape = (s // PACK_FACTOR, s // PACK_FACTOR, 3 * PACK_FACTOR ** 2)
    else:
        shape = (s, s, 3)

    d = Path(cache_dir)
    d.mkdir(parents=True, exist_ok=True)
    images = np.memmap(d / "images.u8", np.uint8, "w+", shape=(n, *shape))
    labels = np.zeros((n, capacity, 5), np.float32)
    counts = np.zeros(n, np.int32)

    t0 = time.perf_counter()
    for i0 in range(0, n, batch):
        idx = list(range(i0, min(i0 + batch, n)))
        imgs, lab, cnt = dataset.load_batch_compact(
            idx, capacity=capacity, image_dtype="uint8")
        if packed:
            imgs = pack_s2d_host(imgs)
        images[i0 : i0 + len(idx)] = imgs
        labels[i0 : i0 + len(idx)] = lab
        counts[i0 : i0 + len(idx)] = cnt
        if log and (i0 // batch) % 16 == 0:
            rate = (i0 + len(idx)) / (time.perf_counter() - t0)
            log(f"  caching {i0 + len(idx)}/{n} images ({rate:.0f} img/s)",
                flush=True)
    images.flush()
    del images
    labels.tofile(d / "labels.f32")
    counts.tofile(d / "counts.i32")

    meta = {
        "version": CACHE_VERSION,
        "n": n,
        "img_size": s,
        "capacity": capacity,
        "packed": packed,
        "image_shape": list(shape),
        "fingerprint": dataset_fingerprint(dataset.imgs),
        "num_classes": dataset.num_classes,
    }
    (d / "meta.json").write_text(json.dumps(meta, indent=1))
    if log:
        gb = n * int(np.prod(shape)) / 1e9
        log(f"  cache complete: {n} images, {gb:.2f} GB at {cache_dir}")
    return ImageCache(cache_dir, meta)


def ensure_cache(dataset, capacity: int = 64, packed: bool = False,
                 cache_dir: str | None = None, log=print, *, rank: int = 0,
                 wait=None):
    """Open the cache for `dataset`, building it on first use or when the
    dataset changed since it was written.

    In a job of several processes that share one cache: process 0
    (`rank`) opens or builds it, `wait()` (a barrier over the job, which
    must outlast the build: `parallel/distributed.py::host_barrier`) holds
    every process until then, and the others open what it wrote. A cache
    they cannot open raises (RuntimeError): no two processes ever write
    one cache, and none reads a half-written one (meta.json is written
    last). `packed`: the space-to-depth layout of a packed model, in a
    directory of its own."""
    img_dir = str(Path(dataset.imgs[0]).parent) if dataset.imgs else "."
    cache_dir = cache_dir or cache_dir_for(img_dir, dataset.img_size,
                                           capacity, packed)
    fp = dataset_fingerprint(dataset.imgs)
    cache = None
    if rank == 0:
        cache = open_cache(cache_dir, fingerprint=fp, packed=packed)
        if cache is None:
            if log:
                log(f"Building training cache at {cache_dir} "
                    f"(one-time decode+letterbox pass)")
            cache = build_cache(dataset, cache_dir, capacity=capacity,
                                packed=packed, log=log)
    if wait is not None:
        wait()
    if cache is None:
        cache = open_cache(cache_dir, fingerprint=fp, packed=packed)
        if cache is None:
            raise RuntimeError(f"process {rank}: no cache for this dataset "
                               f"at {cache_dir} after process 0 built it "
                               f"(a directory it cannot read?)")
    return cache
