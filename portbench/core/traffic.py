"""The one traffic generator: inputs of every cell from a mix file's
parameters and the run's seed. The same seed gives the same inputs; every
seed gives the same sizes (label counts, frame shapes), in another order.

Training (`kind` "train"): an in-memory image cache in the program's
cache layout (`images` (n, S, S, 3) uint8, `labels` (n, K, 5) float32
[class, cx, cy, w, h] normalised, `counts` (n,) int32). The label counts
are the quantiles of a log-normal (median, sigma), rounded and clipped
to [0, max], shuffled; classes are uniform; box sides log-uniform over
`box_side_px`, centres uniform with the box inside the image.

Serving (`kind` "serve"): a pool of HWC uint8 frames in the mix's
shapes, equal numbers of each, shuffled; the frames of call i
(`FrameSchedule`); the calibration frames.

Pixels are uniform noise, drawn on the device (the frame pool in one
call, the training cache a GiB a call) and copied to the host, where the
program reads them.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from portbench.core.weights import sub_seed


class RamCache:
    """The program's image cache held in memory: what `ChunkStream` reads
    of `data/cache.py::ImageCache`, its `images`, `labels`, `counts` and
    length. (A written cache would write its whole size to disk in every
    run; a memmap whose pages the host holds reads as this does.)"""

    def __init__(self, images, labels, counts):
        self.images, self.labels, self.counts = images, labels, counts

    def __len__(self):
        return len(self.images)


def _pixels(shape, seed, device):
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "pixels"))
    return torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen,
                         device=device).cpu().numpy()


def _pixels_into(out: np.ndarray, seed, device, block=1 << 30):
    """Fill a uint8 array with noise drawn on the device, `block` bytes a
    draw, so the device holds one block at a time."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "pixels"))
    flat = torch.from_numpy(out.reshape(-1))
    for i in range(0, flat.numel(), block):
        n = min(block, flat.numel() - i)
        flat[i:i + n].copy_(torch.randint(0, 256, (n,), dtype=torch.uint8,
                                          generator=gen, device=device))


def label_counts(n: int, spec: dict) -> np.ndarray:
    """The n label counts: log-normal quantiles at (i + 0.5) / n."""
    dist = statistics.NormalDist(np.log(spec["median"]), spec["sigma"])
    q = [np.exp(dist.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return np.clip(np.rint(q), 0, spec["max"]).astype(np.int32)


def train_cache(mix: dict, img_size: int, seed: int, device) -> RamCache:
    n, k = mix["images"], mix["label_capacity"]
    rng = np.random.default_rng(sub_seed(seed, "labels"))
    counts = rng.permutation(label_counts(n, mix["labels_per_image"]))
    lo, hi = (np.log(v) for v in mix["box_side_px"])
    wh = np.exp(rng.uniform(lo, hi, (n, k, 2)))
    centre = wh / 2 + rng.uniform(0, 1, (n, k, 2)) * (img_size - wh)
    labels = np.zeros((n, k, 5), np.float32)
    labels[..., 0] = rng.integers(0, mix["num_classes"], (n, k))
    labels[..., 1:3] = centre / img_size
    labels[..., 3:5] = wh / img_size
    labels[np.arange(k)[None, :] >= counts[:, None]] = 0.0
    images = np.empty((n, img_size, img_size, 3), np.uint8)
    _pixels_into(images, seed, device)
    return RamCache(images, labels, counts)


def frame_pool(mix: dict, seed: int, device) -> list:
    """The pool's frames, HWC uint8 arrays."""
    shapes = [tuple(s) for s in mix["frame_shapes"]]
    n = mix["pool"]
    order = np.random.default_rng(sub_seed(seed, "shapes")).permutation(
        [shapes[i % len(shapes)] for i in range(n)])
    flat = _pixels((sum(h * w * 3 for h, w in order),), seed, device)
    out, i = [], 0
    for h, w in order:
        out.append(flat[i:i + h * w * 3].reshape(h, w, 3))
        i += h * w * 3
    return out


class FrameSchedule:
    """Which pool frames each call takes: `batch` distinct frames a call,
    a fresh permutation of the pool each call, from the seed."""

    def __init__(self, pool_size: int, batch: int, seed: int):
        self.pool_size, self.batch = pool_size, batch
        self.seed = sub_seed(seed, "schedule")

    def call(self, i: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, i])
        return rng.permutation(self.pool_size)[:self.batch]

    def calibration(self, n: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 1 << 40])
        return rng.permutation(self.pool_size)[:n]
