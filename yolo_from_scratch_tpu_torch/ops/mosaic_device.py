"""Four-image mosaic of a batch on the device, over compact labels
(counterpart of `yolo_from_scratch_tpu/ops/mosaic_device.py`).

Partners come from the batch in flight (at a world larger than one, the
global batch gathered over the ranks: `source`), images compose by a 2x
mean-pool downscale and a 2x2 concatenation, and the compact labels
transform by vector math: no host work. As in the JAX package the mosaic
centre is fixed at 0.5 (four equal quadrants, not the host mosaic's
U(0.3, 0.7)), partners are drawn with replacement, and boxes whose scaled
w or h falls below `min_box` (2 px at the training size) are dropped.

JAX draws from `jax.random`, which torch cannot replay, so the mosaic takes
its draws explicitly (`do` (B,) bool, `idx` (3, B) partners) and
`mosaic_draws` makes them from a `torch.Generator` (the train step seeds
one from the seed and the step). A test that recomputes JAX's draws from
its key holds the two packages to each other.

Composition order: mosaic (p=0.5) first, then the flip and the
photometric jitter (`ops/augment.py`) on the composed result.
"""

from __future__ import annotations

import torch

from yolo_from_scratch_tpu_torch.models.packed import pack_s2d, unpack_s2d

MOSAIC_P = 0.5  # the host path's (data/dataset.py __getitem__)


def _down2(x):
    """2x mean-pool downscale of (B, S, S, C) images: the fixed-centre
    mosaic's per-quadrant resize."""
    b, s, _, c = x.shape
    return x.reshape(b, s // 2, 2, s // 2, 2, c).mean(dim=(2, 4))


def mosaic_draws(generator, b: int):
    """One step's mosaic draws on the CPU from `generator`: do (B,) bool,
    each image mosaicked with probability MOSAIC_P, and idx (3, B) int64,
    its three partners drawn uniformly from the batch with replacement."""
    do = torch.rand(b, generator=generator) < MOSAIC_P
    idx = torch.randint(0, b, (3, b), generator=generator)
    return do, idx


def mosaic_compact_batch(images, labels, counts, min_box, do, idx,
                         source=None, packed: bool = False):
    """Per-image 4-mosaic of a batch with compact labels.

    Args:
        images: (B, S, S, 3) float32 in [0, 1], or with `packed` the
            space-to-depth packed layout (`models/packed.py`), which is
            unpacked, composed in pixel space and packed again.
        labels: (B, K, 5) float32 [class, cx, cy, w, h].
        counts: (B,) valid-row counts.
        min_box: floor on the scaled w and h (use 2 / img_size).
        do: (B,) bool, the images to mosaic.
        idx: (3, B) int64, each image's partners in the top-right,
            bottom-left and bottom-right quadrants.
        source: (images, labels, counts) of the batch `idx` indexes, in
            the layout above: at a world larger than one the global batch
            (`parallel/mesh.py::gather_batch`), of which this one is a
            rank's rows; the batch itself when None.

    Returns (images, labels (B, 4K, 5), valid (B, 4K) bool): the labels
    carry an explicit validity mask, since the mosaic interleaves the four
    sources' padding (`assign_targets_device_masked_batch` takes it).
    """
    k = labels.shape[1]
    pixels = unpack_s2d if packed else (lambda t: t)
    down = _down2(pixels(images))
    if source is None:
        src_down, src_labels, src_counts = down, labels, counts
    else:
        src_down, src_labels, src_counts = (_down2(pixels(source[0])),
                                            *source[1:])
    canvas = torch.cat([torch.cat([down, src_down[idx[0]]], dim=2),
                        torch.cat([src_down[idx[1]], src_down[idx[2]]],
                                  dim=2)], dim=1)
    if packed:
        canvas = pack_s2d(canvas)
    images_out = torch.where(do[:, None, None, None], canvas, images)

    ar = torch.arange(k, device=labels.device)
    offsets = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5))
    sources = [(labels, counts)] + [(src_labels[i], src_counts[i])
                                    for i in idx]
    labs, valids = [], []
    for (ox, oy), (lab, cnt) in zip(offsets, sources):
        w = lab[..., 3] * 0.5
        h = lab[..., 4] * 0.5
        labs.append(torch.stack([lab[..., 0], lab[..., 1] * 0.5 + ox,
                                 lab[..., 2] * 0.5 + oy, w, h], dim=-1))
        valids.append((ar < cnt[:, None]) & (w >= min_box) & (h >= min_box))
    m_labels = torch.cat(labs, dim=1)
    m_valid = torch.cat(valids, dim=1)

    # images left alone keep their labels in the first K rows
    base_labels = torch.cat([labels, labels.new_zeros(
        (labels.shape[0], 3 * k, labels.shape[2]))], dim=1)
    base_valid = torch.cat([ar < counts[:, None], torch.zeros_like(
        m_valid[:, k:])], dim=1)
    labels_out = torch.where(do[:, None, None], m_labels, base_labels)
    valid_out = torch.where(do[:, None], m_valid, base_valid)
    return images_out, labels_out, valid_out
