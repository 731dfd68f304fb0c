"""YOLO-format dataset with dense multi-scale target assignment: the port's
copy of `yolo_from_scratch_tpu/data/dataset.py`, the PIL backend, the
dense host targets, the compact labels of the on-device assignment
(`load_batch_compact`) and the load-time augmentation (`augment=True`:
`mosaic_4`, `augment_image_and_boxes`), held to the JAX package's
(`tests/test_torch_config_data.py`, `tests/test_torch_assign_device.py`,
`tests/test_torch_host_augment.py`).

Behavior parity with the reference dataset (reference: train.py:60-207):
- images globbed as sorted(*.jpg + *.png) (train.py:62);
- label path derived as .../images/x.jpg -> .../labels/x.txt via the
  grandparent directory (train.py:65-68);
- per image, three dense target tensors (gs, gs, A, 5+nc), or with
  `head_type="anchor_free"` the anchor-free head's transport maps
  (gs, gs, 5+nc) (`models/anchor_free.py::assign_targets_anchor_free`);
- each GT box is assigned to the single best (scale, anchor) by shape-only
  IoU across all 9 anchors (train.py:169-180), grid cell = floor(center*gs)
  clamped (train.py:184-189), first GT wins an occupied slot (train.py:193),
  class one-hot at 5+class_id for nc>1 and index 5 for nc==1
  (train.py:201-205).

`augment=True` draws from `np.random.default_rng(seed)` in the JAX
dataset's order (mosaic or not, its partners, its centre, the flip, gain
and bias), so boxes, classes and targets equal the JAX package's for a
seed. The JAX mosaic resizes its quadrants with OpenCV's
`cv2.resize(INTER_LINEAR)`, which the card's machine does not have:
`resize_linear` computes the same half-pixel, non-antialiased bilinear in
numpy float32 (the images agree within 1e-6).

`backend="native"` decodes and letterboxes a batch with the port's
C++ libjpeg/libpng loader (`yolo_from_scratch_tpu_torch/native/`), in
`load_batch` and `load_batch_compact`; `backend="auto"` takes it whenever
it builds, else PIL, as the JAX package resolves it. Its triangle filter
differs from PIL's by less than one 8-bit step when it resizes; it is held
bit for bit to the JAX package's native library
(`tests/test_torch_native.py`).
"""

from __future__ import annotations

import glob
import sys
from pathlib import Path

import numpy as np

from yolo_from_scratch_tpu_torch.config import (
    INV255,
    NUM_ANCHORS_PER_SCALE,
    STRIDES,
    normalize_anchors,
)
from yolo_from_scratch_tpu_torch.data.letterbox import (
    adjust_boxes_for_letterbox,
    letterbox_image,
)

def parse_label_file(path) -> np.ndarray:
    """Parse a YOLO label txt -> (N, 5) array [class, cx, cy, w, h].
    Lines that don't have exactly 5 fields are skipped (reference:
    train.py:150-154)."""
    rows = []
    p = Path(path)
    if p.exists():
        with open(p, encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) == 5:
                    rows.append([float(v) for v in parts])
    return np.asarray(rows, np.float32).reshape(-1, 5)


def _shape_iou_matrix(box_wh: np.ndarray, anchors_wh: np.ndarray) -> np.ndarray:
    """(N, 2) x (A, 2) -> (N, A) shape-only IoU, both centered at origin
    (reference: train.py:108-131)."""
    inter = np.minimum(box_wh[:, None, 0], anchors_wh[None, :, 0]) * np.minimum(
        box_wh[:, None, 1], anchors_wh[None, :, 1]
    )
    union = (
        box_wh[:, 0:1] * box_wh[:, 1:2]
        + anchors_wh[None, :, 0] * anchors_wh[None, :, 1]
        - inter
    )
    return inter / (union + 1e-16)


def assign_targets(
    boxes: np.ndarray,
    class_ids: np.ndarray,
    anchors: np.ndarray,
    img_size: int,
    num_classes: int,
) -> list:
    """Build dense multi-scale targets for one image.

    Args:
        boxes: (N, 4) normalized [cx, cy, w, h] in letterboxed coords.
        class_ids: (N,) ints.
        anchors: (3, A, 2) pixel anchors.
        img_size: input resolution.

    Returns:
        [t_p3, t_p4, t_p5] with t_i of shape (gs_i, gs_i, A, 5+nc) float32.
    """
    grid_sizes = [img_size // s for s in STRIDES]
    out_dim = 5 + num_classes
    targets = [
        np.zeros((gs, gs, NUM_ANCHORS_PER_SCALE, out_dim), np.float32)
        for gs in grid_sizes
    ]
    if len(boxes) == 0:
        return targets

    wh_px = boxes[:, 2:4] * img_size
    # (N, 9) IoU against all anchors of all scales, argmax picks the single
    # best (scale, anchor) pair per box — vectorized version of the
    # reference's per-box loop over scales (train.py:169-180).
    iou = _shape_iou_matrix(wh_px, anchors.reshape(-1, 2))
    best_flat = iou.argmax(axis=1)
    best_scale = best_flat // NUM_ANCHORS_PER_SCALE
    best_anchor = best_flat % NUM_ANCHORS_PER_SCALE

    # Sequential first-wins slot assignment (order-dependent by design,
    # matching reference train.py:193).
    for n in range(len(boxes)):
        s, a = int(best_scale[n]), int(best_anchor[n])
        gs = grid_sizes[s]
        # Clamp both ends: labels are untrusted input here (parse_label_file
        # does no range validation), and a center <= -1/gs would otherwise
        # wrap to the last row/column via negative indexing.
        gx = max(0, min(int(boxes[n, 0] * gs), gs - 1))
        gy = max(0, min(int(boxes[n, 1] * gs), gs - 1))
        t = targets[s]
        if t[gy, gx, a, 4] == 0:
            t[gy, gx, a, 0:4] = boxes[n]
            t[gy, gx, a, 4] = 1.0
            if num_classes == 1:
                t[gy, gx, a, 5] = 1.0
            else:
                t[gy, gx, a, 5 + int(class_ids[n])] = 1.0
    return targets


def _linear_taps(dst, src):
    """OpenCV's INTER_LINEAR source taps along one axis: (i0, i1, w0, w1)
    for each of `dst` outputs from `src` inputs; the position (d + 0.5) *
    src / dst - 0.5 and its fraction in double, the weights rounded to
    float32, clamped to the edge pixels with weight 0 beyond them."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst) + 0.5) * scale - 0.5
    i0 = np.floor(f).astype(np.int64)
    w1 = (f - i0).astype(np.float32)
    edge = (i0 < 0) | (i0 >= src - 1)
    w1[edge] = 0.0
    i0 = np.clip(i0, 0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), np.float32(1.0) - w1, w1


def resize_linear(img, width, height):
    """`cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)`
    of a float32 (H, W, C) image, in numpy float32: half-pixel centres, no
    antialiasing, rows first and then columns, each a two-tap weighted
    sum."""
    y0, y1, wy0, wy1 = _linear_taps(height, img.shape[0])
    x0, x1, wx0, wx1 = _linear_taps(width, img.shape[1])
    rows = (img[:, x0] * wx0[None, :, None]
            + img[:, x1] * wx1[None, :, None])
    return (rows[y0] * wy0[:, None, None]
            + rows[y1] * wy1[:, None, None]).astype(np.float32)


def mosaic_4(samples, rng, min_box=2.0 / 640.0):
    """YOLO-style 4-image mosaic (simplified): one canvas split at a random
    center; each quadrant is a resized source image with its boxes mapped
    into quadrant coordinates. Degenerate boxes (below `min_box` after
    scaling) are dropped.

    Args:
        samples: list of 4 (img (S, S, 3) f32, boxes (N, 4) cxcywh norm,
            classes (N,)) tuples.
        rng: np.random.Generator.

    Returns (img, boxes, classes).
    """
    s = samples[0][0].shape[0]
    cx = rng.uniform(0.3, 0.7)
    cy = rng.uniform(0.3, 0.7)
    quads = [
        (0.0, 0.0, cx, cy), (cx, 0.0, 1.0 - cx, cy),
        (0.0, cy, cx, 1.0 - cy), (cx, cy, 1.0 - cx, 1.0 - cy),
    ]
    canvas = np.empty((s, s, 3), np.float32)
    out_boxes, out_classes = [], []
    for (img, boxes, classes), (qx, qy, qw, qh) in zip(samples, quads):
        x0, y0 = int(round(qx * s)), int(round(qy * s))
        x1, y1 = int(round((qx + qw) * s)), int(round((qy + qh) * s))
        w_px, h_px = max(x1 - x0, 1), max(y1 - y0, 1)
        canvas[y0:y0 + h_px, x0:x0 + w_px] = resize_linear(
            img, w_px, h_px).reshape(h_px, w_px, 3)
        if len(boxes):
            b = boxes.copy()
            b[:, 0] = qx + b[:, 0] * qw
            b[:, 1] = qy + b[:, 1] * qh
            b[:, 2] = b[:, 2] * qw
            b[:, 3] = b[:, 3] * qh
            keep = (b[:, 2] >= min_box) & (b[:, 3] >= min_box)
            out_boxes.append(b[keep])
            out_classes.append(np.asarray(classes)[keep])
    boxes = (np.concatenate(out_boxes) if out_boxes
             else np.zeros((0, 4), np.float32))
    classes = (np.concatenate(out_classes) if out_classes
               else np.zeros(0, np.int64))
    return canvas, boxes.astype(np.float32), classes.astype(np.int64)


def augment_image_and_boxes(img, boxes, rng):
    """Training-time augmentation (not in the reference; off by default):
    horizontal flip (p=0.5) + brightness/contrast jitter.

    Args:
        img: (S, S, 3) float32 in [0, 1] (letterboxed).
        boxes: (N, 4) normalized [cx, cy, w, h] in letterboxed coords.
        rng: np.random.Generator.

    Returns (img, boxes), possibly modified copies.
    """
    if rng.random() < 0.5:
        img = img[:, ::-1].copy()
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, 0] = 1.0 - boxes[:, 0]
    gain = rng.uniform(0.7, 1.3)
    bias = rng.uniform(-0.08, 0.08)
    img = np.clip(img * gain + bias, 0.0, 1.0).astype(np.float32)
    return img, boxes


class YoloDataset:
    """Filesystem YOLO dataset: images dir + sibling labels dir.

    `backend`: 'pil' (reference-parity PIL decode), 'native' (the C++
    libjpeg/libpng loader of `yolo_from_scratch_tpu_torch/native`,
    threaded batch decode + letterbox; a failed build raises with the
    compiler's stderr at the first batch), or 'auto' (native when it
    builds, else PIL). The native bilinear filter differs from PIL's by
    less than 1 LSB on typical photos when resizing; use 'pil' for
    bit-parity runs. `head_type` picks the target assignment ('anchor' or
    'anchor_free').

    `augment`: the 4-image mosaic (p=0.5, dataset of 4 or more), hflip and
    colour jitter at load time, drawn from `np.random.default_rng(seed)`
    (default off: the reference has no augmentation)."""

    def __init__(self, img_dir, num_classes=1, anchors=None, img_size=640,
                 backend="auto", head_type="anchor", augment=False, seed=0):
        if backend not in ("auto", "pil", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        # the reference globs only *.jpg + *.png (train.py:62); we also
        # accept .jpeg and uppercase variants (the CLI always accepted
        # .jpeg for inference) — deduplicated, sorted for determinism
        exts = ("jpg", "jpeg", "png", "JPG", "JPEG", "PNG")
        self.imgs = sorted(
            {p for e in exts for p in glob.glob(f"{img_dir}/*.{e}")}
        )
        self.labels = [
            str(Path(p).parent.parent / "labels" / f"{Path(p).stem}.txt")
            for p in self.imgs
        ]
        self.num_classes = num_classes
        self.img_size = img_size
        self.anchors = normalize_anchors(anchors)
        self.grid_sizes = [img_size // s for s in STRIDES]
        self.num_anchors_per_scale = NUM_ANCHORS_PER_SCALE
        self.output_dim = 5 + num_classes
        if backend == "auto":
            from yolo_from_scratch_tpu_torch import native

            backend = "native" if native.available() else "pil"
        self.backend = backend
        self.head_type = head_type
        self.augment = augment
        self._aug_rng = np.random.default_rng(seed)
        self._warned_capacity = False

    def _assign(self, boxes, class_ids):
        if self.head_type == "anchor_free":
            from yolo_from_scratch_tpu_torch.models.anchor_free import (
                assign_targets_anchor_free,
            )

            return assign_targets_anchor_free(
                boxes, class_ids, self.img_size, self.num_classes
            )
        return assign_targets(
            boxes, class_ids, self.anchors, self.img_size, self.num_classes
        )

    def __len__(self):
        return len(self.imgs)

    def _load_raw(self, idx):
        """(img (S, S, 3) f32, boxes (N, 4) letterboxed cxcywh, classes)."""
        from PIL import Image

        pil = Image.open(self.imgs[idx]).convert("RGB")
        orig_w, orig_h = pil.size
        img_u8, scale, pad_top, pad_left = letterbox_image(pil, self.img_size)
        img = img_u8.astype(np.float32) * INV255

        rows = parse_label_file(self.labels[idx])
        boxes = adjust_boxes_for_letterbox(
            rows[:, 1:5], orig_w, orig_h, scale, pad_top, pad_left, self.img_size
        )
        return img, boxes, rows[:, 0].astype(np.int64)

    def __getitem__(self, idx):
        """Returns (img (S, S, 3) float32 in [0,1] NHWC, [t_p3, t_p4, t_p5]),
        the targets as `head_type` lays them out."""
        img, boxes, classes = self._load_raw(idx)
        if self.augment:
            if len(self) >= 4 and self._aug_rng.random() < 0.5:
                others = self._aug_rng.choice(len(self), 3, replace=False)
                samples = [(img, boxes, classes)] + [
                    self._load_raw(int(i)) for i in others]
                # the degenerate-box filter stays at ~2 px of the actual
                # training resolution
                img, boxes, classes = mosaic_4(
                    samples, self._aug_rng, min_box=2.0 / self.img_size)
            img, boxes = augment_image_and_boxes(img, boxes, self._aug_rng)
        return img, self._assign(boxes, classes)

    def _boxes_for(self, idx, scale, pad_top, pad_left):
        """Letterboxed boxes + class ids for image idx given its letterbox
        geometry. A failed decode (scale == 0) yields no boxes."""
        if scale <= 0:
            return np.zeros((0, 4), np.float32), np.zeros(0, np.int64)
        rows = parse_label_file(self.labels[idx])
        from PIL import Image  # geometry needs original dims; read header only

        with Image.open(self.imgs[idx]) as im:
            orig_w, orig_h = im.size
        boxes = adjust_boxes_for_letterbox(
            rows[:, 1:5], orig_w, orig_h, scale, pad_top, pad_left,
            self.img_size,
        )
        return boxes, rows[:, 0].astype(np.int64)

    def _native_batch(self, indices, n_threads):
        """The native loader's (images (B, S, S, 3) float32, [(boxes,
        class ids)]) for `indices`."""
        from yolo_from_scratch_tpu_torch import native

        images, scales, pad_tops, pad_lefts, _ = native.decode_letterbox_batch(
            [self.imgs[i] for i in indices], self.img_size,
            n_threads=n_threads)
        return images, [
            self._boxes_for(i, float(scales[k]), int(pad_tops[k]),
                            int(pad_lefts[k]))
            for k, i in enumerate(indices)]

    def load_batch_compact(self, indices, capacity=64, image_dtype="uint8",
                           n_threads=4):
        """The compact path's batch (`data/assign_device.py`): images and
        padded raw labels, no dense maps (the step builds them on the
        device).

        Returns (images (B, S, S, 3) uint8, or float32 in [0, 1] (x
        INV255) for `image_dtype` "float32", labels (B, K, 5) f32 [class,
        cx, cy, w, h], counts (B,) int32). An image with more than K =
        `capacity` boxes keeps its first K (file order), with one warning
        on stderr for the dataset. The native backend decodes the batch on
        `n_threads` threads and rounds its float32 pixels to uint8 as the
        JAX package does, `clip(round(x * 255), 0, 255)`; PIL's uint8
        pixels become float32 as `x * INV255`.
        """
        from yolo_from_scratch_tpu_torch.data.assign_device import pack_labels

        indices = [int(i) for i in indices]
        if self.backend == "native":
            images, boxed = self._native_batch(indices, n_threads)
            boxes_list = [b for b, _ in boxed]
            class_list = [c for _, c in boxed]
            if image_dtype == "uint8":
                images = np.clip(np.round(images * 255.0), 0, 255).astype(
                    np.uint8)
        else:
            from PIL import Image

            imgs_u8, boxes_list, class_list = [], [], []
            for i in indices:
                pil = Image.open(self.imgs[i]).convert("RGB")
                orig_w, orig_h = pil.size
                img_u8, scale, pad_top, pad_left = letterbox_image(
                    pil, self.img_size)
                imgs_u8.append(img_u8)
                rows = parse_label_file(self.labels[i])
                boxes_list.append(adjust_boxes_for_letterbox(
                    rows[:, 1:5], orig_w, orig_h, scale, pad_top, pad_left,
                    self.img_size))
                class_list.append(rows[:, 0].astype(np.int64))
            images = np.stack(imgs_u8)
            if image_dtype != "uint8":
                images = images.astype(np.float32) * INV255
        over = max((len(b) for b in boxes_list), default=0)
        if over > capacity and not self._warned_capacity:
            print(f"WARNING: image with {over} boxes exceeds the "
                  f"compact-label capacity K={capacity}; keeping the first "
                  f"{capacity} (file order). Raise --compact-targets K to "
                  f"keep all boxes.", file=sys.stderr, flush=True)
            self._warned_capacity = True
        labels, counts = pack_labels(boxes_list, class_list, capacity)
        return images, labels, counts

    def load_batch(self, indices, n_threads=4):
        """(images (B,S,S,3) f32, [t_p3,t_p4,t_p5]) for `indices`: the
        native loader's threaded batch decode when the backend is native,
        else item by item through PIL. Augmented loading (the mosaic needs
        sibling samples) always goes item by item, each item's mosaic and
        jitter in index order."""
        indices = [int(i) for i in indices]
        if self.backend == "native" and not self.augment:
            images, boxed = self._native_batch(indices, n_threads)
            tgts = [self._assign(b, c) for b, c in boxed]
        else:
            imgs, tgts = zip(*(self[i] for i in indices))
            images = np.stack(imgs).astype(np.float32)
        targets = [
            np.stack([t[s] for t in tgts]).astype(np.float32)
            for s in range(3)
        ]
        return images, targets
