"""YOLO-format dataset with dense multi-scale target assignment: the port's
copy of `yolo_from_scratch_tpu/data/dataset.py`, the PIL backend, the
dense host targets and the compact labels of the on-device assignment
(`load_batch_compact`), bit-equal to the JAX package's
(`tests/test_torch_config_data.py`, `tests/test_torch_assign_device.py`).

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

Not ported yet, and an error that names it when asked for: the native
C++ JPEG loader (`backend="native"`, `yolo_from_scratch_tpu/native/`).
Load-time augmentation is not copied.
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

NATIVE_NOT_PORTED = ("the native JPEG loader (backend='native', "
                     "yolo_from_scratch_tpu/native) is not ported yet; use "
                     "backend='pil'")


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


class YoloDataset:
    """Filesystem YOLO dataset: images dir + sibling labels dir, decoded
    with PIL (`backend` 'pil', or 'auto', which is 'pil' here since the
    native loader is not ported). `head_type` picks the target assignment
    ('anchor' or 'anchor_free'); no augmentation."""

    def __init__(self, img_dir, num_classes=1, anchors=None, img_size=640,
                 backend="auto", head_type="anchor"):
        if backend == "native":
            raise NotImplementedError(NATIVE_NOT_PORTED)
        if backend not in ("auto", "pil"):
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
        self.backend = "pil"
        self.head_type = head_type
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
        return img, self._assign(boxes, classes)

    def load_batch_compact(self, indices, capacity=64, image_dtype="uint8"):
        """The compact path's batch (`data/assign_device.py`): images and
        padded raw labels, no dense maps (the step builds them on the
        device).

        Returns (images (B, S, S, 3) uint8, or float32 in [0, 1] (x
        INV255) for `image_dtype` "float32", labels (B, K, 5) f32 [class,
        cx, cy, w, h], counts (B,) int32). An image with more than K =
        `capacity` boxes keeps its first K (file order), with one warning
        on stderr for the dataset.
        """
        from PIL import Image

        from yolo_from_scratch_tpu_torch.data.assign_device import pack_labels

        imgs_u8, boxes_list, class_list = [], [], []
        for i in (int(i) for i in indices):
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

    def load_batch(self, indices):
        """(images (B,S,S,3) f32, [t_p3,t_p4,t_p5]) for `indices`, item by
        item through PIL."""
        imgs, tgts = zip(*(self[int(i)] for i in indices))
        images = np.stack(imgs).astype(np.float32)
        targets = [
            np.stack([t[s] for t in tgts]).astype(np.float32)
            for s in range(3)
        ]
        return images, targets
