"""Box geometry primitives on tensors (counterpart of
`yolo_from_scratch_tpu/ops/boxes.py`).

The IoU keeps the reference's op order, `inter / (area_a + area_b - inter
+ eps)`, evaluated one unfused float32 op at a time: the NMS kernel
(`csrc/nms.cu`) reproduces exactly this sequence so the two agree bit for
bit.
"""

from __future__ import annotations

import torch


def center_to_corner(boxes):
    """(..., 4) [cx, cy, w, h] -> [x1, y1, x2, y2]."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def corner_to_center(boxes):
    """(..., 4) [x1, y1, x2, y2] -> [cx, cy, w, h]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def box_iou_corner(a, b, eps=1e-6):
    """Elementwise IoU of corner-format boxes; broadcasts over leading dims."""
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + eps)


def pairwise_iou_corner(a, b, eps=1e-6):
    """All-pairs IoU: a (N, 4) x b (M, 4) -> (N, M). Corner format."""
    return box_iou_corner(a[:, None, :], b[None, :, :], eps=eps)


def box_iou_center(a, b, eps=1e-6):
    """Elementwise IoU of center-format boxes."""
    return box_iou_corner(center_to_corner(a), center_to_corner(b), eps=eps)
