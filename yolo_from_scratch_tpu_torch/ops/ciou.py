"""Complete-IoU loss, elementwise and mask-friendly (counterpart of
`yolo_from_scratch_tpu/ops/ciou.py`).

CIoU = IoU - center_dist / enclose_diag - alpha * v, with alpha detached
from the graph (the JAX package's `lax.stop_gradient`, the reference's
`torch.no_grad`). Dense over every cell; a mask selects the cells with
objects for a masked mean with count >= 1.
"""

from __future__ import annotations

import math

import torch

from yolo_from_scratch_tpu_torch.parallel.mesh import global_mean, global_sum


def ciou(pred_boxes, target_boxes, eps=1e-7):
    """Elementwise CIoU for center-format boxes. (..., 4) -> (...)."""
    px, py, pw, ph = pred_boxes.unbind(-1)
    tx, ty, tw, th = target_boxes.unbind(-1)

    px1, py1, px2, py2 = px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2
    tx1, ty1, tx2, ty2 = tx - tw / 2, ty - th / 2, tx + tw / 2, ty + th / 2

    inter_w = (torch.minimum(px2, tx2) - torch.maximum(px1, tx1)).clamp(min=0)
    inter_h = (torch.minimum(py2, ty2) - torch.maximum(py1, ty1)).clamp(min=0)
    inter = inter_w * inter_h
    union = pw * ph + tw * th - inter
    iou = inter / (union + eps)

    center_dist = torch.square(px - tx) + torch.square(py - ty)
    enc_w = torch.maximum(px2, tx2) - torch.minimum(px1, tx1)
    enc_h = torch.maximum(py2, ty2) - torch.minimum(py1, ty1)
    enclose_diag = torch.square(enc_w) + torch.square(enc_h) + eps
    distance_penalty = center_dist / enclose_diag

    v = (4.0 / (math.pi ** 2)) * torch.square(
        torch.atan(pw / (ph + eps)) - torch.atan(tw / (th + eps)))
    alpha = (v / (1.0 - iou + v + eps)).detach()

    return iou - distance_penalty - alpha * v


def ciou_loss(pred_boxes, target_boxes, mask=None, eps=1e-7):
    """Mean (1 - CIoU), optionally over a boolean/float mask (sum over the
    masked cells / max(count, 1)); inside `parallel/mesh.py::
    data_parallel` the global batch's (the global count)."""
    loss = 1.0 - ciou(pred_boxes, target_boxes, eps=eps)
    if mask is None:
        return global_mean(loss)
    mask = mask.to(loss.dtype)
    return (loss * mask).sum() / torch.clamp(global_sum(mask.sum()), min=1.0)
