"""Composite YOLO loss, dense and statically shaped (counterpart of
`yolo_from_scratch_tpu/ops/losses.py`).

- bbox: CIoU over cells with objects (masked mean), weight 0.05
- objectness: BCE-with-logits over ALL cells (plain mean), per-scale
  weights [P3, P4, P5] = [4.0, 1.0, 0.4]
- class: BCE-with-logits over the class channels of cells with objects
  (masked mean), weight 0.5

`quirk_640=True` decodes with the reference's fixed 640 denominator at
any resolution, as the JAX package's `--reference-quirks` does.

Inside `parallel/mesh.py::data_parallel` the means are the global
batch's: a masked mean divides by the global count (a detached
all-reduce), a plain mean is this rank's part of the global one, so the
ranks' losses sum to the loss of the global batch. On a 2-D mesh every
term stays local to the rank's rows (each cell's loss reads that cell
alone), decoded with the block's row offset (`parallel/mesh.py::
local_rows`); the normalizers already span every rank, and over unequal
blocks a plain mean is the local sum over the global count
(`global_mean`).
"""

from __future__ import annotations

import torch

from yolo_from_scratch_tpu_torch.ops.ciou import ciou_loss
from yolo_from_scratch_tpu_torch.ops.decode import decode_predictions
from yolo_from_scratch_tpu_torch.parallel.mesh import (
    global_mean,
    global_sum,
    local_rows,
)

BOX_WEIGHT = 0.05
CLS_WEIGHT = 0.5
OBJ_SCALE_WEIGHTS = (4.0, 1.0, 0.4)  # P3, P4, P5


def sigmoid_bce(logits, labels):
    """Elementwise BCE-with-logits, the stable form
    relu(x) - x*z + log1p(exp(-|x|))."""
    labels = labels.to(logits.dtype)
    return (torch.relu(logits) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def _bce_mean(logits, labels, mask=None):
    """Mean BCE-with-logits; optional dense mask for a masked mean."""
    bce = sigmoid_bce(logits, labels)
    if mask is None:
        return global_mean(bce)
    mask = torch.broadcast_to(mask, bce.shape).to(bce.dtype)
    return (bce * mask).sum() / torch.clamp(global_sum(mask.sum()), min=1.0)


def yolo_loss(predictions, targets, anchors, num_classes=1, img_size=640):
    """Single-scale loss. predictions / targets (B, H, W, A, 5+nc), raw
    logits and dense targets (channel 4 is objectness in {0, 1}); anchors
    (A, 2) pixels (a tensor on the predictions' device avoids a copy).
    Returns (total, bbox, obj, cls), total weighted 0.05 / 1.0 / 0.5."""
    decoded = decode_predictions(predictions, anchors, img_size,
                                 *local_rows(*predictions.shape[1:3]))
    obj_mask = targets[..., 4] > 0.5

    bbox = ciou_loss(decoded[..., 0:4], targets[..., 0:4], mask=obj_mask)
    obj = _bce_mean(predictions[..., 4], targets[..., 4])
    cls = (_bce_mean(predictions[..., 5:], targets[..., 5:],
                     mask=obj_mask[..., None])
           if num_classes > 0
           else torch.zeros((), dtype=predictions.dtype,
                            device=predictions.device))
    total = BOX_WEIGHT * bbox + 1.0 * obj + CLS_WEIGHT * cls
    return total, bbox, obj, cls


def yolo_loss_multiscale(predictions, targets, anchors_list, num_classes=1,
                         img_size=640, quirk_640=False):
    """Multi-scale loss over [P3, P4, P5] with per-scale objectness
    weights. Returns (total, bbox, obj, cls): `total` is the weighted
    training loss summed over scales; the components are UNWEIGHTED sums
    for logging."""
    decode_size = 640 if quirk_640 else img_size
    total = bbox_t = obj_t = cls_t = 0.0
    for pred, tgt, anchors, obj_w in zip(predictions, targets, anchors_list,
                                         OBJ_SCALE_WEIGHTS):
        _, bbox, obj, cls = yolo_loss(pred, tgt, anchors, num_classes,
                                      decode_size)
        total = total + BOX_WEIGHT * bbox + obj_w * obj + CLS_WEIGHT * cls
        bbox_t = bbox_t + bbox
        obj_t = obj_t + obj
        cls_t = cls_t + cls
    return total, bbox_t, obj_t, cls_t
