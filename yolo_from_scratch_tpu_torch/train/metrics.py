"""Grid-aligned detection metrics (counterpart of
`yolo_from_scratch_tpu/train/metrics.py`), for both heads.

    pred_obj = sigmoid(raw obj); both thresholds default 0.5
    pred>thr & tgt>thr & IoU>thr  -> TP
    pred>thr & tgt>thr & IoU<=thr -> FP   (no FN for the missed GT)
    pred>thr & tgt<=thr           -> FP
    pred<=thr & tgt>thr           -> FN

Precision / recall / F1 come from the summed counts. These are the
reference's grid-aligned metrics, not NMS-based mAP. The anchor-free head
takes its best class probability for pred_obj.

On a row block (`--spatial`, inside `parallel/mesh.py::data_parallel`)
the counts are those of the block's cells, decoded at their global rows;
summed over every rank (`train/loop.py::eval_epoch`) they are the
image's.
"""

from __future__ import annotations

import torch

from yolo_from_scratch_tpu_torch.models.anchor_free import (
    REG_MAX,
    decode_anchor_free,
)
from yolo_from_scratch_tpu_torch.ops.boxes import box_iou_center
from yolo_from_scratch_tpu_torch.ops.decode import decode_predictions
from yolo_from_scratch_tpu_torch.parallel.mesh import local_rows


def grid_metric_counts(pred, target, anchors, img_size, conf_threshold=0.5,
                       iou_threshold=0.5, quirk_640=False, per_image=False):
    """TP/FP/FN counts for one scale: int32 scalars, or (B,) vectors when
    `per_image` (so a caller can drop padded batch rows)."""
    decoded = decode_predictions(pred, anchors, 640 if quirk_640 else img_size,
                                 *local_rows(*pred.shape[1:3]))
    pm = torch.sigmoid(pred[..., 4]) > conf_threshold
    tm = target[..., 4] > conf_threshold
    iou = box_iou_center(decoded[..., 0:4], target[..., 0:4], eps=1e-6)
    hit = iou > iou_threshold

    tp = pm & tm & hit
    fp = (pm & tm & ~hit) | (pm & ~tm)
    fn = ~pm & tm

    def count(m):
        m = m.to(torch.int32)
        return (m.sum(dim=(1, 2, 3)) if per_image else m.sum()).to(
            torch.int32)

    return count(tp), count(fp), count(fn)


def grid_metric_counts_anchor_free(pred, target, stride, img_size,
                                   conf_threshold=0.5, iou_threshold=0.5,
                                   per_image=False):
    """`grid_metric_counts` for the anchor-free head: pred (B, H, W,
    4*REG_MAX + nc) raw, target (B, H, W, 5+nc) the transport maps (flag
    at channel 4). The confidence is the best class probability; the class
    logits start after the 4*REG_MAX DFL logits, at channel 4*REG_MAX,
    not 4. This cell-aligned count understates a TAL-trained model (TAL
    often picks a neighbouring cell); `--map` / `--val-det` score the
    detections."""
    decoded = decode_anchor_free(pred, stride, img_size,
                                 local_rows(*pred.shape[1:3])[0])
    pm = torch.sigmoid(pred[..., 4 * REG_MAX:]).amax(dim=-1) > conf_threshold
    tm = target[..., 4] > conf_threshold
    iou = box_iou_center(decoded[..., 0:4], target[..., 0:4], eps=1e-6)
    hit = iou > iou_threshold

    tp = pm & tm & hit
    fp = (pm & tm & ~hit) | (pm & ~tm)
    fn = ~pm & tm

    def count(m):
        m = m.to(torch.int32)
        return (m.sum(dim=(1, 2)) if per_image else m.sum()).to(torch.int32)

    return count(tp), count(fp), count(fn)


def prf1(tp, fp, fn):
    """Precision / recall / F1 in percent from counts."""
    tp, fp, fn = float(tp), float(fp), float(fn)
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) > 0 else 0.0)
    return precision * 100.0, recall * 100.0, f1 * 100.0
