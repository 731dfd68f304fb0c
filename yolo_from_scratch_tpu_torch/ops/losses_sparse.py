"""Sparse (gather-based) YOLO loss: the dense loss without the dense
transport (counterpart of `yolo_from_scratch_tpu/ops/losses_sparse.py`).

`ops/losses.py::yolo_loss_multiscale` reads dense (B, gs, gs, A, 5+nc)
target maps, ~8.6 MB an image at nc=80 @640, though at most K cells an
image hold an object. This computes the same loss from the compact (K, 5)
labels:

- routing: `data/assign_device.py::transport_slots`, the (scale, cell,
  anchor) and first-wins resolution the dense scatter uses;
- bbox and class terms: gather the winners' raw predictions from the
  flattened scale, decode those rows with the expressions of
  `ops/decode.py::decode_predictions`, and take the same masked means
  (denominators: the winner count, the winner count * nc);
- objectness: the dense term is a mean of BCE over every cell against a
  {0, 1} grid. Since BCE(l, 1) = BCE(l, 0) - l (`ops/losses.py::
  sigmoid_bce`, optax's formula), it is mean(BCE(l, 0)) - sum over the
  winners of l / N: one reduction over the objectness channel and a
  gathered correction, no target grid.

Inside `parallel/mesh.py::data_parallel` the winner count, the cell
count N and the objectness mean are the global batch's, as in
`ops/losses.py`. On a 2-D mesh the labels are whole on every rank of a
space group and the predictions its row block: each rank keeps the
winners whose slot lies in its rows, gathers them at their local index
and decodes them at their global row; the counts are summed over every
rank, so each winner counts once, and the cell count N is the global
grid's whatever the blocks hold (`parallel/mesh.py::global_elements`).

Equal to the dense path up to summation order, with gradients that agree
(d/dl of the objectness rewrite is (sigmoid(l) - [winner]) / N, the dense
gradient); pinned by `tests/test_torch_sparse_loss.py`.
"""

from __future__ import annotations

import torch

from yolo_from_scratch_tpu_torch.data.assign_device import (
    class_onehot,
    transport_slots,
)
from yolo_from_scratch_tpu_torch.ops.ciou import ciou
from yolo_from_scratch_tpu_torch.ops.losses import (
    BOX_WEIGHT,
    CLS_WEIGHT,
    OBJ_SCALE_WEIGHTS,
    sigmoid_bce,
)
from yolo_from_scratch_tpu_torch.parallel.mesh import (
    global_elements,
    global_mean,
    global_sum,
    local_rows,
)


def _scale_loss(pred, gt_boxes, onehot, win, slot, anchors, num_classes,
                decode_size):
    """One scale's (bbox, obj, cls) from the winners' gathered rows.

    pred (B, h, gs, A, 5+nc) raw logits, h = gs or a row block's rows;
    gt_boxes (B, K, 4) normalized [cx, cy, w, h]; onehot (B, K, nc); win
    (B, K) bool; slot (B, K) global flat (gy*gs + gx)*A + anchor; anchors
    (A, 2) pixels."""
    b, h, gs, na, d = pred.shape
    logit = pred[..., 4]
    n_cells = float(global_elements(logit))
    flat = pred.reshape(b, h * gs * na, d)

    # the winners in this rank's rows (all of them without a space axis;
    # none on a rank that holds no rows, which has nothing to gather)
    off = local_rows(h, gs)[0] * gs * na
    win = win & (slot >= off) & (slot < off + h * gs * na)
    idx = torch.where(win, slot - off, 0)
    if h:
        g = torch.gather(flat, 1, idx[..., None].expand(b, idx.shape[1], d))
    else:
        g = flat.new_zeros((b, idx.shape[1], d))

    # decode the gathered rows as ops/decode.py decodes those cells
    anchor_i = idx % na
    cell = (idx + off) // na
    gx = (cell % gs).to(pred.dtype)
    gy = (cell // gs).to(pred.dtype)
    sxy = torch.sigmoid(g[..., 0:2])
    bx = ((sxy[..., 0] * 2.0 - 0.5) + gx) / gs
    by = ((sxy[..., 1] * 2.0 - 0.5) + gy) / gs
    anc = torch.as_tensor(anchors, dtype=pred.dtype, device=pred.device)
    swh = torch.sigmoid(g[..., 2:4])
    bw = (anc[:, 0][anchor_i] / decode_size) * torch.square(2.0 * swh[..., 0])
    bh = (anc[:, 1][anchor_i] / decode_size) * torch.square(2.0 * swh[..., 1])
    pred_boxes = torch.stack([bx, by, bw, bh], dim=-1)

    winf = win.to(pred.dtype)
    count = global_sum(winf.sum())

    # bbox: masked mean of (1 - CIoU), the dense ciou_loss(mask=obj_mask)
    bbox = (((1.0 - ciou(pred_boxes, gt_boxes)) * winf).sum()
            / torch.clamp(count, min=1.0))

    # objectness against the {0, 1} winner grid, via BCE(l, 1) = BCE(l, 0)
    # - l: no scattered target grid
    obj_all = global_mean(sigmoid_bce(logit, torch.zeros_like(logit)))
    obj = obj_all - (g[..., 4] * winf).sum() / n_cells

    # class: masked mean over the nc channels of the winners' cells
    if num_classes > 0:
        bce = sigmoid_bce(g[..., 5:], onehot)
        cls = ((bce * winf[..., None]).sum()
               / torch.clamp(count * num_classes, min=1.0))
    else:
        cls = torch.zeros((), dtype=pred.dtype, device=pred.device)
    return bbox, obj, cls


def yolo_loss_multiscale_sparse(predictions, labels, valid, anchors_list,
                                num_classes=1, img_size=640,
                                quirk_640=False):
    """Multi-scale loss from compact labels, no dense targets.

    Args:
        predictions: [P3, P4, P5] raw (B, gs, gs, A, 5+nc) head outputs.
        labels: (B, K, 5) float32 [class, cx, cy, w, h] padded rows.
        valid: (B, K) bool row validity.
        anchors_list: (3, A, 2) pixel anchors (a tensor on the labels'
            device avoids a copy a call).
        quirk_640: decode at 640 whatever img_size (the reference's
            train.py:796 behaviour).

    Returns (total, bbox, obj, cls) with the semantics of
    `ops/losses.py::yolo_loss_multiscale` on the dense maps that
    `assign_targets_device_masked_batch` builds from the same labels.
    """
    decode_size = 640 if quirk_640 else img_size
    _, winners, slots = transport_slots(labels, valid, anchors_list,
                                        img_size)
    onehot = class_onehot(labels[..., 0].to(torch.int32), num_classes)
    gt_boxes = labels[..., 1:5]

    total = bbox_t = obj_t = cls_t = 0.0
    for pred, win, slot, anchors, obj_w in zip(
            predictions, winners, slots, anchors_list, OBJ_SCALE_WEIGHTS):
        bbox, obj, cls = _scale_loss(pred, gt_boxes, onehot, win, slot,
                                     anchors, num_classes, decode_size)
        total = total + BOX_WEIGHT * bbox + obj_w * obj + CLS_WEIGHT * cls
        bbox_t = bbox_t + bbox
        obj_t = obj_t + obj
        cls_t = cls_t + cls
    return total, bbox_t, obj_t, cls_t
