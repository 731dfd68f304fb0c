"""Dense target assignment on the device from compact padded labels
(counterpart of `yolo_from_scratch_tpu/data/assign_device.py`).

The host ships a (K, 5) [class, cx, cy, w, h] array an image, padded to a
fixed capacity K, and a count of valid rows: ~1.3 KB at K=64 instead of
the dense (gs, gs, A, 5+nc) maps (~8.6 MB an image at nc=80 @640). The
maps are rebuilt on the device by batched tensor ops:

- the shape-only IoU of every GT against all 9 anchors is a (B, K, 9)
  min/mul matrix, `+1e-16` on the union, and its argmax (ties go to the
  first index, as numpy's and `torch.argmax` break them);
- grid cell = truncate(centre * gs) clamped to [0, gs-1], as the host's
  `int()` (the product is clamped to [-1, gs] before the cast, so no
  out-of-range float reaches the integer conversion);
- the host's sequential "first GT wins an occupied slot" rule becomes a
  (K, K) matrix of earlier rows on the same (scale, cell, anchor) slot:
  row n wins iff no valid row m < n maps there;
- winners write their [cx, cy, w, h, 1, one-hot] rows into a flat
  (gs*gs*A + 1)-row buffer; losers and padding rows go to the last, dummy
  row, which is sliced off. Live indices are unique, so the scatter is
  deterministic on the card even though the losers collide on the dummy.

Bit-equal to the host `assign_targets` (`data/dataset.py`) and to the JAX
package's `assign_targets_device_masked_batch`
(`tests/test_torch_assign_device.py`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from yolo_from_scratch_tpu_torch.config import NUM_ANCHORS_PER_SCALE, STRIDES


def pack_labels(boxes_list, class_list, capacity: int):
    """Host helper: pad per-image labels to a static capacity.

    Args:
        boxes_list: list of (N_i, 4) float32 [cx, cy, w, h] (letterboxed,
            normalized) arrays.
        class_list: list of (N_i,) int arrays.
        capacity: static K; images with more than K boxes keep the first K
            (file order, matching the reference's first-wins semantics).

    Returns (labels (B, K, 5) f32 [class, cx, cy, w, h], counts (B,) i32).
    """
    b = len(boxes_list)
    labels = np.zeros((b, capacity, 5), np.float32)
    counts = np.zeros((b,), np.int32)
    for i, (boxes, cls) in enumerate(zip(boxes_list, class_list)):
        n = min(len(boxes), capacity)
        counts[i] = n
        if n:
            labels[i, :n, 0] = np.asarray(cls[:n], np.float32)
            labels[i, :n, 1:5] = boxes[:n]
    return labels, counts


def prefix_valid(counts, k: int):
    """(B,) valid-row counts -> (B, K) bool mask of the first counts rows."""
    return torch.arange(k, device=counts.device) < counts[:, None]


def onehot_in_range(cls_ids, num_classes: int):
    """(..., K) int class ids -> (..., K, nc) float32 one-hot; ids outside
    [0, nc) give a row of zeros."""
    in_range = (cls_ids >= 0) & (cls_ids < num_classes)
    onehot = F.one_hot(cls_ids.clamp(0, num_classes - 1).long(),
                       num_classes).float()
    return onehot * in_range[..., None]


def class_onehot(cls_ids, num_classes: int):
    """The class row the assignment writes: (..., K) int -> (..., K, nc)
    float32. nc == 1 writes 1 whatever the id (reference: train.py:
    201-205); for nc > 1 out-of-range ids write zeros."""
    if num_classes == 1:
        return torch.ones(cls_ids.shape + (1,), dtype=torch.float32,
                          device=cls_ids.device)
    return onehot_in_range(cls_ids, num_classes)


def cell_index(x, gs: int):
    """Grid cell of normalized coordinates x: truncation toward zero of
    x * gs, clamped to [0, gs-1] (the host's `max(0, min(int(x*gs),
    gs-1))`), as int64."""
    cell = torch.clamp(x * gs, -1.0, float(gs)).to(torch.int64)
    return cell.clamp(0, gs - 1)


def first_wins(mine, slot):
    """(B, K) bool rows that own their slot: rows in `mine` with no earlier
    row of `mine` on the same slot (row order = the host's file order).
    Rows outside `mine` must sit on a slot no row of `mine` uses."""
    k = slot.shape[-1]
    order = torch.arange(k, device=slot.device)
    earlier = order[None, :] < order[:, None]  # [n, m]: m comes before n
    clash = (slot[..., None, :] == slot[..., :, None]) & earlier
    return mine & ~clash.any(dim=-1)


def scatter_rows(rows, winner, slot, n_slots: int):
    """(B, K, D) rows of the winners written at their slots of a (B,
    n_slots, D) zero buffer; the rest go to a dummy row past the end, which
    is dropped."""
    b = rows.shape[0]
    idx = torch.where(winner, slot, n_slots)
    flat = rows.new_zeros((b, n_slots + 1, rows.shape[-1]))
    batch = torch.arange(b, device=rows.device)[:, None]
    flat.index_put_((batch, idx), rows)
    return flat[:, :-1]


def transport_slots(labels, valid, anchors, img_size: int):
    """Per-GT (scale, cell, anchor) routing and first-wins resolution, the
    transport shared by the dense scatter (below) and the sparse gather
    loss (`ops/losses_sparse.py`).

    labels (B, K, 5), valid (B, K) bool, anchors (3, A, 2) pixels (a
    float32 tensor on the labels' device avoids a copy a call).

    Returns (best_anchor (B, K) int64, winners, slots), winners[s] the
    (B, K) bool rows that own a slot at scale s and slots[s] the (B, K)
    flat index (gy*gs + gx)*A + anchor there (gs*gs*A, the dummy, for rows
    not routed to s)."""
    na = NUM_ANCHORS_PER_SCALE
    boxes = labels[..., 1:5]

    # (B, K, 9) shape-only IoU, both boxes centred at the origin, the same
    # expression as the host _shape_iou_matrix
    wh_px = boxes[..., 2:4] * img_size
    anc = torch.as_tensor(anchors, dtype=torch.float32,
                          device=labels.device).reshape(-1, 2)
    inter = (torch.minimum(wh_px[..., None, 0], anc[:, 0])
             * torch.minimum(wh_px[..., None, 1], anc[:, 1]))
    union = wh_px[..., 0:1] * wh_px[..., 1:2] + anc[:, 0] * anc[:, 1] - inter
    best_flat = torch.argmax(inter / (union + 1e-16), dim=-1)
    best_scale = best_flat // na
    best_anchor = best_flat % na

    winners, slots = [], []
    for s, stride in enumerate(STRIDES):
        gs = img_size // stride
        gx = cell_index(boxes[..., 0], gs)
        gy = cell_index(boxes[..., 1], gs)
        mine = valid & (best_scale == s)
        slot = torch.where(mine, (gy * gs + gx) * na + best_anchor,
                           gs * gs * na)
        winners.append(first_wins(mine, slot))
        slots.append(slot)
    return best_anchor, winners, slots


def assign_targets_device_masked_batch(labels, valid, anchors, img_size: int,
                                       num_classes: int):
    """Dense multi-scale targets of a batch from compact labels and an
    explicit (B, K) validity mask (the device mosaic interleaves the four
    sources' padding rows; first-wins still resolves in row order among
    valid rows, which for a prefix mask is the host's file order).

    Returns [t_p3, t_p4, t_p5], t_i (B, gs_i, gs_i, A, 5+nc) float32,
    bit-equal to the host `assign_targets` of each image."""
    na = NUM_ANCHORS_PER_SCALE
    b = labels.shape[0]
    boxes = labels[..., 1:5]
    onehot = class_onehot(labels[..., 0].to(torch.int32), num_classes)
    rows = torch.cat([boxes, torch.ones_like(boxes[..., :1]), onehot], dim=-1)
    _, winners, slots = transport_slots(labels, valid, anchors, img_size)
    targets = []
    for stride, winner, slot in zip(STRIDES, winners, slots):
        gs = img_size // stride
        flat = scatter_rows(rows, winner, slot, gs * gs * na)
        targets.append(flat.reshape(b, gs, gs, na, 5 + num_classes))
    return targets


def assign_targets_device_batch(labels, counts, anchors, img_size: int,
                                num_classes: int):
    """`assign_targets_device_masked_batch` with the first counts[b] rows
    of image b valid: (B, K, 5) + (B,) -> dense maps with a batch axis."""
    return assign_targets_device_masked_batch(
        labels, prefix_valid(counts, labels.shape[1]), anchors, img_size,
        num_classes)
