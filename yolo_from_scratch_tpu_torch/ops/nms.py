"""Fixed-shape greedy NMS in plain PyTorch (counterpart of
`yolo_from_scratch_tpu/ops/nms.py`).

These are the oracles of the CUDA kernel (`ops/nms_cuda.py`,
`csrc/nms.cu`): the tests compare them with the JAX package, and the
kernel is compared with them on the card. The serving path calls the
kernel's wrapper, which comes here only for tensors on the CPU.

Pivot walk: sort once by descending score; repeatedly take the
highest-ranked box that is neither kept nor suppressed, keep it, and
suppress every lower-ranked box whose IoU with it is strictly greater
than the threshold (torchvision semantics); stop at `max_keep` or when no
box is left. Scores <= NEG_INF/2 are padding and never kept.

Every sort and top-k is `torch.sort(..., descending=True, stable=True)`:
`lax.top_k` and the stable `argsort(-s)` of the JAX package put the lower
index first on ties, and `torch.topk` on CUDA does not promise that.
"""

from __future__ import annotations

import torch

from yolo_from_scratch_tpu_torch.ops.boxes import box_iou_corner

NEG_INF = -1e30


def sort_desc(scores, dim=-1):
    """Stable descending sort: (values, indices), ties in index order."""
    return torch.sort(scores, dim=dim, descending=True, stable=True)


def nms_keep_mask(boxes, scores, iou_threshold, max_keep=None,
                  presorted=False):
    """Greedy NMS on corner-format boxes, with an optional batch dimension.

    Args:
        boxes: (N, 4) or (B, N, 4) [x1, y1, x2, y2].
        scores: (N,) or (B, N). Entries <= NEG_INF/2 are padding.
        iou_threshold: scalar; compared in the boxes' dtype (float32), as
            the JAX package compares a traced float32 threshold.
        max_keep: optional cap on kept boxes per image.
        presorted: scores are already descending per image; skips the sort
            and the scatter back (exact: a stable sort of a sorted vector
            is the identity).

    Returns:
        keep: bool mask of the shape of `scores`, in the ORIGINAL order.
    """
    single = scores.dim() == 1
    if single:
        boxes, scores = boxes[None], scores[None]
    b, n = scores.shape
    if presorted:
        boxes_s, scores_s = boxes, scores
    else:
        order = sort_desc(scores, dim=1).indices
        boxes_s = torch.gather(boxes, 1, order[..., None].expand(b, n, 4))
        scores_s = torch.gather(scores, 1, order)

    thr = torch.tensor(iou_threshold, dtype=boxes.dtype, device=boxes.device)
    ranks = torch.arange(n, device=boxes.device)
    rows = torch.arange(b, device=boxes.device)
    valid = scores_s > NEG_INF / 2
    cap = n if max_keep is None else min(max_keep, n)
    keep = torch.zeros((b, n), dtype=torch.bool, device=boxes.device)
    suppressed = torch.zeros_like(keep)
    count = torch.zeros(b, dtype=torch.long, device=boxes.device)
    while n:
        avail = valid & ~keep & ~suppressed
        active = avail.any(dim=1) & (count < cap)
        if not bool(active.any()):
            break
        # first available rank == highest-scored unprocessed box
        i = torch.where(avail, ranks, n).amin(dim=1).clamp(max=n - 1)
        pivot = boxes_s[rows, i]  # (B, 4)
        iou = box_iou_corner(pivot[:, None, :], boxes_s)  # (B, N)
        later = ranks > i[:, None]
        keep |= (ranks == i[:, None]) & active[:, None]
        suppressed |= (iou > thr) & later & active[:, None]
        count += active

    if not presorted:
        keep = torch.zeros_like(keep).scatter_(1, order, keep)
    return keep[0] if single else keep


def _class_offset_boxes(boxes, classes):
    """Shift boxes per class so distinct classes can never overlap
    (torchvision batched_nms semantics). boxes (..., N, 4), classes
    (..., N); the offset scale is per image (the max finite coordinate)."""
    finite = torch.where(torch.isfinite(boxes), boxes, 0.0)
    max_coord = finite.amax(dim=(-2, -1), keepdim=True)[..., 0]  # (..., 1)
    offset = classes.to(boxes.dtype) * (max_coord + 1.0)
    return boxes + offset[..., None]


def select_top(keep, boxes, scores, classes, max_outputs):
    """Compact a keep mask to `max_outputs` slots by descending score
    (ties: lower index first, as `lax.top_k`). Works on (N, ...) or
    (B, N, ...) inputs. Returns (boxes, scores, classes, valid)."""
    masked = torch.where(keep, scores, NEG_INF)
    top_scores, top_idx = sort_desc(masked)
    top_scores = top_scores[..., :max_outputs]
    top_idx = top_idx[..., :max_outputs]
    out_boxes = torch.gather(
        boxes, -2, top_idx[..., None].expand(*top_idx.shape, 4))
    out_classes = torch.gather(classes, -1, top_idx)
    return out_boxes, top_scores, out_classes, top_scores > NEG_INF / 2


def batched_nms_fixed(boxes, scores, classes, iou_threshold, max_outputs,
                      presorted=False):
    """Class-aware global NMS with fixed-size output.

    Args:
        boxes: (N, 4) corner-format; padding rows carry score NEG_INF.
        scores: (N,).
        classes: (N,) int class ids.
        max_outputs: output capacity K.

    Returns:
        (boxes (K, 4), scores (K,), classes (K,), valid (K,) bool) sorted by
        descending score; invalid slots have score NEG_INF.
    """
    keep = nms_keep_mask(_class_offset_boxes(boxes, classes), scores,
                         iou_threshold, max_keep=max_outputs,
                         presorted=presorted)
    return select_top(keep, boxes, scores, classes, max_outputs)
