"""Anchor-free decoupled detection head, YOLOv8-style (counterpart of
`yolo_from_scratch_tpu/models/anchor_free.py`).

- per scale a box branch emitting 4 * REG_MAX distribution logits (DFL:
  each edge distance l/t/r/b is a softmax over REG_MAX bins in stride
  units, decoded as the distribution's expectation) and a class branch
  (objectness folded into the class scores, prior-initialised bias);
- Task-Aligned Assignment (TAL) inside the loss, from the CURRENT
  predictions and detached from the graph: per GT, candidate cells are
  those whose centre lies inside the GT box; the top-k by score^alpha *
  IoU^beta are assigned; a cell claimed by several GTs goes to the one with
  the highest metric. Class targets are the IoU-normalised alignment
  scores; box and DFL losses are weighted by them;
- the dense per-scale maps of `assign_targets_anchor_free` are transport
  only: `_gather_gt` pulls a padded (M, 4 + nc) GT set back out of them.
  The compact-label path feeds the GT set directly and builds the maps on
  the device for the grid metric only
  (`assign_targets_anchor_free_device_batch`).

Every shape is static: the assignment is a dense (B, M, A) tensor program
(M = MAX_GT padded GT slots, A = all cells across scales). TAL, DFL and the
losses are autograd on plain tensors, as in the JAX package; the head's
3x3 convs take the fused conv backward where `ConvBNSiLU`'s gate selects
them.

The loss is not local to a row block: TAL ranks every cell of an image.
On a 2-D mesh (`--spatial`, inside `parallel/mesh.py::data_parallel`)
the loss and `af_assignment_stats` first gather the head outputs (and
the dense transport maps; the GT set is whole on every rank) over the
space group (`parallel/spatial.py::gather_rows`), so every rank of a
space group computes the same loss of its data shard's whole images.
Its counts and means are normalized over the data group alone
(`Mesh.data_view`): the data shards' losses then sum to the global
batch's, L = sum_d L_d, which each space rank of shard d holds whole.
The gather's backward keeps each rank's own rows of dL_d / dP, so the
parameter gradients summed over every rank (the step's all-reduce) are
sum_d dL_d / dtheta, the global batch's gradient. The loss value itself
is held n_space times; the steps report 1 / n_space of it a rank
(`train/steps.py`), so that the ranks' parts sum to L.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolo_from_scratch_tpu_torch.config import INV255, STRIDES
from yolo_from_scratch_tpu_torch.data.assign_device import (
    cell_index,
    first_wins,
    onehot_in_range,
    prefix_valid,
    scatter_rows,
)
from yolo_from_scratch_tpu_torch.device import tf32_disabled
from yolo_from_scratch_tpu_torch.models.blocks import (
    ConvBNSiLU,
    pred_conv,
    uniform_fan_in_,
)
from yolo_from_scratch_tpu_torch.ops.ciou import ciou
from yolo_from_scratch_tpu_torch.parallel.mesh import (
    data_parallel,
    global_count,
    global_max,
    global_sum,
    spatial_mesh,
)
from yolo_from_scratch_tpu_torch.parallel.spatial import gather_rows

REG_MAX = 16      # DFL bins per edge distance (v8 default)
MAX_GT = 32       # padded GT slots per image in the TAL loss
TAL_TOPK = 10     # candidates per GT
TAL_ALPHA = 0.5   # alignment = score^alpha * iou^beta (v8 defaults)
TAL_BETA = 6.0

# size thresholds (fraction of the image) routing a GT to P3/P4/P5 in the
# dense transport maps
AF_SCALE_THRESHOLDS = (0.1, 0.25)


def _cls_prior_bias(prior: float) -> float:
    """Class-score bias so that a fresh sigmoid(cls) is `prior`."""
    return -math.log((1 - prior) / prior)


def v8_cls_prior(num_classes: int, img_size: int, stride: int) -> float:
    """The v8 per-scale class prior: ~5 objects an image spread over the
    scale's (img/stride)^2 cells and nc classes (ultralytics
    Detect.bias_init), clipped to [1e-8, 0.5]."""
    p = 5.0 / num_classes / (img_size / stride) ** 2
    return float(min(max(p, 1e-8), 0.5))


class DecoupledHead(nn.Module):
    """Box (DFL distribution) and class branches, each 2x ConvBNSiLU(3x3)
    + a 1x1 conv with bias -> NHWC (B, H, W, 4 * REG_MAX + nc).

    `cls_prior`: the initial sigmoid(cls) probability `reset_parameters`
    gives the class bias; `YOLO` passes `v8_cls_prior` per scale."""

    def __init__(self, channels, num_classes, cls_prior=0.01, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype or torch.float32
        self.cls_prior = cls_prior
        self.box_conv1 = ConvBNSiLU(channels, channels, 3, **kw)
        self.box_conv2 = ConvBNSiLU(channels, channels, 3, **kw)
        self.box_pred = nn.Conv2d(channels, 4 * REG_MAX, 1, bias=True,
                                  dtype=torch.float32, device=device)
        self.cls_conv1 = ConvBNSiLU(channels, channels, 3, **kw)
        self.cls_conv2 = ConvBNSiLU(channels, channels, 3, **kw)
        self.cls_pred = nn.Conv2d(channels, num_classes, 1, bias=True,
                                  dtype=torch.float32, device=device)

    def reset_parameters(self, generator):
        """The 1x1 convs as the JAX head initialises them: kernels and
        box_pred's bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), cls_pred's bias
        -log((1-p)/p) for p = `cls_prior`. The ConvBNSiLUs reset
        themselves."""
        fan_in = self.box_pred.in_channels
        uniform_fan_in_(self.box_pred.weight, fan_in, generator)
        uniform_fan_in_(self.box_pred.bias, fan_in, generator)
        uniform_fan_in_(self.cls_pred.weight, fan_in, generator)
        with torch.no_grad():
            self.cls_pred.bias.fill_(_cls_prior_bias(self.cls_prior))

    def _pred(self, conv, x):
        return pred_conv(conv, x, self.dtype)

    def forward(self, x, train: bool = False):
        box = self.box_conv2(self.box_conv1(x, train), train)
        cls = self.cls_conv2(self.cls_conv1(x, train), train)
        out = torch.cat([self._pred(self.box_pred, box),
                         self._pred(self.cls_pred, cls)], dim=1)
        return out.permute(0, 2, 3, 1)  # NCHW -> NHWC


def dfl_expectation(dist_logits):
    """(..., 4, REG_MAX) logits -> (..., 4) expected distances (stride
    units): softmax over the bins, dotted with the bin indices."""
    probs = torch.softmax(dist_logits, dim=-1)
    bins = torch.arange(REG_MAX, dtype=probs.dtype, device=probs.device)
    return torch.sum(probs * bins, dim=-1)


def decode_anchor_free(raw, stride, img_size, row_offset: int = 0):
    """(B, H, W, 4*REG_MAX + nc) raw head output -> (B, H, W, 4 + nc):
    normalised centre-format boxes, then the class logits unchanged.

    ltrb = the DFL expectation in stride units; the box spans
    [centre - (l, t), centre + (r, b)]. `row_offset`: the global row of
    the first of the H rows (a row block, `--spatial`); the unit
    stride / img_size is the global grid's already."""
    b, h, w, _ = raw.shape
    dtype, device = raw.dtype, raw.device
    unit = stride / img_size
    dist = raw[..., : 4 * REG_MAX].reshape(b, h, w, 4, REG_MAX)
    ltrb = dfl_expectation(dist) * unit
    cx = ((torch.arange(w, dtype=dtype, device=device) + 0.5) * unit).view(
        1, 1, w)
    cy = ((torch.arange(row_offset, row_offset + h, dtype=dtype,
                        device=device) + 0.5) * unit).view(1, h, 1)
    x1 = cx - ltrb[..., 0]
    y1 = cy - ltrb[..., 1]
    x2 = cx + ltrb[..., 2]
    y2 = cy + ltrb[..., 3]
    boxes = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                        dim=-1)
    return torch.cat([boxes, raw[..., 4 * REG_MAX:]], dim=-1)


def assign_targets_anchor_free(boxes: np.ndarray, class_ids: np.ndarray,
                               img_size: int, num_classes: int):
    """Dense anchor-free targets: [(gs, gs, 4 + 1 + nc)] x3, numpy.

    Channels: 0:4 the box (normalised cx, cy, w, h), 4 the assigned flag,
    5: the one-hot class. A GT goes to the single cell holding its centre
    at the scale max(w, h) picks: <= 10% of the image P3, <= 25% P4, else
    P5; the first GT wins an occupied cell. Transport for the TAL loss and
    the target of the grid-aligned eval metric."""
    grid_sizes = [img_size // s for s in STRIDES]
    targets = [
        np.zeros((gs, gs, 4 + 1 + num_classes), np.float32)
        for gs in grid_sizes
    ]
    for n in range(len(boxes)):
        size = max(boxes[n, 2], boxes[n, 3])
        s = 0 if size <= AF_SCALE_THRESHOLDS[0] else (
            1 if size <= AF_SCALE_THRESHOLDS[1] else 2
        )
        gs = grid_sizes[s]
        gx = max(0, min(int(boxes[n, 0] * gs), gs - 1))
        gy = max(0, min(int(boxes[n, 1] * gs), gs - 1))
        t = targets[s]
        if t[gy, gx, 4] == 0:
            t[gy, gx, 0:4] = boxes[n]
            t[gy, gx, 4] = 1.0
            t[gy, gx, 5 + int(class_ids[n])] = 1.0
    return targets


def assign_targets_anchor_free_device_batch(labels, counts, img_size: int,
                                            num_classes: int):
    """`assign_targets_anchor_free` of a batch on the labels' device, from
    compact labels (B, K, 5) [class, cx, cy, w, h] and (B,) valid counts.

    Returns [(B, gs, gs, 4+1+nc)] x3, bit-equal to the host assignment of
    each image's valid rows: the same size-routed scale, truncating cell
    index and first-GT-wins rule in row order, by the anchor head's
    machinery (`data/assign_device.py`); out-of-range class ids write a
    zero class row, where the host would index out of bounds. The compact
    val loader's grid metric reads these maps (the TAL loss never needs
    them: `yolo_loss_anchor_free_from_gt`)."""
    b, k = labels.shape[:2]
    boxes = labels[..., 1:5]
    valid = prefix_valid(counts, k)
    size = torch.maximum(boxes[..., 2], boxes[..., 3])
    scale = torch.where(size <= AF_SCALE_THRESHOLDS[0], 0,
                        torch.where(size <= AF_SCALE_THRESHOLDS[1], 1, 2))
    onehot = onehot_in_range(labels[..., 0].to(torch.int32), num_classes)
    rows = torch.cat([boxes, torch.ones_like(boxes[..., :1]), onehot], dim=-1)
    targets = []
    for s, stride in enumerate(STRIDES):
        gs = img_size // stride
        mine = valid & (scale == s)
        slot = torch.where(mine, cell_index(boxes[..., 1], gs) * gs
                           + cell_index(boxes[..., 0], gs), gs * gs)
        flat = scatter_rows(rows, first_wins(mine, slot), slot, gs * gs)
        targets.append(flat.reshape(b, gs, gs, 5 + num_classes))
    return targets


def _anchor_points(img_size):
    """Normalised cell centres and per-cell strides over all scales,
    flattened: (A, 2) points, (A,) strides in pixels, numpy float32."""
    pts, strides = [], []
    for s in STRIDES:
        g = img_size // s
        xs = (np.arange(g, dtype=np.float32) + 0.5) * (s / img_size)
        cx, cy = np.meshgrid(xs, xs)  # cx varies along axis 1
        pts.append(np.stack([cx.ravel(), cy.ravel()], axis=1))
        strides.append(np.full(g * g, s, np.float32))
    return np.concatenate(pts), np.concatenate(strides)


@functools.lru_cache(maxsize=8)
def _anchor_tensors(img_size, device):
    """`_anchor_points` on `device`, copied there once per (size, device):
    a copy from pageable host memory in every step would wait for the
    card."""
    pts, strides = _anchor_points(img_size)
    return (torch.from_numpy(pts).to(device),
            torch.from_numpy(strides).to(device))


def _gather_gt(targets, num_classes, max_gt=MAX_GT):
    """Pull the padded GT set back out of the dense transport maps.

    targets: [(B, gs, gs, 4+1+nc)] x3 -> (gt_boxes (B, M, 4) cxcywh,
    gt_cls (B, M, nc) one-hot, gt_valid (B, M) 0/1).

    The JAX version takes `lax.top_k` of the flags, which is stable:
    assigned cells first, each group in index order. `torch.topk` promises
    no order among ties, so this sorts stably and keeps the first M. The
    order matters once an image has more than M GTs (which M survive) and
    when the row order decides a TAL conflict (argmax takes the first)."""
    b = targets[0].shape[0]
    d = 4 + 1 + num_classes
    flat = torch.cat([t.reshape(b, -1, d) for t in targets], dim=1)
    idx = torch.sort(flat[..., 4], dim=1, descending=True,
                     stable=True).indices[:, :max_gt]
    rows = torch.gather(flat, 1, idx[..., None].expand(b, idx.shape[1], d))
    return rows[..., 0:4], rows[..., 5:], rows[..., 4]


def _pairwise_iou_xyxy(gt, pred):
    """gt (B, M, 4) xyxy vs pred (B, A, 4) xyxy -> (B, M, A)."""
    gt = gt[:, :, None, :]
    pred = pred[:, None, :, :]
    ix1 = torch.maximum(gt[..., 0], pred[..., 0])
    iy1 = torch.maximum(gt[..., 1], pred[..., 1])
    ix2 = torch.minimum(gt[..., 2], pred[..., 2])
    iy2 = torch.minimum(gt[..., 3], pred[..., 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    a_gt = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
    a_pr = (pred[..., 2] - pred[..., 0]) * (pred[..., 3] - pred[..., 1])
    return inter / (a_gt + a_pr - inter + 1e-9)


def _kth_threshold(align, topk, impl="iter"):
    """The k-th largest align value of each (B, M) row: the TAL candidate
    threshold.

    impl='iter' (the default): k passes of max-and-mask, which return the
    k-th largest DISTINCT value; it differs from 'sort' where a tie falls
    inside the top k, so it must never be replaced by a top-k.
    impl='sort': the k-th of the sorted values (the JAX `lax.top_k`;
    values do not depend on how ties are ordered)."""
    if impl == "iter":
        x = align
        kth = x.amax(dim=-1, keepdim=True)
        for _ in range(topk - 1):
            x = torch.where(x >= kth, -torch.inf, x)
            kth = x.amax(dim=-1, keepdim=True)
        return kth
    return torch.topk(align, topk, dim=-1).values[..., -1:]


def tal_assign(pred_scores, pred_xyxy, anchor_pts, gt_boxes, gt_cls,
               gt_valid, topk=TAL_TOPK, alpha=TAL_ALPHA, beta=TAL_BETA,
               with_stats=False, topk_impl="iter"):
    """Task-aligned assignment (dense, static shapes).

    Args:
        pred_scores: (B, A, nc) sigmoid class scores.
        pred_xyxy: (B, A, 4) decoded boxes, normalised corners.
        anchor_pts: (A, 2) normalised cell centres.
        gt_boxes: (B, M, 4) cxcywh normalised.
        gt_cls: (B, M, nc) one-hot.
        gt_valid: (B, M) 0/1.
        with_stats: also return "stats", a dict of assignment diagnostics
            (scalars; see `make_af_stats_fn`).

    Returns a dict: fg (B, A) 0/1 foreground mask; target_boxes (B, A, 4)
    the assigned GT (cxcywh); target_scores (B, A, nc) the soft class
    targets (IoU-normalised alignment).

    The einsums select discrete assignments, so they run in full float32:
    TF32 matmuls (10 mantissa bits) would flip them.
    """
    with tf32_disabled():
        return _tal_assign(pred_scores, pred_xyxy, anchor_pts, gt_boxes,
                           gt_cls, gt_valid, topk, alpha, beta, with_stats,
                           topk_impl)


def _tal_assign(pred_scores, pred_xyxy, anchor_pts, gt_boxes, gt_cls,
                gt_valid, topk, alpha, beta, with_stats, topk_impl):
    dtype = pred_scores.dtype
    gt_xyxy = torch.cat([gt_boxes[..., 0:2] - gt_boxes[..., 2:4] / 2,
                         gt_boxes[..., 0:2] + gt_boxes[..., 2:4] / 2], dim=-1)
    # candidates: anchor centre strictly inside the GT box
    ax = anchor_pts[None, None, :, 0]
    ay = anchor_pts[None, None, :, 1]
    in_gt = ((ax > gt_xyxy[..., 0:1]) & (ax < gt_xyxy[..., 2:3])
             & (ay > gt_xyxy[..., 1:2]) & (ay < gt_xyxy[..., 3:4])
             ).to(dtype)                                  # (B, M, A)

    iou = _pairwise_iou_xyxy(gt_xyxy, pred_xyxy)          # (B, M, A)
    # score of each anchor for its GT's class
    gt_score = torch.einsum("bac,bmc->bma", pred_scores, gt_cls)
    align = (torch.pow(gt_score.clamp(min=1e-9), alpha)
             * torch.pow(iou.clamp(min=1e-9), beta)
             * in_gt * gt_valid[..., None])

    # top-k candidates per GT: threshold at the k-th largest align value
    kth = _kth_threshold(align, topk, topk_impl)          # (B, M, 1)
    cand = (align >= kth) & (align > 0)                   # (B, M, A)

    # an anchor claimed by several GTs goes to the one with the highest
    # align; torch.argmax takes the first index on ties, as jnp.argmax
    align_c = torch.where(cand, align, 0.0)
    best_gt = torch.argmax(align_c, dim=1)                # (B, A)
    best_val = align_c.amax(dim=1)                        # (B, A)
    fg = (best_val > 0).to(dtype)

    onehot_m = F.one_hot(best_gt, gt_boxes.shape[1]).to(dtype)  # (B, A, M)
    assigned = onehot_m * fg[..., None]                   # anchor -> GT

    target_boxes = torch.einsum("bam,bmk->bak", assigned, gt_boxes)

    # v8 normalisation: per GT, scale align so its max equals the GT's max
    # IoU; soft class target = one-hot(class) * normalised align
    assigned_t = assigned.transpose(1, 2)
    align_res = align * assigned_t                        # keep winners
    max_align = align_res.amax(dim=2, keepdim=True)       # (B, M, 1)
    max_iou = (iou * assigned_t).amax(dim=2, keepdim=True)
    norm = max_iou / max_align.clamp(min=1e-9)            # (B, M, 1)
    anchor_align = torch.einsum("bma,bam->ba", align_res * norm, onehot_m)
    target_cls_onehot = torch.einsum("bam,bmc->bac", assigned, gt_cls)
    target_scores = target_cls_onehot * anchor_align[..., None]

    out = {"fg": fg, "target_boxes": target_boxes,
           "target_scores": target_scores}
    if with_stats:
        # inside parallel/mesh.py::data_parallel the global batch's: the
        # sums and counts over the ranks in one all-reduce, the maxima by
        # another; the p99 stays this rank's
        per_gt_in = in_gt.sum(dim=2)
        per_gt_sel = cand.to(align.dtype).sum(dim=2)
        per_gt_asn = assigned.sum(dim=1)                  # (B, M)
        starved = (gt_valid > 0) & (per_gt_asn < 0.5)
        max_iou_gt = (iou * in_gt).amax(dim=2)            # (B, M)
        (gt_sum, fg_sum, in_sum, sel_sum, asn_sum, starved_sum, iou_sum,
         align_sum, score_sum, cls_fg_sum) = global_sum(torch.stack([
             gt_valid.sum(), fg.sum(), (per_gt_in * gt_valid).sum(),
             (per_gt_sel * gt_valid).sum(), (per_gt_asn * gt_valid).sum(),
             starved.to(dtype).sum(), (max_iou_gt * gt_valid).sum(),
             best_val.sum(), target_scores.sum(),
             # sigmoid score of the assigned class at fg cells against the
             # background ceiling
             torch.einsum("bac,bac->ba", pred_scores,
                          target_cls_onehot).sum()])).unbind()
        align_max, tgt_score_max, cls_max = global_max(torch.stack([
            best_val.max(), target_scores.max(), pred_scores.max()
        ])).unbind()
        n_gt = gt_sum.clamp(min=1.0)
        n_img = float(global_count(gt_valid.shape[0]))
        n_fg = fg_sum.clamp(min=1.0)
        out["stats"] = {
            "fg_per_img": fg_sum / n_img,
            "gt_per_img": gt_sum / n_img,
            "cand_in_per_gt": in_sum / n_gt,
            "cand_sel_per_gt": sel_sum / n_gt,
            "assigned_per_gt": asn_sum / n_gt,
            "starved_gt_frac": starved_sum / n_gt,
            "gt_best_iou": iou_sum / n_gt,
            "align_fg_mean": align_sum / n_fg,
            "align_max": align_max,
            "tgt_score_sum": score_sum,
            "tgt_score_max": tgt_score_max,
            "cls_fg_mean": cls_fg_sum / n_fg,
            # jnp.percentile's default is the linear interpolation
            "cls_bg_p99": torch.quantile(
                (pred_scores.amax(dim=-1) * (1.0 - fg)).flatten(), 0.99),
            "cls_max": cls_max,
        }
    return out


def _dfl_loss(dist_logits, target_ltrb):
    """Distribution focal loss: cross-entropy against the two integer bins
    bracketing each target distance, linearly weighted (v8).
    dist_logits (..., 4, REG_MAX), target_ltrb (..., 4) in stride units ->
    the per-element loss summed over the 4 edges, (...).

    The target is clipped to REG_MAX - 1 - 1e-3 before the floor, so the
    right bin tl + 1 stays within the REG_MAX bins."""
    t = target_ltrb.clamp(0.0, REG_MAX - 1 - 1e-3)
    tl = torch.floor(t)
    wr = t - tl
    wl = 1.0 - wr
    logp = torch.log_softmax(dist_logits, dim=-1)
    tl_i = tl.long()
    lp_l = torch.gather(logp, -1, tl_i[..., None])[..., 0]
    lp_r = torch.gather(logp, -1, (tl_i + 1)[..., None])[..., 0]
    return torch.sum(-(wl * lp_l + wr * lp_r), dim=-1)


def _flatten_af_preds(predictions, num_classes, img_size):
    """The per-scale head outputs as all-cells tensors: (dist (B, A, 4,
    REG_MAX), cls_logits (B, A, nc), boxes_cxcywh (B, A, 4), boxes_xyxy
    (B, A, 4), anchor_pts (A, 2), strides (A,)), all float32 (a bfloat16
    model's outputs too)."""
    b = predictions[0].shape[0]
    anchor_pts, strides = _anchor_tensors(img_size, predictions[0].device)
    dist_all, cls_all, boxes_all = [], [], []
    for pred, stride in zip(predictions, STRIDES):
        _, h, w, _ = pred.shape
        dist_all.append(pred[..., : 4 * REG_MAX].reshape(b, h * w, 4, REG_MAX))
        cls_all.append(pred[..., 4 * REG_MAX:].reshape(b, h * w, num_classes))
        decoded = decode_anchor_free(pred, stride, img_size)
        boxes_all.append(decoded[..., 0:4].reshape(b, h * w, 4))
    dist = torch.cat(dist_all, dim=1).float()
    cls_logits = torch.cat(cls_all, dim=1).float()
    boxes_cxcywh = torch.cat(boxes_all, dim=1).float()
    boxes_xyxy = torch.cat(
        [boxes_cxcywh[..., 0:2] - boxes_cxcywh[..., 2:4] / 2,
         boxes_cxcywh[..., 0:2] + boxes_cxcywh[..., 2:4] / 2], dim=-1)
    return dist, cls_logits, boxes_cxcywh, boxes_xyxy, anchor_pts, strides


def _target_ltrb(target_boxes, anchor_pts, strides, img_size):
    """Edge distances in stride units from each cell's centre to its
    assigned box (cxcywh): (B, A, 4)."""
    t_xyxy = torch.cat(
        [target_boxes[..., 0:2] - target_boxes[..., 2:4] / 2,
         target_boxes[..., 0:2] + target_boxes[..., 2:4] / 2], dim=-1)
    scale = (img_size / strides)[None, :, None]           # norm -> strides
    return torch.cat([anchor_pts[None] - t_xyxy[..., 0:2],
                      t_xyxy[..., 2:4] - anchor_pts[None]], dim=-1) * scale


def yolo_loss_anchor_free(predictions, targets, num_classes, img_size,
                          box_weight=7.5, cls_weight=0.5, dfl_weight=1.5,
                          **tal_kw):
    """v8-recipe anchor-free loss on the dense transport maps: TAL
    assignment from the current predictions, then BCE on soft class
    targets over ALL cells + CIoU + DFL on assigned cells, all weighted by
    the alignment scores. Returns (total, bbox, cls)."""
    mesh = spatial_mesh()
    if mesh is not None:
        targets = [gather_rows(t, mesh) for t in targets]
    gt_boxes, gt_cls, gt_valid = _gather_gt(targets, num_classes)
    return yolo_loss_anchor_free_from_gt(
        predictions, gt_boxes, gt_cls, gt_valid, num_classes, img_size,
        box_weight, cls_weight, dfl_weight, **tal_kw,
    )


def yolo_loss_anchor_free_from_gt(predictions, gt_boxes, gt_cls, gt_valid,
                                  num_classes, img_size, box_weight=7.5,
                                  cls_weight=0.5, dfl_weight=1.5,
                                  topk=TAL_TOPK, alpha=TAL_ALPHA,
                                  beta=TAL_BETA):
    """The anchor-free loss on an explicit padded GT set: gt_boxes (B, M,
    4) cxcywh normalised, gt_cls (B, M, nc) one-hot (zero rows where
    invalid), gt_valid (B, M) 0/1. Returns (total, bbox, cls). On a row
    block, the loss of the gathered images over the data group (module
    docstring)."""
    mesh = spatial_mesh()
    if mesh is not None:
        predictions = [gather_rows(p, mesh) for p in predictions]
        with data_parallel(mesh.data_view()):
            return _loss_from_gt(predictions, gt_boxes, gt_cls, gt_valid,
                                 num_classes, img_size, box_weight,
                                 cls_weight, dfl_weight, topk, alpha, beta)
    return _loss_from_gt(predictions, gt_boxes, gt_cls, gt_valid,
                         num_classes, img_size, box_weight, cls_weight,
                         dfl_weight, topk, alpha, beta)


def _loss_from_gt(predictions, gt_boxes, gt_cls, gt_valid, num_classes,
                  img_size, box_weight, cls_weight, dfl_weight, topk, alpha,
                  beta):
    dist, cls_logits, boxes_cxcywh, boxes_xyxy, anchor_pts, strides = (
        _flatten_af_preds(predictions, num_classes, img_size)
    )

    # v8 semantics: the assigner runs DETACHED (the JAX package's
    # stop_gradient, ultralytics' no_grad). A graph through the (B, M, A)
    # assignment would leak a target-side gradient into the class branch
    # and pay for the assignment's backward.
    with torch.no_grad():
        asn = tal_assign(torch.sigmoid(cls_logits).detach(),
                         boxes_xyxy.detach(), anchor_pts, gt_boxes, gt_cls,
                         gt_valid, topk=topk, alpha=alpha, beta=beta)
    fg = asn["fg"]
    target_scores = asn["target_scores"]
    # the global batch's inside parallel/mesh.py::data_parallel
    score_sum = global_sum(target_scores.sum()).clamp(min=1.0)

    # classification: BCE against the soft targets over every cell.
    # binary_cross_entropy_with_logits is optax's sigmoid_binary_cross_
    # entropy within float32 rounding (another arrangement of
    # -z log s(x) - (1 - z) log s(-x))
    cls_loss = F.binary_cross_entropy_with_logits(
        cls_logits, target_scores, reduction="none").sum() / score_sum

    # box: CIoU on foreground cells, weighted by the (summed) soft score
    w_fg = target_scores.sum(dim=-1) * fg                 # (B, A)
    ciou_term = (1.0 - ciou(boxes_cxcywh, asn["target_boxes"])) * w_fg
    box_loss = ciou_term.sum() / score_sum

    # DFL: target edge distances in stride units from the assigned boxes
    ltrb = _target_ltrb(asn["target_boxes"], anchor_pts, strides, img_size)
    dfl_loss_v = (_dfl_loss(dist, ltrb) * w_fg).sum() / score_sum

    total = (box_weight * box_loss + cls_weight * cls_loss
             + dfl_weight * dfl_loss_v)
    return total, box_loss, cls_loss


def af_assignment_stats(predictions, gt_boxes, gt_cls, gt_valid,
                        num_classes, img_size, topk=TAL_TOPK,
                        alpha=TAL_ALPHA, beta=TAL_BETA):
    """TAL diagnostics on one batch: the `tal_assign` stats plus the
    per-scale foreground split and the DFL target-clipping fraction (fg
    cells whose true edge distance exceeds REG_MAX - 1 stride units, which
    the DFL head cannot regress to). A dict of 0-d tensors. On a row block,
    the statistics of the gathered images over the data group, the same
    on every rank of a space group."""
    mesh = spatial_mesh()
    if mesh is not None:
        predictions = [gather_rows(p, mesh) for p in predictions]
        with data_parallel(mesh.data_view()):
            return af_assignment_stats(predictions, gt_boxes, gt_cls,
                                       gt_valid, num_classes, img_size,
                                       topk, alpha, beta)
    _, cls_logits, _, boxes_xyxy, anchor_pts, strides = (
        _flatten_af_preds(predictions, num_classes, img_size)
    )
    asn = tal_assign(torch.sigmoid(cls_logits), boxes_xyxy, anchor_pts,
                     gt_boxes, gt_cls, gt_valid, topk=topk, alpha=alpha,
                     beta=beta, with_stats=True)
    stats = asn["stats"]
    fg = asn["fg"]
    n_img = float(fg.shape[0])

    bounds = np.cumsum([0] + [(img_size // s) ** 2 for s in STRIDES])
    for i, name in enumerate(("p3", "p4", "p5")):
        stats[f"fg_{name}_per_img"] = (
            fg[:, bounds[i]:bounds[i + 1]].sum() / n_img)

    ltrb = _target_ltrb(asn["target_boxes"], anchor_pts, strides, img_size)
    clipped = (ltrb > (REG_MAX - 1)).any(dim=-1).float()
    stats["dfl_clip_frac"] = (clipped * fg).sum() / fg.sum().clamp(min=1.0)
    return stats


def make_af_stats_fn(model, cfg, topk=TAL_TOPK, alpha=TAL_ALPHA,
                     beta=TAL_BETA):
    """Probe: stats_fn(images, labels (B, K, 5) [class, cx, cy, w, h],
    counts (B,)) -> dict of TAL diagnostic scalars on a compact batch,
    from `model` (the port's YOLO) in eval mode. uint8 images are
    normalised with the shared INV255, as the trainer does."""

    @torch.no_grad()
    def stats_fn(images, labels, counts):
        if images.dtype == torch.uint8:
            images = images.float() * float(INV255)
        preds = model(images, train=False)
        k = labels.shape[1]
        valid = (torch.arange(k, device=labels.device)[None, :]
                 < counts[:, None]).float()
        cls_ids = labels[..., 0].long().clamp(0, cfg.num_classes - 1)
        gt_cls = F.one_hot(cls_ids, cfg.num_classes).float() * valid[..., None]
        return af_assignment_stats(
            preds, labels[..., 1:5], gt_cls, valid, cfg.num_classes,
            cfg.img_size, topk=topk, alpha=alpha, beta=beta,
        )

    return stats_fn
