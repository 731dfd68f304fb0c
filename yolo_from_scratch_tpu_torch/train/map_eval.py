"""COCO-style mAP and detection-level P/R/F1 over the NMS inference path
(the port's copy of `yolo_from_scratch_tpu/train/map_eval.py`).

The reference only reports grid-aligned P/R/F1 (reference:
train.py:960-1032, `train/metrics.py`). This module adds the standard
detector metric: AP per class at configurable IoU thresholds (AP@0.5,
mAP@[.5:.95]) computed from ranked NMS detections with greedy per-image GT
matching and 101-point interpolation (COCO convention), and the
detection-level P/R/F1 at one operating point behind `--val-det`.

Host-side numpy over the `Predictor` / `BatchPredictor` outputs; not a
performance path. Ground truth comes through the port's
`data/dataset.py::parse_label_file`.
"""

from __future__ import annotations

import numpy as np


def _iou_corner(a, b):
    """a (4,) vs b (N, 4) corner boxes -> (N,) IoU."""
    ix1 = np.maximum(a[0], b[:, 0])
    iy1 = np.maximum(a[1], b[:, 1])
    ix2 = np.minimum(a[2], b[:, 2])
    iy2 = np.minimum(a[3], b[:, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a + area_b - inter + 1e-9)


def _average_precision(recall, precision):
    """101-point interpolated AP (COCO convention)."""
    if len(recall) == 0 or recall.max() <= 0.0:
        return 0.0  # no true positive anywhere
    max_recall = float(recall.max())
    recall = np.concatenate([[0.0], recall])
    precision = np.concatenate([[1.0], precision])
    # precision envelope
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    # COCO takes the MAX precision at each recall level: with duplicate
    # recall values keep the first occurrence (the envelope is
    # non-increasing, so the first is the max)
    recall, first = np.unique(recall, return_index=True)
    precision = precision[first]
    points = np.linspace(0, 1, 101)
    interp = np.interp(points, recall, precision)
    interp[points > max_recall + 1e-12] = 0.0  # unreachable recall -> 0
    return float(np.mean(interp))


def average_precision(detections, ground_truths, iou_threshold=0.5,
                      num_classes=1):
    """AP per class + mAP at one IoU threshold.

    Args:
        detections: list (per image) of [(x1, y1, x2, y2, conf, cls), ...]
            — the Predictor output format.
        ground_truths: list (per image) of [(cls, x1, y1, x2, y2), ...].
        iou_threshold: match threshold.

    Returns:
        (mAP, {class_id: AP}) — classes with no GT anywhere are skipped.
    """
    aps = {}
    for c in range(num_classes):
        # flatten detections of class c with image ids, ranked by conf
        rows = []
        for img_id, dets in enumerate(detections):
            for d in dets:
                if int(d[5]) == c:
                    rows.append((float(d[4]), img_id, np.asarray(d[:4])))
        rows.sort(key=lambda r: -r[0])

        gt_per_img = []
        total_gt = 0
        for gts in ground_truths:
            boxes = np.asarray(
                [g[1:5] for g in gts if int(g[0]) == c], np.float32
            ).reshape(-1, 4)
            gt_per_img.append({"boxes": boxes,
                               "used": np.zeros(len(boxes), bool)})
            total_gt += len(boxes)
        if total_gt == 0:
            continue  # class absent from GT: skipped (COCO convention)

        tp = np.zeros(len(rows))
        fp = np.zeros(len(rows))
        for i, (conf, img_id, box) in enumerate(rows):
            gt = gt_per_img[img_id]
            if len(gt["boxes"]) == 0:
                fp[i] = 1
                continue
            # COCO matching: best IoU among UNUSED GTs (an already-claimed
            # GT must not shadow an unmatched one the detection also covers)
            ious = _iou_corner(box, gt["boxes"])
            ious = np.where(gt["used"], -1.0, ious)
            j = int(np.argmax(ious))
            if ious[j] >= iou_threshold:
                tp[i] = 1
                gt["used"][j] = True
            else:
                fp[i] = 1

        cum_tp = np.cumsum(tp)
        cum_fp = np.cumsum(fp)
        recall = cum_tp / total_gt
        precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
        aps[c] = _average_precision(recall, precision)

    mAP = float(np.mean(list(aps.values()))) if aps else 0.0
    return mAP, aps


def detection_prf1(detections, ground_truths, conf_threshold=0.5,
                   iou_threshold=0.5):
    """Detection-level P/R/F1 at a fixed operating point: class-aware
    greedy matching of conf>=threshold NMS detections against GTs.

    This is the head-agnostic counterpart of the reference's grid-aligned
    P/R/F1 — it scores the actual detections a user gets, so it is
    meaningful for BOTH heads (the cell-aligned counter understates
    TAL-trained anchor-free models, train/metrics.py caveat).
    Returns (P%, R%, F1%)."""
    from yolo_from_scratch_tpu_torch.train.metrics import prf1

    tp, fp, fn = detection_counts(detections, ground_truths,
                                  conf_threshold, iou_threshold)
    return prf1(tp, fp, fn)


def detection_counts(detections, ground_truths, conf_threshold=0.5,
                     iou_threshold=0.5):
    """Raw (tp, fp, fn) behind `detection_prf1` — counts are additive
    across dataset shards, which is what lets multi-host --val-det sum
    per-process counts into global metrics (the JAX CLI's multi-host
    path; the port is single-process)."""
    tp = fp = total_gt = 0
    for dets, gts in zip(detections, ground_truths):
        total_gt += len(gts)
        rows = sorted([d for d in dets if d[4] >= conf_threshold],
                      key=lambda d: -d[4])
        gt_boxes = np.asarray([g[1:5] for g in gts],
                              np.float32).reshape(-1, 4)
        gt_cls = np.asarray([int(g[0]) for g in gts], np.int64)
        used = np.zeros(len(gt_boxes), bool)
        for d in rows:
            cand = (~used) & (gt_cls == int(d[5]))
            if cand.any():
                ious = np.where(
                    cand, _iou_corner(np.asarray(d[:4]), gt_boxes), -1.0)
                j = int(np.argmax(ious))
                if ious[j] >= iou_threshold:
                    tp += 1
                    used[j] = True
                    continue
            fp += 1
    return tp, fp, total_gt - tp


def coco_map(detections, ground_truths, num_classes=1,
             iou_thresholds=None):
    """mAP averaged over IoU thresholds .5:.05:.95 (COCO), plus AP@0.5.

    Returns dict with 'map50', 'map' (mAP@[.5:.95]), 'per_class_ap50'.
    """
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 0.96, 0.05)
    results = [
        average_precision(detections, ground_truths, float(t), num_classes)
        for t in iou_thresholds
    ]
    # first threshold is 0.5 by convention; reuse rather than re-matching
    if abs(float(iou_thresholds[0]) - 0.5) < 1e-9:
        map50, per_class = results[0]
    else:
        map50, per_class = average_precision(
            detections, ground_truths, 0.5, num_classes
        )
    return {
        "map50": map50,
        "map": float(np.mean([m for m, _ in results])),
        "per_class_ap50": per_class,
    }


def evaluate_map(predictor, dataset, max_images=None, num_classes=1,
                 batch_size=16):
    """Run the NMS predictor over a YoloDataset's images and compute mAP.

    Ground truth is read from the dataset's label files in ORIGINAL image
    coordinates (the predictor outputs original coords, so no letterbox
    mapping is needed).

    `predictor` may be a single-image `Predictor` or a `BatchPredictor`;
    with a BatchPredictor the images run `batch_size` per call (the final
    chunk is padded with its first image to the full batch, so a batch's
    shapes never change).
    """
    detections, gts = _collect_dets_and_gts(
        predictor, dataset, max_images, batch_size)
    out = coco_map(detections, gts, num_classes)
    p, r, f1 = detection_prf1(detections, gts)
    out.update({"det_precision": p, "det_recall": r, "det_f1": f1})
    return out


def evaluate_det_prf1(predictor, dataset, max_images=None, batch_size=16,
                      conf_threshold=0.5):
    """Detection-level P/R/F1 only (no PR-curve integration) — the lean
    per-epoch variant of `evaluate_map` for `fit(det_eval=...)`. Returns
    (P%, R%, F1%)."""
    detections, gts = _collect_dets_and_gts(
        predictor, dataset, max_images, batch_size)
    return detection_prf1(detections, gts, conf_threshold=conf_threshold)


def evaluate_det_counts(predictor, dataset, indices=None, batch_size=16,
                        conf_threshold=0.5):
    """Raw detection (tp, fp, fn) over `indices` of the dataset (all
    images when None). Counts are additive across shards of the
    dataset."""
    detections, gts = _collect_dets_and_gts(
        predictor, dataset, None, batch_size, indices=indices)
    return detection_counts(detections, gts, conf_threshold=conf_threshold)


def _collect_dets_and_gts(predictor, dataset, max_images=None,
                          batch_size=16, indices=None):
    """Run the predictor over a YoloDataset's images; read GT from its
    label files in ORIGINAL image coordinates (the predictor outputs
    original coords, so no letterbox mapping is needed). `indices`
    restricts to a subset (e.g. one process's shard)."""
    from PIL import Image

    from yolo_from_scratch_tpu_torch.data.dataset import parse_label_file
    from yolo_from_scratch_tpu_torch.infer.predict import BatchPredictor

    if indices is None:
        n_all = (len(dataset) if max_images is None
                 else min(max_images, len(dataset)))
        indices = list(range(n_all))
    else:
        indices = list(indices)
    n = len(indices)
    paths = [dataset.imgs[i] for i in indices]

    if isinstance(predictor, BatchPredictor):
        detections = []
        for start in range(0, n, batch_size):
            chunk = paths[start:start + batch_size]
            pad = batch_size - len(chunk)
            dets = predictor(chunk + chunk[:1] * pad)
            detections.extend(dets[:len(chunk)])
    else:
        detections = [predictor(p) for p in paths]

    gts = []
    for k, i in enumerate(indices):
        with Image.open(paths[k]) as im:
            w, h = im.size
        rows = parse_label_file(dataset.labels[i])
        gt = []
        for cls, cx, cy, bw, bh in rows:
            gt.append((
                int(cls),
                (cx - bw / 2) * w, (cy - bh / 2) * h,
                (cx + bw / 2) * w, (cy + bh / 2) * h,
            ))
        gts.append(gt)
    return detections, gts
