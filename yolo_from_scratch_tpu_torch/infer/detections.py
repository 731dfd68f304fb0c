"""Detection tuples of the serving paths' fixed-shape outputs on the host,
shared by the predictors (`infer/predict.py`) and the artifact loader
(`infer/artifact.py`), which imports no model module."""

from __future__ import annotations


def detections(boxes, scores, classes, valid):
    """[(x1, y1, x2, y2, conf, cls), ...] of one image's fixed-shape
    output on the host. One tolist() per column: per-element float()/int()
    costs ~1.5 us a detection."""
    return [(*b, s, c) for b, s, c in zip(boxes[valid].tolist(),
                                          scores[valid].tolist(),
                                          classes[valid].tolist())]


def detections_per_image(boxes, scores, classes, valid, n):
    """Per-image detection lists of the first `n` rows of a batch's
    fixed-shape output on the host."""
    return [detections(boxes[i], scores[i], classes[i], valid[i])
            for i in range(n)]
