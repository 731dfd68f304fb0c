"""Plain reference of batched serving: letterbox, forward, decode, the
objectness gate, top-k, class-aware greedy NMS and the mapping back to
the original image.

- Letterbox: scale = min(S / w, S / h), the image resized (bilinear) to
  (int(w * scale), int(h * scale)) and pasted at ((S - w') // 2,
  (S - h') // 2) on an S x S canvas of (114, 114, 114).
- Decode: YOLOv5's, `reference/train.py::decode_boxes`; objectness and
  class probabilities are sigmoids; a prediction's class is its most
  probable one, its score objectness x that probability, and it is a
  candidate when its objectness exceeds `conf`.
- NMS: the `topk` best candidates by score; walking them by descending
  score, a box is kept unless a kept box of its class overlaps it by an
  IoU above `iou`; at most `max_out` are kept.
- Boxes go back to the original image's pixels: (corner - pad) / scale.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.model import (
    ANCHORS_PX,
    NUM_ANCHORS,
    forward,
    normalize,
)
from portbench.reference.train import decode_boxes

PAD = 114


def letterbox(frame: np.ndarray, size: int):
    """(S x S x 3 uint8, scale, pad_top, pad_left) of an HWC uint8 frame."""
    h, w = frame.shape[:2]
    scale = min(size / w, size / h)
    nw, nh = max(1, int(w * scale)), max(1, int(h * scale))
    if (nw, nh) != (w, h):
        from PIL import Image

        frame = np.asarray(Image.fromarray(frame).resize(
            (nw, nh), Image.Resampling.BILINEAR))
    top, left = (size - nh) // 2, (size - nw) // 2
    out = np.full((size, size, 3), PAD, np.uint8)
    out[top:top + nh, left:left + nw] = frame
    return out, scale, top, left


def raw_predictions(p, cfg, frames, device, num=None):
    """Every prediction of a batch of frames: (corners (B, M, 4) in the
    original pixels, objectness (B, M), class probabilities (B, M, nc)),
    float32 on `device`."""
    size = cfg["img_size"]
    boxes = [letterbox(f, size) for f in frames]
    x = normalize(torch.from_numpy(np.stack([b[0] for b in boxes])).to(device))
    geo = torch.tensor([b[1:] for b in boxes], dtype=torch.float32,
                       device=device)
    with torch.no_grad():
        heads = forward(p, cfg, x, train=False, num=num)
    anchors = np.asarray(ANCHORS_PX, np.float32).reshape(3, NUM_ANCHORS, 2)
    corners, obj, cls = [], [], []
    for s, raw in enumerate(heads):
        b = raw.shape[0]
        box = decode_boxes(raw, anchors[s], size).reshape(b, -1, 4) * size
        scale, top, left = (geo[:, i, None] for i in range(3))
        corners.append(torch.stack([
            (box[..., 0] - box[..., 2] / 2 - left) / scale,
            (box[..., 1] - box[..., 3] / 2 - top) / scale,
            (box[..., 0] + box[..., 2] / 2 - left) / scale,
            (box[..., 1] + box[..., 3] / 2 - top) / scale], dim=-1))
        obj.append(torch.sigmoid(raw[..., 4]).reshape(b, -1))
        cls.append(torch.sigmoid(raw[..., 5:]).reshape(b, -1,
                                                      raw.shape[-1] - 5))
    return torch.cat(corners, 1), torch.cat(obj, 1), torch.cat(cls, 1)


def iou_matrix(a, b):
    """IoU of corner boxes a (N, 4) and b (M, 4) -> (N, M)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[:, 2:] - a[:, :2]).clamp(min=0).prod(-1)
    area_b = (b[:, 2:] - b[:, :2]).clamp(min=0).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-9)


def candidates(corners, obj, cls, conf, topk):
    """One image's (boxes, scores, classes) of the `topk` best candidates
    by descending score: a prediction's class is its most probable one,
    its score objectness x that probability, and it is a candidate when
    its objectness exceeds `conf`."""
    prob, label = cls.max(dim=-1)
    score = torch.where(obj > conf, obj * prob, torch.full_like(obj, -1.0))
    order = torch.argsort(score, descending=True)[:topk]
    order = order[score[order] > 0]
    return corners[order], score[order], label[order]


def greedy_walk(box, label, iou, max_out) -> list:
    """Positions kept walking score-sorted boxes: a box is kept unless a
    kept box of its class overlaps it by an IoU above `iou`; at most
    `max_out`."""
    same = label[:, None] == label[None, :]
    over = ((iou_matrix(box, box) > iou) & same).cpu().numpy()
    removed = np.zeros(len(box), bool)
    keep = []
    for i in range(len(box)):
        if removed[i]:
            continue
        keep.append(i)
        if len(keep) == max_out:
            break
        removed |= over[i]
    return keep


def nms(corners, obj, cls, conf, iou, topk, max_out):
    """One image's detections (K, 6) numpy [x1, y1, x2, y2, score, class]
    by descending score."""
    box, sc, lab = candidates(corners, obj, cls, conf, topk)
    keep = torch.as_tensor(greedy_walk(box, lab, iou, max_out),
                           dtype=torch.long, device=box.device)
    return torch.cat([box[keep], sc[keep, None], lab[keep, None].float()],
                     1).cpu().numpy()
