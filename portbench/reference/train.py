"""Plain reference of one training step of the anchor head on compact
labels: target assignment, the three-part YOLO loss, the global-norm
clip and Adam (KhaledSharif/yolo-from-scratch train.py's recipe with
optax's clip and Adam, as the program states them).

- Assignment, on the host, image by image and label by label: the best
  of the nine anchors by shape IoU (both boxes centred at the origin,
  1e-16 on the union, the first on a tie) gives the scale and the
  anchor; the cell is the truncated centre times the grid, clamped to the
  grid; the first label to reach a (scale, cell, anchor) slot keeps it.
  A slot holds [cx, cy, w, h, 1, one-hot class].
- Loss per scale: 1 - CIoU over the assigned slots (mean), objectness BCE
  over every slot (mean), class BCE over the assigned slots' classes
  (mean); total = sum over scales of 0.05 bbox + w_s obj + 0.5 cls with
  w = (4, 1, 0.4) for P3, P4, P5.
- Update: every gradient divided by its global norm over 10 when that
  norm is 10 or more; then Adam (0.9, 0.999, eps 1e-8 outside the square
  root, bias-corrected).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.model import ANCHORS_PX, NUM_ANCHORS, STRIDES

BOX_WEIGHT, CLS_WEIGHT = 0.05, 0.5
OBJ_WEIGHTS = (4.0, 1.0, 0.4)
CLIP_NORM = 10.0
BETAS, EPS = (0.9, 0.999), 1e-8


def assign(labels: np.ndarray, counts: np.ndarray, img_size: int,
           nc: int) -> list:
    """Dense targets [(B, g, g, A, 5 + nc) float32 numpy] a scale from
    compact labels (B, K, 5) [class, cx, cy, w, h] and counts (B,)."""
    anchors = np.asarray(ANCHORS_PX, np.float32)
    grids = [img_size // s for s in STRIDES]
    out = [np.zeros((labels.shape[0], g, g, NUM_ANCHORS, 5 + nc), np.float32)
           for g in grids]
    for b in range(labels.shape[0]):
        for row in labels[b, :counts[b]]:
            cls, cx, cy, w, h = (np.float32(v) for v in row)
            wp, hp = w * np.float32(img_size), h * np.float32(img_size)
            inter = np.minimum(wp, anchors[:, 0]) * np.minimum(hp,
                                                               anchors[:, 1])
            union = wp * hp + anchors[:, 0] * anchors[:, 1] - inter
            best = int(np.argmax(inter / (union + np.float32(1e-16))))
            s, a = divmod(best, NUM_ANCHORS)
            g = grids[s]
            gx = min(max(int(max(min(cx * g, g), -1.0)), 0), g - 1)
            gy = min(max(int(max(min(cy * g, g), -1.0)), 0), g - 1)
            slot = out[s][b, gy, gx, a]
            if slot[4] > 0:
                continue
            slot[0:4] = (cx, cy, w, h)
            slot[4] = 1.0
            k = int(cls)
            if nc == 1:
                slot[5] = 1.0
            elif 0 <= k < nc:
                slot[5 + k] = 1.0
    return out


def _bce(logits, target):
    return F.binary_cross_entropy_with_logits(logits, target,
                                              reduction="none")


def _ciou(p, t, eps=1e-7):
    """Complete IoU of centre-format boxes (..., 4), the aspect term's
    weight held constant."""
    px1, px2 = p[..., 0] - p[..., 2] / 2, p[..., 0] + p[..., 2] / 2
    py1, py2 = p[..., 1] - p[..., 3] / 2, p[..., 1] + p[..., 3] / 2
    tx1, tx2 = t[..., 0] - t[..., 2] / 2, t[..., 0] + t[..., 2] / 2
    ty1, ty2 = t[..., 1] - t[..., 3] / 2, t[..., 1] + t[..., 3] / 2
    iw = (torch.minimum(px2, tx2) - torch.maximum(px1, tx1)).clamp(min=0)
    ih = (torch.minimum(py2, ty2) - torch.maximum(py1, ty1)).clamp(min=0)
    inter = iw * ih
    iou = inter / (p[..., 2] * p[..., 3] + t[..., 2] * t[..., 3] - inter + eps)
    cw = torch.maximum(px2, tx2) - torch.minimum(px1, tx1)
    ch = torch.maximum(py2, ty2) - torch.minimum(py1, ty1)
    rho2 = (p[..., 0] - t[..., 0]) ** 2 + (p[..., 1] - t[..., 1]) ** 2
    v = (4 / math.pi ** 2) * (torch.atan(p[..., 2] / (p[..., 3] + eps))
                              - torch.atan(t[..., 2] / (t[..., 3] + eps))) ** 2
    with torch.no_grad():
        alpha = v / (1 - iou + v + eps)
    return iou - rho2 / (cw ** 2 + ch ** 2 + eps) - alpha * v


def decode_boxes(raw, anchors_px, img_size):
    """(B, H, W, A, 5 + nc) raw outputs -> (B, H, W, A, 4) normalised
    centre boxes: ((2 sigmoid - 0.5) + cell) / grid for the centre,
    anchor / img_size * (2 sigmoid)^2 for the size."""
    _, h, w, _, _ = raw.shape
    gx = torch.arange(w, dtype=raw.dtype, device=raw.device).view(1, 1, w, 1)
    gy = torch.arange(h, dtype=raw.dtype, device=raw.device).view(1, h, 1, 1)
    s = torch.sigmoid(raw[..., 0:4])
    anc = torch.as_tensor(anchors_px, dtype=raw.dtype, device=raw.device)
    bx = (s[..., 0] * 2 - 0.5 + gx) / w
    by = (s[..., 1] * 2 - 0.5 + gy) / h
    bw = anc[:, 0] / img_size * (2 * s[..., 2]) ** 2
    bh = anc[:, 1] / img_size * (2 * s[..., 3]) ** 2
    return torch.stack([bx, by, bw, bh], dim=-1)


def loss(preds, targets, img_size: int):
    """The total loss of head outputs `preds` against dense `targets`
    (tensors on the outputs' device), a 0-d tensor."""
    total = preds[0].new_zeros(())
    anchors = np.asarray(ANCHORS_PX, np.float32).reshape(3, NUM_ANCHORS, 2)
    for s, (raw, tgt) in enumerate(zip(preds, targets)):
        mask = tgt[..., 4] > 0.5
        n = mask.sum().clamp(min=1)
        box = decode_boxes(raw, anchors[s], img_size)
        bbox = ((1 - _ciou(box, tgt[..., 0:4])) * mask).sum() / n
        obj = _bce(raw[..., 4], tgt[..., 4]).mean()
        nc = raw.shape[-1] - 5
        cls = (_bce(raw[..., 5:], tgt[..., 5:]) * mask[..., None]).sum() / (
            n * nc)
        total = total + BOX_WEIGHT * bbox + OBJ_WEIGHTS[s] * obj \
            + CLS_WEIGHT * cls
    return total


def clip(grads: dict) -> dict:
    """Every gradient divided by the global norm over 10 when that norm is
    10 or more."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    factor = 1.0 if norm < CLIP_NORM else CLIP_NORM / float(norm)
    return {k: g * factor for k, g in grads.items()}


class Adam:
    """Adam over a dict of leaf tensors, fed clipped gradients (`clip`)."""

    def __init__(self, params: dict, lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict):
        """Update the parameters in place from clipped `grads`."""
        self.t += 1
        b1, b2 = BETAS
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + EPS))
