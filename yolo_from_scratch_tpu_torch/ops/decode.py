"""YOLOv5-style grid decode (counterpart of
`yolo_from_scratch_tpu/ops/decode.py`):

    b_x = ((2*sigmoid(t_x) - 0.5) + c_x) / grid_w
    b_y = ((2*sigmoid(t_y) - 0.5) + c_y) / grid_h
    b_w = (anchor_w / img_size) * (2*sigmoid(t_w))^2
    b_h = (anchor_h / img_size) * (2*sigmoid(t_h))^2

Objectness / class channels pass through unchanged (they stay logits).
On a row block of the grid (`--spatial`) c_y counts from the block's
first global row and grid_h is the global grid's height.
"""

from __future__ import annotations

import torch


def decode_predictions(raw_preds, anchors, img_size, row_offset: int = 0,
                       grid_h: int | None = None):
    """Decode raw head output to normalized boxes.

    Args:
        raw_preds: (B, H, W, A, 5+nc) raw logits.
        anchors: (A, 2) anchor [w, h] in pixels (at `img_size` scale).
        img_size: image size in pixels used to normalize box dimensions.
        row_offset, grid_h: the global row of the first of the H rows,
            and the global grid's height (default H: the whole grid).

    Returns:
        (B, H, W, A, 5+nc) with channels 0:4 replaced by decoded
        [b_x, b_y, b_w, b_h]; channels 4: are the untouched logits.
    """
    _, h, w, num_anchors, _ = raw_preds.shape
    dtype, device = raw_preds.dtype, raw_preds.device

    grid_x = torch.arange(w, dtype=dtype, device=device).view(1, 1, w, 1)
    grid_y = torch.arange(row_offset, row_offset + h, dtype=dtype,
                          device=device).view(1, h, 1, 1)

    sxy = torch.sigmoid(raw_preds[..., 0:2])
    bx = ((sxy[..., 0] * 2.0 - 0.5) + grid_x) / w
    by = ((sxy[..., 1] * 2.0 - 0.5) + grid_y) / (grid_h or h)

    anchors = torch.as_tensor(anchors, dtype=dtype, device=device)
    anchors = anchors.reshape(1, 1, 1, num_anchors, 2)
    swh = torch.sigmoid(raw_preds[..., 2:4])
    bw = (anchors[..., 0] / img_size) * torch.square(2.0 * swh[..., 0])
    bh = (anchors[..., 1] / img_size) * torch.square(2.0 * swh[..., 1])

    boxes = torch.stack([bx, by, bw, bh], dim=-1)
    return torch.cat([boxes, raw_preds[..., 4:]], dim=-1)
