"""Host letterbox: aspect-preserving PIL bilinear resize + gray pad to a
square. The port's copy of the host path of
`yolo_from_scratch_tpu/data/letterbox.py` (`letterbox_params`,
`letterbox_image`, `adjust_boxes_for_letterbox`), bit-compatible with the
reference (train.py:15-58). The JAX package's on-device letterbox
(`letterbox_device`, `letterbox_device_bucketed`) is not ported yet.
"""

from __future__ import annotations

import numpy as np

PAD_COLOR = (114, 114, 114)


def letterbox_params(orig_w: int, orig_h: int, target_size: int):
    """Scale and padding used by the letterbox transform
    (reference: train.py:36-53)."""
    scale = min(target_size / orig_w, target_size / orig_h)
    # clamp to >=1px so extreme aspect ratios can't produce a zero-size
    # resample (the reference would crash in PIL resize there)
    new_w = max(1, int(orig_w * scale))
    new_h = max(1, int(orig_h * scale))
    pad_left = (target_size - new_w) // 2
    pad_top = (target_size - new_h) // 2
    return scale, pad_top, pad_left, new_w, new_h


def letterbox_image(pil_img, target_size: int = 640, pad_color=PAD_COLOR):
    """PIL letterbox. Returns (np.uint8 HWC image, scale, pad_top, pad_left)."""
    from PIL import Image

    orig_w, orig_h = pil_img.size
    scale, pad_top, pad_left, new_w, new_h = letterbox_params(
        orig_w, orig_h, target_size
    )
    resample = Image.Resampling.BILINEAR if hasattr(Image, "Resampling") else 2
    resized = pil_img.resize((new_w, new_h), resample)
    canvas = Image.new("RGB", (target_size, target_size), pad_color)
    canvas.paste(resized, (pad_left, pad_top))
    return np.asarray(canvas, dtype=np.uint8), scale, pad_top, pad_left


def adjust_boxes_for_letterbox(boxes, orig_w, orig_h, scale, pad_top, pad_left,
                               target_size):
    """Map normalized YOLO boxes from original-image coords to letterboxed
    coords (reference: train.py:156-162). boxes: (N, 4) [cx, cy, w, h]."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4).copy()
    boxes[:, 0] = (boxes[:, 0] * orig_w * scale + pad_left) / target_size
    boxes[:, 1] = (boxes[:, 1] * orig_h * scale + pad_top) / target_size
    boxes[:, 2] = boxes[:, 2] * orig_w * scale / target_size
    boxes[:, 3] = boxes[:, 3] * orig_h * scale / target_size
    return boxes
