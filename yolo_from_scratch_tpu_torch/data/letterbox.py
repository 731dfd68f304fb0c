"""Letterbox: aspect-preserving resize + gray pad to a square (the port's
copy of `yolo_from_scratch_tpu/data/letterbox.py`).

The host path (`letterbox_params`, `letterbox_image`,
`adjust_boxes_for_letterbox`) is PIL bilinear, bit-compatible with the
reference (train.py:15-58). The on-device path (`letterbox_device`,
`letterbox_device_bucketed`, with the host staging helpers `bucket_shape`,
`stage_to_bucket` and `letterbox_geometry`) rebuilds the weight matrices of
`jax.image.scale_and_translate(method="linear", antialias=True)` and
applies them as float32 contractions on the buffers' device, with TF32
off; it matches PIL within ~1.5 uint8 LSB, not bit for bit.
`pack_s2d_host` puts letterboxed images in the packed layouts' input
layout (`models/packed.py`), for the loaders, the predictors and a packed
serving artifact's loader alike.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_from_scratch_tpu_torch.device import tf32_disabled

PAD_COLOR = (114, 114, 114)
PACK_FACTOR = 4  # the packed model input's space-to-depth factor


def pack_s2d_host(x: np.ndarray, f: int = PACK_FACTOR) -> np.ndarray:
    """Space-to-depth on the host: (..., H, W, C) -> (..., H/f, W/f,
    f*f*C), channel (a*f + b)*C + c for pixel phase (a, b)."""
    *lead, h, w, c = x.shape
    x = x.reshape(*lead, h // f, f, w // f, f, c)
    x = np.moveaxis(x, -4, -3)  # (..., h/f, w/f, f, f, c)
    return np.ascontiguousarray(x.reshape(*lead, h // f, w // f, f * f * c))


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


def _pad_value(device):
    """The pad colour in [0, 1], float32, as the JAX package's `c / 255.0`."""
    return torch.tensor([c / 255.0 for c in PAD_COLOR], dtype=torch.float32,
                        device=device)


def _resample_weights(in_size, out_size, scale, translation):
    """Weight matrices (B, in_size, out_size) of
    `jax.image.scale_and_translate(method="linear", antialias=True)` along
    one axis, for per-image float32 `scale` and `translation` (B,): a
    triangle kernel, widened by 1/scale when shrinking, normalised per
    output pixel, zero where the sample falls outside [-0.5, in - 0.5]."""
    device = scale.device
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_pos = torch.arange(out_size, dtype=torch.float32, device=device)
    sample = ((out_pos + 0.5) * inv_scale - translation[:, None] * inv_scale
              - 0.5)  # (B, out)
    in_pos = torch.arange(in_size, dtype=torch.float32, device=device)
    x = (sample[:, None, :] - in_pos[None, :, None]).abs() \
        / kernel_scale[:, None, :]
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def _resample(x, w_rows, w_cols):
    """(B, C, H, W) float32 through (B, H, T_h) and (B, W, T_w) weights ->
    (B, C, T_h, T_w), two float32 contractions with TF32 off (the JAX
    package takes them at HIGHEST precision)."""
    with tf32_disabled():
        rows = torch.matmul(w_rows.transpose(1, 2)[:, None], x)
        return torch.matmul(rows, w_cols[:, None])


def letterbox_device(img, orig_w: int, orig_h: int, target_size: int):
    """On-device letterbox for a single HWC uint8/float tensor.

    `img` may be a staging buffer LARGER than the content; `orig_w` /
    `orig_h` give the real content dims in its top-left corner. Output
    (target_size, target_size, 3) float32 in [0, 1] on `img`'s device; the
    same floor-int scale/pad math as the host letterbox, the bilinear
    antialiased resample of `jax.image.resize` (whose weights are the
    identity along an axis whose size does not change).
    """
    orig_w, orig_h = int(orig_w), int(orig_h)
    if orig_h > img.shape[0] or orig_w > img.shape[1]:
        raise ValueError(
            f"content dims ({orig_h}, {orig_w}) exceed buffer "
            f"{tuple(img.shape[:2])}")
    _, pad_top, pad_left, new_w, new_h = letterbox_params(
        orig_w, orig_h, target_size)
    x = img[:orig_h, :orig_w].to(torch.float32) / 255.0
    scale = torch.tensor([new_h / orig_h, new_w / orig_w],
                         dtype=torch.float32, device=img.device)
    zero = torch.zeros(1, dtype=torch.float32, device=img.device)
    x = _resample(x.permute(2, 0, 1)[None],
                  _resample_weights(orig_h, new_h, scale[:1], zero),
                  _resample_weights(orig_w, new_w, scale[1:], zero))
    canvas = _pad_value(img.device).expand(target_size, target_size,
                                           3).clone()
    canvas[pad_top:pad_top + new_h, pad_left:pad_left + new_w] = \
        x[0].permute(1, 2, 0)
    return canvas


def bucket_shape(h: int, w: int, multiple: int = 256, min_side: int = 256):
    """Staging-buffer shape for an (h, w) image: each side rounded up to
    `multiple`, so a few buffer shapes serve every source geometry."""
    bh = max(min_side, ((h + multiple - 1) // multiple) * multiple)
    bw = max(min_side, ((w + multiple - 1) // multiple) * multiple)
    return bh, bw


def stage_to_bucket(arr: np.ndarray, bucket) -> np.ndarray:
    """Copy an HWC uint8 image into the top-left of a zeroed bucket buffer
    (the zeros are excluded from resampling by the device letterbox's
    weight renormalization)."""
    bh, bw = bucket
    h, w = arr.shape[:2]
    if h > bh or w > bw:
        raise ValueError(f"image ({h}, {w}) exceeds bucket ({bh}, {bw})")
    buf = np.zeros((bh, bw, 3), np.uint8)
    buf[:h, :w] = arr
    return buf


def letterbox_geometry(orig_w: int, orig_h: int, target_size: int):
    """Host-computed geometry row for `letterbox_device_bucketed`:
    [h, w, new_h, new_w, pad_top, pad_left] (float64 floor-int math —
    identical to the host letterbox, so the two paths can never disagree
    on coordinates)."""
    scale, pad_top, pad_left, new_w, new_h = letterbox_params(
        orig_w, orig_h, target_size
    )
    return (
        np.asarray(
            [orig_h, orig_w, new_h, new_w, pad_top, pad_left], np.float32
        ),
        scale, pad_top, pad_left,
    )


def letterbox_device_bucketed(bufs, geoms, target_size: int):
    """Batched on-device letterbox over one staging bucket, each image with
    its own geometry.

    Args:
        bufs: (B, Hb, Wb, 3) uint8 staging buffers, content in the
            top-left, zeros elsewhere (`stage_to_bucket`).
        geoms: (B, 6) float32 [h, w, new_h, new_w, pad_top, pad_left]
            rows from `letterbox_geometry`, on `bufs`' device.
        target_size: output side.

    Returns (B, target, target, 3) float32 in [0, 1].

    The arithmetic of the JAX function: the buffer divided by 255.0 and a
    content mask (rows < h, cols < w) go through the same resample (scale
    new/h, translation pad, the whole bucket as input); the content is
    num / max(den, 1e-6) where den > 0.5 and the pad colour elsewhere.
    """
    b, bh, bw, _ = bufs.shape
    device = bufs.device
    h, w, new_h, new_w, pad_top, pad_left = geoms.to(torch.float32).unbind(1)
    rows = torch.arange(bh, dtype=torch.float32, device=device)
    cols = torch.arange(bw, dtype=torch.float32, device=device)
    mask = ((rows[None, :, None] < h[:, None, None])
            & (cols[None, None, :] < w[:, None, None])).to(torch.float32)
    x = bufs.permute(0, 3, 1, 2).to(torch.float32) / 255.0
    planes = torch.cat([x, mask[:, None]], dim=1)  # (B, 4, Hb, Wb)
    out = _resample(planes,
                    _resample_weights(bh, target_size, new_h / h, pad_top),
                    _resample_weights(bw, target_size, new_w / w, pad_left))
    num, den = out[:, :3], out[:, 3:]
    content = num / torch.clamp(den, min=1e-6)
    pad = _pad_value(device)[None, :, None, None]
    return torch.where(den > 0.5, content, pad).permute(0, 2, 3, 1)


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
