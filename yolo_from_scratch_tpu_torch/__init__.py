"""PyTorch + CUDA port of the YOLOv5-style detector in `yolo_from_scratch_tpu`.

The JAX package beside this one is the reference the port is held against:
module paths and names mirror it, so every function here has its
counterpart at the same relative path there. Public functions keep the JAX
layouts (images NHWC `(B, S, S, 3)`, head outputs `(B, H, W, A, 5+nc)`);
inside the model tensors are NCHW.

This package imports `torch` and never `jax`. The host-side configuration
is shared by import (`yolo_from_scratch_tpu.config` and the PIL letterbox
in `yolo_from_scratch_tpu.data.letterbox` load only numpy).

Ported so far: the single-image serving path (letterbox -> forward ->
decode -> gate -> top-k -> class-aware greedy NMS), with NMS as a CUDA
kernel written by hand (`csrc/nms.cu`).
"""

from yolo_from_scratch_tpu.config import (
    DEFAULT_ANCHORS,
    INV255,
    YOLO_SIZES,
    YoloConfig,
)

__all__ = ["YoloConfig", "YOLO_SIZES", "DEFAULT_ANCHORS", "INV255"]
