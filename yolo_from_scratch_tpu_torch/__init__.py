"""PyTorch + CUDA port of the YOLOv5-style detector in `yolo_from_scratch_tpu`.

The JAX package beside this one is the reference the port is held against:
module paths and names mirror it, so every function here has its
counterpart at the same relative path there. Public functions keep the JAX
layouts (images NHWC `(B, S, S, 3)`, head outputs `(B, H, W, A, 5+nc)`);
inside the model tensors are NCHW.

This package imports `torch` and never `jax`, and nothing of the JAX
package: the host-side configuration (`config.py`) and data layer
(`data/letterbox.py`, `data/dataset.py`, `data/loader.py`) are the port's
own copies, held bit-equal to the JAX package's by the tests.

Ported so far: single-image, pipelined and batched serving (letterbox on
the host or the device -> forward -> decode -> gate -> top-k -> class-aware
greedy NMS, one launch a batch), training and evaluation with mAP and
detection P/R/F1 for both heads (dense, compact-label and streamed, the
scanned trainers as CUDA graphs; `--resume`, `--ema`, `--multi-scale`,
host `--augment`, the per-step learning rate and gradient accumulation),
the k-means anchors, post-training int8 serving (`--int8`) and frozen
serving artifacts (`--export`, `.yexp`), and the conv-backward prototype
benchmarks; every TPU kernel of the JAX package is a CUDA kernel written
by hand (`csrc/`), as are the int8 serving conv's two kernels.
"""

from yolo_from_scratch_tpu_torch.config import (
    DEFAULT_ANCHORS,
    INV255,
    YOLO_SIZES,
    YoloConfig,
)

__all__ = ["YoloConfig", "YOLO_SIZES", "DEFAULT_ANCHORS", "INV255"]
