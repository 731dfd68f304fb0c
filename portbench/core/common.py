"""Helpers both cell runners (`train.py`, `serve.py`) share: the
program's config of a configuration file, set-up stage logging, and TF32
switched off for the reference."""

from __future__ import annotations

import sys

import torch


def port_config(cfg: dict):
    """The program's `YoloConfig` of a configuration file's values."""
    from yolo_from_scratch_tpu_torch.config import YoloConfig

    return YoloConfig(num_classes=cfg["num_classes"], img_size=cfg["img_size"],
                      width_mult=cfg["width_mult"],
                      depth_mult=cfg["depth_mult"],
                      compute_dtype=cfg["compute_dtype"],
                      head_type=cfg["head_type"])


def stage(clock, name):
    """Log a set-up stage's end to standard error (`clock`: seconds since
    the process started)."""
    at = f" at {clock():.2f} s" if clock else ""
    print(f"portbench: {name}{at}", file=sys.stderr, flush=True)


class tf32_off:
    """TF32 off for the reference's float32 convs and matmuls."""

    def __enter__(self):
        self.prev = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.prev
        return False
