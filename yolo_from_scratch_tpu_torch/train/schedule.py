"""Warmup + cosine learning-rate schedules (a copy of
`yolo_from_scratch_tpu/train/schedule.py`: importing the JAX package's
`train` loads jax and flax).

Per epoch (`get_lr_lambda`, `lr_at_epoch`, the reference's LambdaLR):
linear warmup from warmup_start_lr to initial_lr over `warmup_epochs`,
then cosine decay from initial_lr to min_lr over the remaining epochs.
Per step (`make_step_lr`, the scanned trainers' `step_lr`): the same shape
over optimizer steps, a float32 torch function of a step tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def get_lr_lambda(warmup_epochs=3, total_epochs=100, initial_lr=1e-2,
                  min_lr=1e-4, warmup_start_lr=1e-6):
    """epoch -> LR multiplier (relative to initial_lr)."""

    def lr_lambda(epoch):
        if epoch < warmup_epochs:
            return (warmup_start_lr
                    + (initial_lr - warmup_start_lr) * epoch / warmup_epochs
                    ) / initial_lr
        progress = (epoch - warmup_epochs) / (total_epochs - warmup_epochs)
        cosine_decay = 0.5 * (1.0 + np.cos(np.pi * progress))
        return (min_lr + (initial_lr - min_lr) * cosine_decay) / initial_lr

    return lr_lambda


def make_step_lr(total_steps, warmup_steps, initial_lr, min_lr,
                 warmup_start_lr=1e-6):
    """Per-step warmup + cosine: lr_fn(step) -> 0-d float32 tensor on the
    step's device, `step` a tensor (a CUDA graph's device step) or an int.

    Every operation is float32, as XLA compiles the JAX function: its
    Python constants rounded to float32 where they meet the step, and its
    divisions by the constant warm-up length and span rewritten as
    multiplications by float32 constants (XLA folds (initial_lr -
    warmup_start_lr) / warmup_steps and 1 / span, and 0.5 * (initial_lr -
    min_lr), which is exact). The two then differ only where `cos` does,
    by an ulp."""
    warmup_steps = max(int(warmup_steps), 1)
    span = max(int(total_steps) - warmup_steps, 1)
    f32 = np.float32
    ramp = float(f32(f32(initial_lr - warmup_start_lr) / f32(warmup_steps)))
    inv_span = float(f32(1.0) / f32(span))
    half_range = float(f32(0.5) * f32(initial_lr - min_lr))

    def lr_fn(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = s * ramp + warmup_start_lr
        progress = torch.clamp((s - warmup_steps) * inv_span, 0.0, 1.0)
        main = (torch.cos(progress * math.pi) + 1.0) * half_range + min_lr
        return torch.where(s < warmup_steps, warm, main)

    return lr_fn


def lr_at_epoch(epoch, warmup_epochs=3, total_epochs=100, initial_lr=1e-2,
                min_lr=1e-4, warmup_start_lr=1e-6):
    """Absolute LR at an epoch."""
    return initial_lr * get_lr_lambda(warmup_epochs, total_epochs, initial_lr,
                                      min_lr, warmup_start_lr)(epoch)
