"""Warmup + cosine learning-rate schedule, stepped per epoch (a copy of
`yolo_from_scratch_tpu/train/schedule.py::get_lr_lambda` and
`::lr_at_epoch`: importing the JAX package's `train` loads jax and flax).

Linear warmup from warmup_start_lr to initial_lr over `warmup_epochs`,
then cosine decay from initial_lr to min_lr over the remaining epochs.
"""

from __future__ import annotations

import numpy as np


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


def lr_at_epoch(epoch, warmup_epochs=3, total_epochs=100, initial_lr=1e-2,
                min_lr=1e-4, warmup_start_lr=1e-6):
    """Absolute LR at an epoch."""
    return initial_lr * get_lr_lambda(warmup_epochs, total_epochs, initial_lr,
                                      min_lr, warmup_start_lr)(epoch)
