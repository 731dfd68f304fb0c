"""Training augmentation on the device: random horizontal flip of images
and targets, exact, and photometric jitter (counterpart of
`yolo_from_scratch_tpu/ops/augment.py`), as the host's
`augment_image_and_boxes`: flip p=0.5, gain U(0.7, 1.3), bias U(-0.08,
0.08), the result clipped to [0, 1].

The flip is exact in dense-target space: a GT at normalized centre cx
moves to 1 - cx, whose grid cell is gs - 1 - floor(cx * gs) (for cx * gs
not an integer), so the grid's x axis is reversed and the cx channel of
occupied cells rewritten. Shape-only anchor matching is flip-invariant, so
no GT changes scale or anchor.

JAX derives the draws from `state.step` by `fold_in`; torch cannot replay
`jax.random`, so the functions here take their draws explicitly (`do_flip`
(B,) bool, `gain` and `bias` (B,) float32) and `augment_draws` makes them
from a `torch.Generator` seeded by `step_generator(seed, step)`:
deterministic given the seed and the step, different every step, drawn on
the host with no wait on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_from_scratch_tpu_torch.device import upload

FLIP_P = 0.5
GAIN_RANGE = (0.7, 1.3)   # data/dataset.py augment_image_and_boxes
BIAS_RANGE = (-0.08, 0.08)


def step_generator(seed: int, step: int):
    """A CPU `torch.Generator` for one step's draws, seeded from (seed,
    step) through numpy's SeedSequence (distinct pairs give unrelated
    streams)."""
    state = np.random.SeedSequence([seed % 2 ** 64, step]).generate_state(
        1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def augment_draws(generator, b: int, jitter: bool = True):
    """One step's draws on the CPU: do_flip (B,) bool with probability
    FLIP_P, and with `jitter` gain (B,) U(0.7, 1.3) and bias (B,)
    U(-0.08, 0.08), else None for both."""
    do_flip = torch.rand(b, generator=generator) < FLIP_P
    if not jitter:
        return do_flip, None, None
    u = torch.rand(2, b, generator=generator)
    gain = GAIN_RANGE[0] + (GAIN_RANGE[1] - GAIN_RANGE[0]) * u[0]
    bias = BIAS_RANGE[0] + (BIAS_RANGE[1] - BIAS_RANGE[0]) * u[1]
    return do_flip, gain, bias


def flip_images_lr(imgs):
    """Horizontal flip of (..., H, W, C) images."""
    return torch.flip(imgs, dims=(-2,))


def flip_targets_lr(t, x_axis: int):
    """Flip a dense target map along its grid-x axis and rewrite cx ->
    1 - cx on occupied cells. `x_axis`: -3 for anchor targets (gy, gx, A,
    5+nc), -2 for anchor-free ones (gy, gx, 4+1+nc); channel 4 is the
    occupancy flag in both."""
    t = torch.flip(t, dims=(x_axis,))
    cx = torch.where(t[..., 4:5] > 0, 1.0 - t[..., 0:1], t[..., 0:1])
    return torch.cat([cx, t[..., 1:]], dim=-1)


def _jitter(images, gain, bias):
    if gain is None:
        return images
    return torch.clamp(images * gain[:, None, None, None]
                       + bias[:, None, None, None], 0.0, 1.0)


def augment_batch(images, targets, do_flip, gain=None, bias=None,
                  anchor_free: bool = False):
    """Per-image hflip of images and dense targets, then brightness and
    contrast jitter where `gain` and `bias` are given.

    Args:
        images: (B, H, W, C) float32 in [0, 1].
        targets: [t_p3, t_p4, t_p5] dense maps with a batch axis.
        do_flip: (B,) bool; gain, bias: (B,) float32 or None.

    Returns (images, targets)."""
    images = torch.where(do_flip[:, None, None, None],
                         flip_images_lr(images), images)
    x_axis = -2 if anchor_free else -3
    out_targets = []
    for t in targets:
        mask = do_flip.reshape((-1,) + (1,) * (t.dim() - 1))
        out_targets.append(torch.where(mask, flip_targets_lr(t, x_axis), t))
    return _jitter(images, gain, bias), out_targets


def augment_compact_batch(images, labels, valid, do_flip, gain=None,
                          bias=None):
    """`augment_batch` for compact labels (the anchor-free compact path,
    whose TAL reads GT lists, and the sparse anchor loss): hflip of images
    and cx -> 1 - cx on valid rows, then the jitter.

    Args:
        images: (B, H, W, C) float32.
        labels: (B, K, 5) [class, cx, cy, w, h].
        valid: (B, K) bool row mask (flip-invariant).

    Returns (images, labels)."""
    images = torch.where(do_flip[:, None, None, None],
                         flip_images_lr(images), images)
    cx = torch.where(do_flip[:, None] & valid, 1.0 - labels[..., 1],
                     labels[..., 1])
    labels = torch.cat([labels[..., 0:1], cx[..., None], labels[..., 2:]],
                       dim=-1)
    return _jitter(images, gain, bias), labels


def make_device_augment(cfg, seed: int = 0, jitter: bool = True):
    """Step-indexed augmentation hook for the dense train steps:
    aug(step, images, targets) -> (images, targets), its draws from
    `step_generator(seed, step)` on the images' device.

    `jitter=False` is the flip alone: photometric jitter is label noise
    where the class is carried by colour."""
    anchor_free = cfg.head_type == "anchor_free"

    def aug(step, images, targets):
        draws = augment_draws(step_generator(seed, step), images.shape[0],
                              jitter=jitter)
        return augment_batch(images, targets,
                             *(upload(t, images.device) for t in draws),
                             anchor_free=anchor_free)

    return aug
