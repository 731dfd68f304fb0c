"""Exponential moving average of a model's weights and BatchNorm
statistics (counterpart of `yolo_from_scratch_tpu/train/ema.py`).

The average is a copy of the model (`ema_init`) updated in place after
every optimizer step (`ema_update`), over every parameter and the
BatchNorm buffers `mean` and `var`, as the JAX package averages `params`
and `batch_stats` together (YOLOv5's ModelEMA averages buffers too;
`torch.optim.swa_utils.AveragedModel` by default averages the parameters
alone and has no warm-up term, so it is not used).

YOLOv5-style warm-up: d = decay * (1 - exp(-(step + 1) / tau)), where step
is the optimizer's step count AFTER the update (the JAX wrapper passes
`new_state.step`), computed in float32 on the model's device as `jnp`
computes it; the update is ema * d + model * (1 - d). `step` may be a
Python int or a 0-d tensor: inside a CUDA graph it is a device tensor the
graph reads (`train/steps.py::ChunkDraws`).
"""

from __future__ import annotations

import copy

import torch


def ema_init(model):
    """The average's starting point: a copy of `model` whose tensors are
    its own (a captured graph, or the live weights' next update, must never
    write through to it), with gradients off."""
    ema = copy.deepcopy(model)
    for p in ema.parameters():
        p.requires_grad_(False)
    return ema


def averaged_tensors(model):
    """The tensors an EMA averages, in a fixed order: every parameter, then
    every buffer (BatchNorm's mean and var)."""
    return [*model.parameters(), *model.buffers()]


def ema_decay_at(step, decay=0.9999, tau=2000.0, device=None):
    """The warm-up decay at optimizer step `step`, a 0-d float32 tensor:
    decay * (1 - exp(-(step + 1) / tau))."""
    if torch.is_tensor(step):
        s = step.to(torch.float32)
    else:
        # a fill kernel, not a host-to-device copy
        s = torch.full((), float(step), dtype=torch.float32, device=device)
    return decay * (1.0 - torch.exp(-(s + 1.0) / tau))


@torch.no_grad()
def ema_update(ema, model, step, decay=0.9999, tau=2000.0):
    """One update in place: ema <- ema * d + model * (1 - d) with d
    `ema_decay_at(step)`, over `averaged_tensors`. Returns `ema`."""
    averaged = averaged_tensors(ema)
    live = averaged_tensors(model)
    if len(averaged) != len(live):
        raise ValueError(f"the EMA holds {len(averaged)} tensors, the model "
                         f"{len(live)}")
    d = ema_decay_at(step, decay, tau, averaged[0].device)
    torch._foreach_mul_(averaged, d)
    torch._foreach_add_(averaged, torch._foreach_mul(
        [t.to(a.dtype) for t, a in zip(live, averaged)], 1.0 - d))
    return ema


def wrap_train_step_with_ema(train_step, decay=0.9999, tau=2000.0):
    """Lift a (state, ...) -> (state, metrics) step into ((state, ema),
    ...) -> ((state, ema), metrics): after each step the EMA model is
    updated in place at the step the optimizer has just taken."""

    def stepped(state_and_ema, *args):
        state, ema = state_and_ema
        state, metrics = train_step(state, *args)
        ema_update(ema, state.model, state.step, decay, tau)
        return (state, ema), metrics

    return stepped
