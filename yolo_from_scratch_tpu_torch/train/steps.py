"""Training and evaluation steps (counterpart of
`yolo_from_scratch_tpu/train/steps.py`, both heads with dense host
targets).

A train step is forward in train mode (batch statistics, running-stat
update), the multi-scale loss, backward, clip by global norm 10 and an Adam
update. Clipping is optax's `clip_by_global_norm`: the norm is taken over
every parameter's gradient, and when it is >= 10 each gradient becomes
`g / norm * 10` (not `clip_grad_norm_`, which divides by `norm + 1e-6`);
the choice is made on the device, with no host sync. The anchor-free head
takes the TAL loss (`models/anchor_free.py`) and reports obj = 0, its
objectness being folded into the classes. Adam is optax's
(b1 0.9, b2 0.999, eps 1e-8, bias-corrected `mu_hat / (sqrt(nu_hat) +
eps)`), which `torch.optim.Adam` computes. The learning rate is set per
epoch (`set_learning_rate`). The step's metrics stay on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from yolo_from_scratch_tpu_torch.config import INV255, STRIDES, YoloConfig
from yolo_from_scratch_tpu_torch.models.anchor_free import (
    yolo_loss_anchor_free,
)
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops.losses import yolo_loss_multiscale
from yolo_from_scratch_tpu_torch.train.metrics import (
    grid_metric_counts,
    grid_metric_counts_anchor_free,
)
from yolo_from_scratch_tpu_torch.utils.convert import to_flax_variables

GRAD_CLIP_NORM = 10.0
METRIC_KEYS = ("loss", "bbox", "obj", "cls")


@dataclasses.dataclass
class TrainState:
    """The model (float32 master weights and BatchNorm statistics), its
    optimizer, and the number of optimizer steps taken."""

    model: YOLO
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params, learning_rate: float = 1e-2):
    """Adam with optax's constants; clipping happens in the step."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def optax_state_dict(state: TrainState) -> dict:
    """The optimizer state as the JAX package's checkpoints hold it:
    `flax.serialization.to_state_dict` of the state of its
    `make_optimizer(lr)`, `optax.inject_hyperparams(chain(
    clip_by_global_norm(10), adam(lr)))`, written out literally (the port
    cannot import optax):

        {count, hyperparams: {learning_rate}, hyperparams_states: {},
         inner_state: {'0': {} (the clip),
                       '1': {'0': {count, mu, nu} (Adam),
                             '1': {} (the learning-rate scale)}}}

    mu and nu are torch's exp_avg and exp_avg_sq in the JAX parameter
    layout (`utils/convert.py::to_flax_variables`); Adam's count is torch's
    per-parameter step, the same for every parameter; inject_hyperparams
    keeps a count of its own, which also advances once an update: the
    state's step. Scalars are 0-d numpy arrays, as `jax.device_get` gives
    them. A parameter that has no Adam state yet gets zero moments."""
    moments = {"exp_avg": {}, "exp_avg_sq": {}}
    steps = set()
    for name, p in state.model.named_parameters():
        adam = state.optimizer.state.get(p, {})
        if adam:
            steps.add(int(adam["step"]))
        for key, tree in moments.items():
            tree[name] = adam[key] if adam else torch.zeros_like(p)
    if len(steps) > 1:
        raise ValueError(f"Adam's step differs between parameters: "
                         f"{sorted(steps)}")
    lr = state.optimizer.param_groups[0]["lr"]
    return {
        "count": np.asarray(state.step, np.int32),
        "hyperparams": {"learning_rate": np.asarray(lr, np.float32)},
        "hyperparams_states": {},
        "inner_state": {
            "0": {},
            "1": {"0": {"count": np.asarray(steps.pop() if steps else 0,
                                            np.int32),
                        "mu": to_flax_variables(moments["exp_avg"])["params"],
                        "nu": to_flax_variables(
                            moments["exp_avg_sq"])["params"]},
                  "1": {}},
        },
    }


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the learning rate of every parameter group (per epoch)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


def create_train_state(cfg: YoloConfig, learning_rate=1e-2, *, seed=0,
                       device) -> TrainState:
    """A fresh model from `YOLO.reset_parameters` with a generator seeded
    by `seed`, on `device`, with its Adam."""
    model = YOLO(cfg).reset_parameters(torch.Generator().manual_seed(seed))
    model.to(device)
    return TrainState(model, make_optimizer(model.parameters(),
                                            learning_rate))


def clip_by_global_norm_(grads, max_norm=GRAD_CLIP_NORM):
    """optax's `clip_by_global_norm`, in place: g stays when the global
    norm is below `max_norm`, else becomes g / norm * max_norm. Returns the
    norm (a device tensor)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


def _normalize(images):
    if images.dtype == torch.uint8:
        # the shared float32 reciprocal, never a divide by 255
        return images.float() * float(INV255)
    return images


def make_loss_fn(cfg: YoloConfig, quirk_640: bool = False, device=None):
    """loss_fn(model, images, targets) -> (total, (bbox, obj, cls)), the
    model in train mode (its running statistics move)."""
    if cfg.head_type == "anchor_free":

        def loss_fn_af(model, images, targets):
            preds = model(_normalize(images), train=True)
            total, bbox, cls = yolo_loss_anchor_free(
                preds, targets, cfg.num_classes, cfg.img_size)
            return total, (bbox, torch.zeros_like(total), cls)

        return loss_fn_af

    anchors = torch.as_tensor(cfg.anchors_array, device=device)

    def loss_fn(model, images, targets):
        preds = model(_normalize(images), train=True)
        total, bbox, obj, cls = yolo_loss_multiscale(
            preds, targets, anchors, cfg.num_classes, cfg.img_size, quirk_640)
        return total, (bbox, obj, cls)

    return loss_fn


def make_train_step(cfg: YoloConfig, quirk_640: bool = False, device=None):
    """train_step(state, images, targets) -> (state, metrics): images
    (B, S, S, 3) float32 in [0, 1] or uint8, targets [P3, P4, P5] dense, all
    on `device`; metrics are 0-dim device tensors under METRIC_KEYS."""
    loss_fn = make_loss_fn(cfg, quirk_640, device)

    def train_step(state: TrainState, images, targets):
        state.optimizer.zero_grad(set_to_none=True)
        total, (bbox, obj, cls) = loss_fn(state.model, images, targets)
        total.backward()
        clip_by_global_norm_([p.grad for p in state.model.parameters()])
        state.optimizer.step()
        state.step += 1
        metrics = dict(zip(METRIC_KEYS, (total, bbox, obj, cls)))
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(cfg: YoloConfig, conf_threshold=0.5, iou_threshold=0.5,
                   quirk_640: bool = False, device=None):
    """eval_step(model, images, targets) -> (loss, tp, fp, fn): the eval-mode
    loss and per-image (B,) int32 counts summed over the scales, all on the
    device."""
    if cfg.head_type == "anchor_free":

        @torch.no_grad()
        def eval_step_af(model, images, targets):
            preds = model(_normalize(images), train=False)
            loss, _, _ = yolo_loss_anchor_free(preds, targets,
                                               cfg.num_classes, cfg.img_size)
            tp = fp = fn = 0
            for pred, tgt, stride in zip(preds, targets, STRIDES):
                t, f, n = grid_metric_counts_anchor_free(
                    pred, tgt, stride, cfg.img_size, conf_threshold,
                    iou_threshold, per_image=True)
                tp, fp, fn = tp + t, fp + f, fn + n
            return loss, tp, fp, fn

        return eval_step_af

    anchors = torch.as_tensor(cfg.anchors_array, device=device)

    @torch.no_grad()
    def eval_step(model, images, targets):
        preds = model(_normalize(images), train=False)
        loss, _, _, _ = yolo_loss_multiscale(
            preds, targets, anchors, cfg.num_classes, cfg.img_size, quirk_640)
        tp = fp = fn = 0
        for pred, tgt, anc in zip(preds, targets, anchors):
            t, f, n = grid_metric_counts(pred, tgt, anc, cfg.img_size,
                                         conf_threshold, iou_threshold,
                                         quirk_640, per_image=True)
            tp, fp, fn = tp + t, fp + f, fn + n
        return loss, tp, fp, fn

    return eval_step
