"""Training and evaluation steps (counterpart of
`yolo_from_scratch_tpu/train/steps.py`, both heads, with dense host
targets or compact labels expanded on the device).

A train step is forward in train mode (batch statistics, running-stat
update), the multi-scale loss, backward, clip by global norm 10 and an Adam
update. Clipping is optax's `clip_by_global_norm`: the norm is taken over
every parameter's gradient, and when it is >= 10 each gradient becomes
`g / norm * 10` (not `clip_grad_norm_`, which divides by `norm + 1e-6`);
the choice is made on the device, with no host sync. The anchor-free head
takes the TAL loss (`models/anchor_free.py`) and reports obj = 0, its
objectness being folded into the classes. Adam is optax's
(b1 0.9, b2 0.999, eps 1e-8, bias-corrected `mu_hat / (sqrt(nu_hat) +
eps)`), which `torch.optim.Adam` computes; with a weight decay W > 0 it is
`optax.adamw` (p <- p - lr * (update + W * p), every parameter decayed,
after the clip), which `torch.optim.AdamW` computes. The learning rate is
set per epoch (`set_learning_rate`). The step's metrics stay on the
device.

With `compact_targets` the batch is uint8 images and (labels (B, K, 5),
counts (B,)) and the step builds its targets on the device
(`_make_expand`): the anchor head's dense maps
(`data/assign_device.py`), or with `sparse_loss` none at all
(`ops/losses_sparse.py`), the anchor-free head's GT set for TAL. The device
mosaic and augmentation draw from generators keyed by `state.step`, as
the JAX steps fold `state.step` into their keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from yolo_from_scratch_tpu_torch.config import INV255, STRIDES, YoloConfig
from yolo_from_scratch_tpu_torch.data.assign_device import (
    assign_targets_device_masked_batch,
    prefix_valid,
)
from yolo_from_scratch_tpu_torch.device import upload
from yolo_from_scratch_tpu_torch.models.anchor_free import (
    assign_targets_anchor_free_device_batch,
    yolo_loss_anchor_free,
    yolo_loss_anchor_free_from_gt,
)
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops.augment import (
    augment_compact_batch,
    augment_draws,
    make_device_augment,
    step_generator,
)
from yolo_from_scratch_tpu_torch.ops.losses import yolo_loss_multiscale
from yolo_from_scratch_tpu_torch.ops.losses_sparse import (
    yolo_loss_multiscale_sparse,
)
from yolo_from_scratch_tpu_torch.ops.mosaic_device import (
    mosaic_compact_batch,
    mosaic_draws,
)
from yolo_from_scratch_tpu_torch.train.metrics import (
    grid_metric_counts,
    grid_metric_counts_anchor_free,
)
from yolo_from_scratch_tpu_torch.utils.convert import to_flax_variables

GRAD_CLIP_NORM = 10.0
METRIC_KEYS = ("loss", "bbox", "obj", "cls")
# the mosaic's stream is apart from the flip/jitter one (train/steps.py:299)
MOSAIC_SALT = 0x6D6F7361


@dataclasses.dataclass
class TrainState:
    """The model (float32 master weights and BatchNorm statistics), its
    optimizer, and the number of optimizer steps taken."""

    model: YOLO
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params, learning_rate: float = 1e-2,
                   weight_decay: float = 0.0):
    """Adam with optax's constants, or AdamW (decoupled decay) when
    `weight_decay` > 0; clipping happens in the step."""
    if weight_decay:
        return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def optax_state_dict(state: TrainState) -> dict:
    """The optimizer state as the JAX package's checkpoints hold it:
    `flax.serialization.to_state_dict` of the state of its
    `make_optimizer(lr, weight_decay)`, `optax.inject_hyperparams(chain(
    clip_by_global_norm(10), adam(lr) or adamw(lr, weight_decay)))`,
    written out literally (the port cannot import optax):

        {count, hyperparams: {learning_rate}, hyperparams_states: {},
         inner_state: {'0': {} (the clip),
                       '1': {'0': {count, mu, nu} (Adam),
                             '1': {} (Adam: the learning-rate scale;
                                      AdamW: the decay),
                             '2': {} (AdamW only: the learning-rate
                                      scale)}}}

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
    chain = {"0": {"count": np.asarray(steps.pop() if steps else 0, np.int32),
                   "mu": to_flax_variables(moments["exp_avg"])["params"],
                   "nu": to_flax_variables(moments["exp_avg_sq"])["params"]},
             "1": {}}
    if isinstance(state.optimizer, torch.optim.AdamW):
        chain["2"] = {}
    return {
        "count": np.asarray(state.step, np.int32),
        "hyperparams": {"learning_rate": np.asarray(lr, np.float32)},
        "hyperparams_states": {},
        "inner_state": {"0": {}, "1": chain},
    }


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the learning rate of every parameter group (per epoch)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


def create_train_state(cfg: YoloConfig, learning_rate=1e-2, *, seed=0,
                       device, weight_decay: float = 0.0) -> TrainState:
    """A fresh model from `YOLO.reset_parameters` with a generator seeded
    by `seed`, on `device`, with its Adam (AdamW when `weight_decay`)."""
    model = YOLO(cfg).reset_parameters(torch.Generator().manual_seed(seed))
    model.to(device)
    return TrainState(model, make_optimizer(model.parameters(), learning_rate,
                                            weight_decay))


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


def _af_gt(labels, valid, num_classes):
    """The anchor-free loss's GT set from compact labels: (gt_boxes (B, K,
    4), gt_cls (B, K, nc) one-hot of the clipped ids, zero where invalid,
    gt_valid (B, K) 0/1)."""
    cls_ids = labels[..., 0].to(torch.int32).clamp(0, num_classes - 1)
    gt_cls = F.one_hot(cls_ids.long(), num_classes).float() * valid[..., None]
    return labels[..., 1:5], gt_cls, valid.float()


def make_loss_fn(cfg: YoloConfig, quirk_640: bool = False, device=None, *,
                 af_compact: bool = False, sparse: bool = False):
    """loss_fn(model, images, targets) -> (total, (bbox, obj, cls)), the
    model in train mode (its running statistics move).

    `af_compact`: the anchor-free head with targets the GT tuple of
    `_af_gt`. `sparse`: the anchor head with targets (labels, valid) and
    the gather-based loss."""
    if cfg.head_type == "anchor_free":

        def loss_fn_af(model, images, targets):
            preds = model(_normalize(images), train=True)
            if af_compact:
                total, bbox, cls = yolo_loss_anchor_free_from_gt(
                    preds, *targets, cfg.num_classes, cfg.img_size)
            else:
                total, bbox, cls = yolo_loss_anchor_free(
                    preds, targets, cfg.num_classes, cfg.img_size)
            return total, (bbox, torch.zeros_like(total), cls)

        return loss_fn_af

    anchors = torch.as_tensor(cfg.anchors_array, device=device)

    def loss_fn(model, images, targets):
        preds = model(_normalize(images), train=True)
        if sparse:
            labels, valid = targets
            total, bbox, obj, cls = yolo_loss_multiscale_sparse(
                preds, labels, valid, anchors, cfg.num_classes, cfg.img_size,
                quirk_640)
        else:
            total, bbox, obj, cls = yolo_loss_multiscale(
                preds, targets, anchors, cfg.num_classes, cfg.img_size,
                quirk_640)
        return total, (bbox, obj, cls)

    return loss_fn


def _make_expand(cfg: YoloConfig, compact_targets: bool, device=None, *,
                 mosaic: bool = False, seed: int = 0, device_augment=False,
                 sparse: bool = False):
    """The train and eval steps' input adapter: expand(step, images,
    targets) -> (images, targets). uint8 images are normalized; with
    `compact_targets`, (labels, counts) become, after the device mosaic
    (`mosaic`, its draws from (seed ^ MOSAIC_SALT, step)): the anchor
    head's dense maps, or with `sparse` (labels, valid), or the
    anchor-free head's GT set.

    `device_augment` (True / 'full' flip and jitter, 'flip' the flip
    alone) applies here at label level on the anchor-free and sparse
    paths, its draws from (seed, step); the dense paths take the
    dense-level hook in the step instead."""
    if mosaic and not compact_targets:
        raise ValueError("device mosaic requires compact targets (it "
                         "transforms raw labels, not dense maps)")
    af = cfg.head_type == "anchor_free"
    sparse = sparse and not af
    anchors = torch.as_tensor(cfg.anchors_array, device=device)
    label_augment = bool(device_augment) and (af or sparse)
    jitter = device_augment != "flip"

    def expand(step, images, targets):
        images = _normalize(images)
        if not compact_targets:
            return images, targets
        labels, counts = targets
        b = labels.shape[0]
        if mosaic:
            do, idx = (upload(t, labels.device) for t in mosaic_draws(
                step_generator(seed ^ MOSAIC_SALT, step), b))
            images, labels, valid = mosaic_compact_batch(
                images, labels, counts, 2.0 / cfg.img_size, do, idx)
        else:
            valid = prefix_valid(counts, labels.shape[1])
        if label_augment:
            draws = augment_draws(step_generator(seed, step), b,
                                  jitter=jitter)
            images, labels = augment_compact_batch(
                images, labels, valid,
                *(upload(t, images.device) for t in draws))
        if sparse:
            return images, (labels, valid)
        if af:
            return images, _af_gt(labels, valid, cfg.num_classes)
        return images, assign_targets_device_masked_batch(
            labels, valid, anchors, cfg.img_size, cfg.num_classes)

    return expand


def make_train_step(cfg: YoloConfig, quirk_640: bool = False, device=None, *,
                    device_augment=False, augment_seed: int = 0,
                    compact_targets: bool = False, device_mosaic: bool = False,
                    sparse_loss: bool = False):
    """train_step(state, images, targets) -> (state, metrics): images
    (B, S, S, 3) float32 in [0, 1] or uint8, targets [P3, P4, P5] dense, or
    with `compact_targets` (labels (B, K, 5), counts (B,)), all on
    `device`; metrics are 0-dim device tensors under METRIC_KEYS.

    `device_augment` (False, True / 'full', 'flip'): random hflip and
    photometric jitter on the device; `device_mosaic` (compact only): the
    4-image mosaic; `sparse_loss` (compact, anchor head): the gather-based
    loss, no dense maps. Draws are keyed by `augment_seed` and
    `state.step`."""
    af_compact = compact_targets and cfg.head_type == "anchor_free"
    sparse_loss = sparse_loss and compact_targets and not af_compact
    loss_fn = make_loss_fn(cfg, quirk_640, device, af_compact=af_compact,
                           sparse=sparse_loss)
    # the anchor-free compact and sparse paths augment at label level in
    # expand; the dense-level hook would not take their targets
    aug = (make_device_augment(cfg, augment_seed,
                               jitter=device_augment != "flip")
           if device_augment and not (af_compact or sparse_loss) else None)
    expand = _make_expand(cfg, compact_targets, device, mosaic=device_mosaic,
                          seed=augment_seed, device_augment=device_augment,
                          sparse=sparse_loss)

    def train_step(state: TrainState, images, targets):
        images, targets = expand(state.step, images, targets)
        if aug is not None:
            images, targets = aug(state.step, images, targets)
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
                   quirk_640: bool = False, device=None,
                   compact_targets: bool = False):
    """eval_step(model, images, targets) -> (loss, tp, fp, fn): the eval-mode
    loss and per-image (B,) int32 counts summed over the scales, all on the
    device. With `compact_targets` the batch is uint8 images and (labels,
    counts): the anchor head's maps are built on the device; the
    anchor-free head's loss reads the GT set and its grid metric the maps
    of `assign_targets_anchor_free_device_batch`."""
    if cfg.head_type == "anchor_free":

        @torch.no_grad()
        def eval_step_af(model, images, targets):
            preds = model(_normalize(images), train=False)
            if compact_targets:
                labels, counts = targets
                valid = prefix_valid(counts, labels.shape[1])
                loss, _, _ = yolo_loss_anchor_free_from_gt(
                    preds, *_af_gt(labels, valid, cfg.num_classes),
                    cfg.num_classes, cfg.img_size)
                targets = assign_targets_anchor_free_device_batch(
                    labels, counts, cfg.img_size, cfg.num_classes)
            else:
                loss, _, _ = yolo_loss_anchor_free(
                    preds, targets, cfg.num_classes, cfg.img_size)
            tp = fp = fn = 0
            for pred, tgt, stride in zip(preds, targets, STRIDES):
                t, f, n = grid_metric_counts_anchor_free(
                    pred, tgt, stride, cfg.img_size, conf_threshold,
                    iou_threshold, per_image=True)
                tp, fp, fn = tp + t, fp + f, fn + n
            return loss, tp, fp, fn

        return eval_step_af

    anchors = torch.as_tensor(cfg.anchors_array, device=device)
    expand = _make_expand(cfg, compact_targets, device)

    @torch.no_grad()
    def eval_step(model, images, targets):
        images, targets = expand(0, images, targets)
        preds = model(images, train=False)
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
