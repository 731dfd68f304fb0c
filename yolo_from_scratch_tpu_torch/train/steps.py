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
after the clip), which `torch.optim.AdamW` computes. On the card the
optimizer is capturable: its step count and learning rate are device
tensors, so an update can be captured in a CUDA graph. The learning rate
is set per epoch (`set_learning_rate`). The step's metrics stay on the
device.

With `compact_targets` the batch is uint8 images and (labels (B, K, 5),
counts (B,)) and the step builds its targets on the device
(`_make_expand`): the anchor head's dense maps
(`data/assign_device.py`), or with `sparse_loss` none at all
(`ops/losses_sparse.py`), the anchor-free head's GT set for TAL. The device
mosaic and augmentation draw from generators keyed by `state.step`, as
the JAX steps fold `state.step` into their keys.

The scanned trainers (`make_train_step_multi`, `_multi_compact`,
`_multi_pool`; JAX: N steps in one `lax.scan` a dispatch) take a chunk of N
batches a call. On the CPU they run the N steps eagerly; on the card the N
steps are one CUDA graph (`train/graphs.py`), captured at the first call
and replayed at every later one: the chunk is copied into the graph's
static inputs and the draws of its N steps (`ChunkDraws`) into static
device buffers before each replay. A failed capture raises; nothing falls
back to eager steps on the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

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
                   weight_decay: float = 0.0, capturable: bool = False):
    """Adam with optax's constants, or AdamW (decoupled decay) when
    `weight_decay` > 0; clipping happens in the step.

    `capturable` (CUDA parameters only): torch's capturable Adam, whose
    step count and learning rate (a 0-d float32 tensor on the parameters'
    device) live on the card, so that a CUDA graph can hold the update. It
    computes its bias corrections in float32 tensors where the other takes
    Python floats, so the two differ by ulps."""
    params = list(params)
    kw = {"betas": (0.9, 0.999), "eps": 1e-8}
    if capturable:
        kw.update(capturable=True, foreach=True)
        learning_rate = torch.tensor(float(learning_rate), dtype=torch.float32,
                                     device=params[0].device)
    if weight_decay:
        return torch.optim.AdamW(params, lr=learning_rate,
                                 weight_decay=weight_decay, **kw)
    return torch.optim.Adam(params, lr=learning_rate, **kw)


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
    them (a capturable optimizer's step and learning rate are device
    tensors, read here with `int` and `float`). A parameter that has no
    Adam state yet gets zero moments."""
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
    lr = float(state.optimizer.param_groups[0]["lr"])
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
    """Set the learning rate of every parameter group (per epoch). A
    capturable optimizer's learning rate is a device tensor, filled in
    place: a captured graph reads the tensor it was captured with."""
    for group in state.optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr
    return state


def create_train_state(cfg: YoloConfig, learning_rate=1e-2, *, seed=0,
                       device, weight_decay: float = 0.0) -> TrainState:
    """A fresh model from `YOLO.reset_parameters` with a generator seeded
    by `seed`, on `device`, with its Adam (AdamW when `weight_decay`),
    capturable on a CUDA device."""
    model = YOLO(cfg).reset_parameters(torch.Generator().manual_seed(seed))
    model.to(device)
    return TrainState(model, make_optimizer(
        model.parameters(), learning_rate, weight_decay,
        capturable=torch.device(device).type == "cuda"))


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


class DrawSpec(NamedTuple):
    """Which random draws a train step takes, and their seed: the mosaic's
    from `step_generator(seed ^ MOSAIC_SALT, step)`, the flip and jitter's
    (`jitter` False: the flip alone) from `step_generator(seed, step)`."""

    seed: int
    mosaic: bool
    augment: bool
    jitter: bool

    def draw(self, step: int, b: int) -> dict:
        """One step's draws for a batch of b, on the CPU: {"mosaic": (do,
        idx)} and {"augment": (do_flip, gain, bias)} as the spec asks."""
        out = {}
        if self.mosaic:
            out["mosaic"] = mosaic_draws(
                step_generator(self.seed ^ MOSAIC_SALT, step), b)
        if self.augment:
            out["augment"] = augment_draws(step_generator(self.seed, step), b,
                                           jitter=self.jitter)
        return out


def _upload_draws(draws: dict, device) -> dict:
    return {k: tuple(upload(t, device) for t in v) for k, v in draws.items()}


class ChunkDraws:
    """The draws of N consecutive steps [s, s + N) for a batch of B, in
    static device tensors that a CUDA graph reads (row i for its step i).

    `load(s)` draws the N steps on the host with `DrawSpec.draw`, so a
    chunk's draws are bit-equal to those of N single steps, writes them
    into one of two pinned buffers and copies that to the device buffers
    on the current stream, outside any graph; a pinned buffer is written
    again only once its last copy has left it. On the CPU the static
    tensors are the host buffer itself."""

    def __init__(self, spec: DrawSpec, n: int, b: int, device):
        self.spec, self.n, self.b = spec, n, b
        fields = {}
        if spec.mosaic:
            fields["mosaic"] = (((n, b), torch.bool), ((n, 3, b), torch.int64))
        if spec.augment:
            fields["augment"] = (((n, b), torch.bool),) + (
                (((n, b), torch.float32),) * 2 if spec.jitter else ())
        device = torch.device(device)
        cuda = device.type == "cuda"

        def buffers(dev, pin):
            return {k: [torch.empty(shape, dtype=dtype, device=dev,
                                    pin_memory=pin) for shape, dtype in v]
                    for k, v in fields.items()}

        self._host = [buffers("cpu", cuda) for _ in range(2 if cuda else 1)]
        self.static = buffers(device, False) if cuda else self._host[0]
        self._copied = [None] * len(self._host)
        self._turn = 0

    def load(self, step0: int):
        """Draw steps step0 .. step0 + N - 1 into the static tensors."""
        turn = self._turn
        host = self._host[turn]
        if self._copied[turn] is not None:
            self._copied[turn].synchronize()
        for i in range(self.n):
            for key, values in self.spec.draw(step0 + i, self.b).items():
                for buf, v in zip(host[key], values):
                    buf[i] = v
        if host is self.static:
            return
        for key, bufs in host.items():
            for dst, src in zip(self.static[key], bufs):
                dst.copy_(src, non_blocking=True)
        self._copied[turn] = torch.cuda.Event()
        self._copied[turn].record()
        self._turn = 1 - turn

    def step(self, i: int) -> dict:
        """Step i's draws, views of the static tensors, as `DrawSpec.draw`
        lays them out."""
        out = {k: tuple(t[i] for t in v) for k, v in self.static.items()}
        if "augment" in out and not self.spec.jitter:
            out["augment"] += (None, None)
        return out


def _make_expand(cfg: YoloConfig, compact_targets: bool, device=None, *,
                 mosaic: bool = False, seed: int = 0, device_augment=False,
                 sparse: bool = False):
    """The train and eval steps' input adapter: expand(step, images,
    targets, draws=None) -> (images, targets). uint8 images are normalized;
    with `compact_targets`, (labels, counts) become, after the device
    mosaic (`mosaic`, its draws from (seed ^ MOSAIC_SALT, step)): the
    anchor head's dense maps, or with `sparse` (labels, valid), or the
    anchor-free head's GT set.

    `device_augment` (True / 'full' flip and jitter, 'flip' the flip
    alone) applies here at label level on the anchor-free and sparse
    paths, its draws from (seed, step); the dense paths take the
    dense-level hook in the step instead. `draws` (`DrawSpec.draw`'s
    layout, on the images' device) replaces the step's own draws."""
    if mosaic and not compact_targets:
        raise ValueError("device mosaic requires compact targets (it "
                         "transforms raw labels, not dense maps)")
    af = cfg.head_type == "anchor_free"
    sparse = sparse and not af
    anchors = torch.as_tensor(cfg.anchors_array, device=device)
    label_augment = bool(device_augment) and (af or sparse)
    spec = DrawSpec(seed, mosaic, label_augment, device_augment != "flip")

    def expand(step, images, targets, draws=None):
        images = _normalize(images)
        if not compact_targets:
            return images, targets
        labels, counts = targets
        if draws is None:
            draws = _upload_draws(spec.draw(step, labels.shape[0]),
                                  labels.device)
        if mosaic:
            images, labels, valid = mosaic_compact_batch(
                images, labels, counts, 2.0 / cfg.img_size, *draws["mosaic"])
        else:
            valid = prefix_valid(counts, labels.shape[1])
        if label_augment:
            images, labels = augment_compact_batch(images, labels, valid,
                                                   *draws["augment"])
        if sparse:
            return images, (labels, valid)
        if af:
            return images, _af_gt(labels, valid, cfg.num_classes)
        return images, assign_targets_device_masked_batch(
            labels, valid, anchors, cfg.img_size, cfg.num_classes)

    return expand


def _make_step_body(cfg: YoloConfig, quirk_640: bool, device, *,
                    device_augment, augment_seed: int, compact_targets: bool,
                    device_mosaic: bool, sparse_loss: bool):
    """(spec, body): body(state, images, targets, draws) -> (total, bbox,
    obj, cls) runs one optimizer update with `draws` (`spec.draw`'s
    layout, on the images' device) and leaves `state.step` to its
    caller."""
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
    spec = DrawSpec(augment_seed, bool(device_mosaic), bool(device_augment),
                    device_augment != "flip")

    def body(state, images, targets, draws):
        images, targets = expand(state.step, images, targets, draws)
        if aug is not None:
            images, targets = aug(state.step, images, targets,
                                  draws["augment"])
        state.optimizer.zero_grad(set_to_none=True)
        total, (bbox, obj, cls) = loss_fn(state.model, images, targets)
        total.backward()
        clip_by_global_norm_([p.grad for p in state.model.parameters()])
        state.optimizer.step()
        return tuple(t.detach() for t in (total, bbox, obj, cls))

    return spec, body


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
    spec, body = _make_step_body(
        cfg, quirk_640, device, device_augment=device_augment,
        augment_seed=augment_seed, compact_targets=compact_targets,
        device_mosaic=device_mosaic, sparse_loss=sparse_loss)

    def train_step(state: TrainState, images, targets):
        draws = _upload_draws(spec.draw(state.step, images.shape[0]),
                              images.device)
        metrics = body(state, images, targets, draws)
        state.step += 1
        return state, dict(zip(METRIC_KEYS, metrics))

    return train_step


class _ChunkTrainer:
    """N optimizer steps of `body` a call (the port's `lax.scan` over a
    chunk): eagerly on the CPU, the plain version; on the card as one CUDA
    graph, captured at the first call for a state and input layout and
    replayed at every later one.

    train_steps(state, *resident, *chunk) -> (state, metrics): `chunk`
    tensors have N leading (and B next) and are copied into the graph's
    static inputs each call; `resident` tensors (the sample pool) are
    read where they lie and must be the same tensors at every replay.
    `select(resident, chunk, i)` gives step i's (images, targets). The
    metrics are the means over the N steps of each step's METRIC_KEYS, as
    `jax.tree.map(jnp.mean, metrics)` gives them; `state.step` advances
    by N."""

    def __init__(self, spec, body, select, n_resident=0):
        self.spec, self.body, self.select = spec, body, select
        self.n_resident = n_resident
        self._graph = None

    def _steps(self, state, resident, chunk, draws, metrics, count):
        for i in range(count):
            images, targets = self.select(resident, chunk, i)
            metrics[i] = torch.stack(self.body(state, images, targets,
                                               draws.step(i)))

    def __call__(self, state, *args):
        resident, chunk = args[:self.n_resident], args[self.n_resident:]
        n, b = chunk[0].shape[:2]
        if chunk[0].device.type == "cpu":
            draws = ChunkDraws(self.spec, n, b, "cpu")
            draws.load(state.step)
            metrics = torch.empty((n, len(METRIC_KEYS)))
            self._steps(state, resident, chunk, draws, metrics, n)
        else:
            metrics = self._replay(state, resident, chunk, n, b)
        state.step += n
        return state, dict(zip(METRIC_KEYS, metrics.mean(0).unbind()))

    def _replay(self, state, resident, chunk, n, b):
        # the graph holds its model and optimizer, so their ids stay unique
        key = (id(state.model), id(state.optimizer),
               tuple((t.shape, t.dtype, t.device) for t in chunk),
               tuple((t.data_ptr(), t.shape, t.dtype) for t in resident))
        if self._graph is None or self._graph[0] != key:
            self._graph = None  # the old graph's memory goes first
            self._graph = (key, state.model, state.optimizer,
                           *self._capture(state, resident, chunk, n, b))
        graph, inputs, draws, metrics = self._graph[3:]
        for dst, src in zip(inputs, chunk):
            dst.copy_(src, non_blocking=True)
        draws.load(state.step)
        graph.replay()
        return metrics

    def _capture(self, state, resident, chunk, n, b):
        from yolo_from_scratch_tpu_torch.train import graphs

        device = chunk[0].device
        inputs = [torch.empty_like(t) for t in chunk]
        for dst, src in zip(inputs, chunk):
            dst.copy_(src)
        draws = ChunkDraws(self.spec, n, b, device)
        draws.load(state.step)
        metrics = torch.zeros((n, len(METRIC_KEYS)), device=device)
        graph = graphs.capture(
            lambda: self._steps(state, resident, inputs, draws, metrics, n),
            lambda: self._steps(state, resident, inputs, draws, metrics, 1),
            state.model, state.optimizer)
        return graph, inputs, draws, metrics


def _no_recipe_knobs(af_hp=None, step_lr=None, ema_decay=None):
    for name, value in (("af_hp", af_hp), ("step_lr", step_lr),
                        ("ema_decay", ema_decay)):
        if value is not None:
            raise NotImplementedError(
                f"{name} is not ported yet (af_hp and step_lr are the "
                f"benchmark configs' knobs, ema_decay comes with --ema)")


def make_train_step_multi(cfg: YoloConfig, quirk_640: bool = False,
                          device=None, *, device_augment=False,
                          augment_seed: int = 0):
    """Scanned multi-step trainer on dense targets:
    train_steps(state, images (N, B, S, S, 3) float32 or uint8, t3, t4, t5
    (N, B, g, g, A, 5+nc)) -> (state, metrics averaged over the N steps).
    `device_augment`: the dense-level flip / jitter hook, its draws keyed
    by each step's index (the JAX package's `make_train_step_multi`)."""
    spec, body = _make_step_body(
        cfg, quirk_640, device, device_augment=device_augment,
        augment_seed=augment_seed, compact_targets=False,
        device_mosaic=False, sparse_loss=False)
    return _ChunkTrainer(spec, body, lambda _, c, i: (
        c[0][i], [c[1][i], c[2][i], c[3][i]]))


def make_train_step_multi_compact(cfg: YoloConfig, quirk_640: bool = False,
                                  device=None, *, device_augment=False,
                                  augment_seed: int = 0,
                                  device_mosaic: bool = False,
                                  sparse_loss: bool = False, af_hp=None,
                                  step_lr=None, ema_decay=None):
    """Scanned multi-step trainer fed by compact labels, both heads:
    train_steps(state, images (N, B, S, S, 3) uint8 or float32, labels
    (N, B, K, 5), counts (N, B)) -> (state, metrics averaged over the N
    steps); the targets are built on the device in each step, as in
    `make_train_step(compact_targets=True)`. `af_hp`, `step_lr` and
    `ema_decay` are not ported and raise NotImplementedError."""
    _no_recipe_knobs(af_hp, step_lr, ema_decay)
    spec, body = _make_step_body(
        cfg, quirk_640, device, device_augment=device_augment,
        augment_seed=augment_seed, compact_targets=True,
        device_mosaic=device_mosaic, sparse_loss=sparse_loss)
    return _ChunkTrainer(spec, body, lambda _, c, i: (
        c[0][i], (c[1][i], c[2][i])))


def _pool_batch(pool, chunk, i):
    ix = chunk[0][i]
    return pool[0].index_select(0, ix), (pool[1].index_select(0, ix),
                                         pool[2].index_select(0, ix))


def make_train_step_multi_pool(cfg: YoloConfig, quirk_640: bool = False,
                               device=None, *, device_augment=False,
                               augment_seed: int = 0,
                               device_mosaic: bool = False,
                               sparse_loss: bool = False, af_hp=None):
    """Scanned multi-step trainer sampling from a device-resident pool
    (`data/stream.py::PoolStream`): train_steps(state, pool_images (P, S,
    S, 3) uint8, pool_labels (P, K, 5), pool_counts (P,), idx (N, B)
    int32) -> (state, metrics); step i gathers its batch at idx[i]. The
    pool is read where it lies, never copied: its writer updates it in
    place between calls. `af_hp` is not ported and raises
    NotImplementedError."""
    _no_recipe_knobs(af_hp)
    spec, body = _make_step_body(
        cfg, quirk_640, device, device_augment=device_augment,
        augment_seed=augment_seed, compact_targets=True,
        device_mosaic=device_mosaic, sparse_loss=sparse_loss)
    return _ChunkTrainer(spec, body, _pool_batch, n_resident=3)


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
