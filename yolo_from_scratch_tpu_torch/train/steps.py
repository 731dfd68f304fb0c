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
back to eager steps on the card. Under a mesh whose collectives run on
`gloo` (ranks that share one card) nothing can be captured, and the N
steps run eagerly on the card; with NCCL they are in the graph
(`chunk_path` names the path).

The recipe knobs of the JAX package's recipe study: `af_hp` (the
anchor-free loss's weights and TAL's topk / alpha / beta) in every train
step; `step_lr` (a per-step schedule, `train/schedule.py::make_step_lr`)
and `ema_decay` (an EMA of the weights and BatchNorm statistics,
`train/ema.py`) in `make_train_step_multi_compact`, where each step's
index comes from a static device row of the chunk, so that inside a graph
each step writes its own learning rate into the optimizer's lr tensor
before its update and takes its own EMA decay after it.
`make_train_step_accum` takes one update from the mean gradient of
`n_accum` micro-batches.

With a `mesh` (`parallel/mesh.py`, one process a rank) `make_train_step`
and `make_train_step_accum` are the JAX package's data-parallel step over
the global batch: the loss and train-mode BatchNorm run inside
`data_parallel(mesh)` (global statistics and normalizers, each rank's
loss its part of the global one), and the gradients are summed over the
ranks in one flattened all-reduce before the clip, whose norm is then the
global gradient's. A step's random draws are those of the global batch
(B x n_data rows, from the same generators), of which each rank takes
the rows of its data shard, [d * B, (d + 1) * B). The device mosaic's
partners come from the whole global batch: its `idx` keeps its global
values, and each step first gathers the global uint8 batch and its labels
over the ranks whose batches differ (`parallel/mesh.py::gather_batch`),
then composes this rank's rows of the mosaic from it.

On a 2-D mesh (`parallel/mesh.py::make_mesh_2d`, `--spatial N`) the
images and dense targets a step takes are this rank's block of rows of
its data shard's batch (the block plan of the P5 grid `p5_grid(cfg)`,
equal or not: the steps run inside `data_parallel(mesh, p5_grid(cfg))`) (compact labels stay whole: each rank builds the
whole images' dense maps and keeps its rows), the model and the losses
run on the blocks (`models/blocks.py`, `ops/`), and the gradients are
summed over the world. With the device mosaic, which composes quadrants
from downscaled whole images, the step takes its data shard's whole
images instead (`takes_whole_images` on the step) and cuts its rows after
the mosaic and the label-level augmentation, as it cuts the dense maps.
The ranks of a space group take the same draws
(by data index), so an image is augmented alike in all its blocks. The
anchor-free loss is held whole by each rank of a space group
(`models/anchor_free.py`), so its metrics are reported at 1 / N a rank.
`make_eval_step(mesh=)` runs on one data shard's batch with collectives
in its space group alone.

On a 2-D `data x model` mesh (`parallel/mesh.py::make_mesh_dm`,
`--model-parallel N`) the model is cut to this rank's channel slices
(`create_train_state(mesh=)`, `parallel/tensor.py`), the ranks of a model
group take the same images and draws, and each computes the same loss of
its data shard. The gradients are summed over the data group alone; the
clip's global norm sums the squares of the sharded leaves over the model
group and counts the replicated ones once, after the ranks of a model
group have taken model index 0's replicated gradients and BatchNorm
statistics (`sync_replicated_`); Adam updates the slices, so its moments
are slices too. `optax_state_dict` and `load_optax_state`
keep the canonical layout: the moments are gathered to write and sliced
to read. The eval step needs no mesh of its own: the cut model gathers
its outputs by itself.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
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
from yolo_from_scratch_tpu_torch.parallel.mesh import (
    all_reduce_grads_,
    data_parallel,
    gather_batch,
    space_rows,
)
from yolo_from_scratch_tpu_torch.parallel.tensor import (
    gather_state_tp,
    local_state,
    model_mesh,
    shard_model_,
    sync_replicated_,
)
from yolo_from_scratch_tpu_torch.train.ema import ema_update
from yolo_from_scratch_tpu_torch.train.metrics import (
    grid_metric_counts,
    grid_metric_counts_anchor_free,
)
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    to_flax_variables,
)

GRAD_CLIP_NORM = 10.0
METRIC_KEYS = ("loss", "bbox", "obj", "cls")
# the mosaic's stream is apart from the flip/jitter one (train/steps.py:299)
MOSAIC_SALT = 0x6D6F7361
# the anchor-free loss's keywords that `af_hp` may set (train/steps.py:80)
AF_HP_KEYS = ("box_weight", "cls_weight", "dfl_weight", "topk", "alpha",
              "beta")


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
    Adam state yet gets zero moments. A model cut for a model mesh has
    its moments gathered (collective over the model group)."""
    moments = {"exp_avg": {}, "exp_avg_sq": {}}
    steps = set()
    for name, p in state.model.named_parameters():
        adam = state.optimizer.state.get(p, {})
        if adam:
            steps.add(int(adam["step"]))
        for key, tree in moments.items():
            tree[name] = adam[key] if adam else torch.zeros_like(p)
    mesh = model_mesh(state.model)
    if mesh is not None:
        moments = {key: gather_state_tp(mesh, tree, state.model.tp_keys)
                   for key, tree in moments.items()}
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


def set_learning_rate(state: TrainState, lr) -> TrainState:
    """Set the learning rate of every parameter group: per epoch a float,
    per step (`step_lr`) a 0-d float32 tensor. A capturable optimizer's
    learning rate is a device tensor, written in place: a captured graph
    reads the tensor it was captured with."""
    for group in state.optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            if torch.is_tensor(lr):
                group["lr"].copy_(lr)
            else:
                group["lr"].fill_(lr)
        else:
            group["lr"] = float(lr)
    return state


def load_optax_state(state: TrainState, opt_state: dict) -> TrainState:
    """The inverse of `optax_state_dict`: read the JAX package's optax
    layout (adam, or the adamw chain when the optimizer is AdamW) into the
    optimizer, its moments, counts and learning rate. Existing state
    tensors are written in place, so a CUDA graph captured on them goes on
    reading the restored values; missing ones are created as torch creates
    them (a capturable optimizer's step on the parameters' device).
    `state.step` is the caller's (the checkpoint's `extra['step']`). A
    model cut for a model mesh takes its rows of the moments."""
    inner = opt_state["inner_state"]["1"]
    adamw = isinstance(state.optimizer, torch.optim.AdamW)
    if ("2" in inner) != adamw:
        raise ValueError(
            f"the checkpoint holds the {'adamw' if '2' in inner else 'adam'}"
            f" chain, the optimizer is {type(state.optimizer).__name__} "
            f"(pass the --weight-decay the checkpoint was trained with)")
    adam = inner["0"]
    count = float(np.asarray(adam["count"]))
    model = state.model
    full = YOLO(model.cfg, device="meta") if model_mesh(model) else model
    moments = {key: local_state(model, from_flax_variables(
        {"params": adam[leaf]}, full, collections=("params",)))
               for key, leaf in (("exp_avg", "mu"), ("exp_avg_sq", "nu"))}
    capturable = all(g.get("capturable") for g in
                     state.optimizer.param_groups)
    with torch.no_grad():
        for name, p in model.named_parameters():
            slot = state.optimizer.state[p]
            if not slot:
                slot["step"] = (torch.zeros((), dtype=torch.float32,
                                            device=p.device) if capturable
                                else torch.tensor(0.0))
                slot["exp_avg"] = torch.zeros_like(p)
                slot["exp_avg_sq"] = torch.zeros_like(p)
            slot["step"].fill_(count)
            for key, tree in moments.items():
                slot[key].copy_(tree[name])
    lr = opt_state["hyperparams"]["learning_rate"]
    return set_learning_rate(state, float(np.asarray(lr)))


def create_train_state(cfg: YoloConfig, learning_rate=1e-2, *, seed=0,
                       device, weight_decay: float = 0.0,
                       mesh=None) -> TrainState:
    """A fresh model from `YOLO.reset_parameters` with a generator seeded
    by `seed`, on `device`, with its Adam (AdamW when `weight_decay`),
    capturable on a CUDA device. On a model mesh (`mesh.n_model` > 1) the
    model is cut to this rank's slices before it goes to the device
    (`parallel/tensor.py::shard_model_`), and Adam holds the slices."""
    model = YOLO(cfg).reset_parameters(torch.Generator().manual_seed(seed))
    shard_model_(model, mesh)
    model.to(device)
    return TrainState(model, make_optimizer(
        model.parameters(), learning_rate, weight_decay,
        capturable=torch.device(device).type == "cuda"))


def clip_by_global_norm_(grads, max_norm=GRAD_CLIP_NORM, sharded=None,
                         group=None):
    """optax's `clip_by_global_norm`, in place: g stays when the global
    norm is below `max_norm`, else becomes g / norm * max_norm. Returns the
    norm (a device tensor). `sharded` (one bool a gradient) and `group`:
    the gradients of a model cut for a model mesh, whose sharded ones are
    slices; the squares of those are summed over `group` and the
    replicated ones counted once, so every rank clips by the norm of the
    whole gradient."""
    norms = torch.stack(torch._foreach_norm(grads))
    if group is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        mask = torch.tensor(sharded, device=norms.device)
        squares = norms.square()
        part = squares[mask].sum().reshape(1)
        dist.all_reduce(part, group=group)
        norm = torch.sqrt(part[0] + squares[~mask].sum())
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


def clip_kwargs(model) -> dict:
    """`clip_by_global_norm_`'s keywords for `model`'s gradients (in
    `parameters()` order): none for a whole model."""
    mesh = model_mesh(model)
    if mesh is None or mesh.model_group is None:
        return {}
    return {"sharded": [name in model.tp_keys
                        for name, _ in model.named_parameters()],
            "group": mesh.model_group}


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


def _af_kwargs(af_hp):
    """`af_hp` as the anchor-free loss's keywords; an unknown key raises
    (the JAX package would fail at its first trace)."""
    af_kw = dict(af_hp or {})
    unknown = sorted(set(af_kw) - set(AF_HP_KEYS))
    if unknown:
        raise ValueError(f"af_hp: unknown keys {unknown} (known: "
                         f"{', '.join(AF_HP_KEYS)})")
    return af_kw


def make_loss_fn(cfg: YoloConfig, quirk_640: bool = False, device=None, *,
                 af_compact: bool = False, sparse: bool = False,
                 af_hp: dict | None = None):
    """loss_fn(model, images, targets) -> (total, (bbox, obj, cls)), the
    model in train mode (its running statistics move).

    `af_compact`: the anchor-free head with targets the GT tuple of
    `_af_gt`. `sparse`: the anchor head with targets (labels, valid) and
    the gather-based loss. `af_hp`: the anchor-free loss's keywords
    (AF_HP_KEYS); the anchor head ignores them, as in the JAX package."""
    af_kw = _af_kwargs(af_hp)
    if cfg.head_type == "anchor_free":

        def loss_fn_af(model, images, targets):
            preds = model(_normalize(images), train=True)
            if af_compact:
                total, bbox, cls = yolo_loss_anchor_free_from_gt(
                    preds, *targets, cfg.num_classes, cfg.img_size, **af_kw)
            else:
                total, bbox, cls = yolo_loss_anchor_free(
                    preds, targets, cfg.num_classes, cfg.img_size, **af_kw)
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
    (`jitter` False: the flip alone) from `step_generator(seed, step)`.
    `steps`: the step's own index as an int32 tensor too (the per-step
    learning rate and EMA decay read it)."""

    seed: int
    mosaic: bool
    augment: bool
    jitter: bool
    steps: bool = False

    def draw(self, step: int, b: int) -> dict:
        """One step's draws for a batch of b, on the CPU: {"mosaic": (do,
        idx)}, {"augment": (do_flip, gain, bias)} and {"step": (step,)} as
        the spec asks."""
        out = {}
        if self.steps:
            out["step"] = (torch.tensor(step, dtype=torch.int32),)
        if self.mosaic:
            out["mosaic"] = mosaic_draws(
                step_generator(self.seed ^ MOSAIC_SALT, step), b)
        if self.augment:
            out["augment"] = augment_draws(step_generator(self.seed, step), b,
                                           jitter=self.jitter)
        return out


def _upload_draws(draws: dict, device) -> dict:
    return {k: tuple(upload(t, device) for t in v) for k, v in draws.items()}


def _rank_draws(spec: DrawSpec, step: int, b: int, mesh) -> dict:
    """One step's draws for this rank's b images: the draws of the global
    batch of b x n_data images, as one process draws them, and the rows
    [d * b, (d + 1) * b) of this rank's data shard d, the same on every
    rank of a space or model group. The mosaic's partners (its idx (3,
    b)) keep their values in the global batch, which the step gathers."""
    if mesh is None or mesh.n_data == 1:
        return spec.draw(step, b)
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    out = {}
    for key, values in spec.draw(step, b * mesh.n_data).items():
        if key == "step":
            out[key] = values
        elif key == "mosaic":
            do, idx = values
            out[key] = (do[rows], idx[:, rows])
        else:
            out[key] = tuple(t if t is None else t[rows] for t in values)
    return out


def p5_grid(cfg: YoloConfig) -> int:
    """The P5 grid of cfg's images, img_size / 32 rows: the grid whose
    plan sets the row blocks under `--spatial` (`parallel/mesh.py::
    level_blocks`)."""
    return cfg.img_size // STRIDES[-1]


def _report_share(cfg: YoloConfig, mesh) -> float:
    """The part of a step's loss a rank reports: 1 / n_space for the
    anchor-free loss on a 2-D mesh (every rank of a space group holds it
    whole), else 1 (each rank's loss is its own part already)."""
    if cfg.head_type == "anchor_free" and mesh is not None and mesh.spatial:
        return 1.0 / mesh.n_space
    return 1.0


class ChunkDraws:
    """The draws of N consecutive steps [s, s + N) for a batch of B, in
    static device tensors that a CUDA graph reads (row i for its step i).

    `load(s)` draws the N steps on the host with `DrawSpec.draw` (this
    rank's rows of the global batch's draws under a `mesh`), so a chunk's
    draws are bit-equal to those of N single steps, writes them
    into one of two pinned buffers and copies that to the device buffers
    on the current stream, outside any graph; a pinned buffer is written
    again only once its last copy has left it. On the CPU the static
    tensors are the host buffer itself."""

    def __init__(self, spec: DrawSpec, n: int, b: int, device, mesh=None):
        self.spec, self.n, self.b, self.mesh = spec, n, b, mesh
        fields = {}
        if spec.steps:
            fields["step"] = (((n,), torch.int32),)
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
            for key, values in _rank_draws(self.spec, step0 + i, self.b,
                                           self.mesh).items():
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
                 sparse: bool = False, mesh=None):
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
    layout, on the images' device) replaces the step's own draws. On a
    2-D `mesh` the images are a row block and the anchor head's dense
    maps, built whole from the whole labels, are cut to the same rows;
    with the mosaic the images are whole and cut after it. Under a `mesh`
    whose data shards differ, the mosaic draws its partners from the
    global batch (`gather_batch`, uint8 images). Under `cfg.packed_stem`
    the images are the packed batch: the mosaic composes in pixel space
    and packs again, the flip reverses the column phases too."""
    if mosaic and not compact_targets:
        raise ValueError("device mosaic requires compact targets (it "
                         "transforms raw labels, not dense maps)")
    af = cfg.head_type == "anchor_free"
    sparse = sparse and not af
    anchors = torch.as_tensor(cfg.anchors_array, device=device)
    label_augment = bool(device_augment) and (af or sparse)
    spec = DrawSpec(seed, mosaic, label_augment, device_augment != "flip")
    gather = (mosaic and mesh is not None
              and mesh.data_view().group is not None)
    whole = mosaic and mesh is not None and mesh.spatial
    grid = p5_grid(cfg)

    def expand(step, images, targets, draws=None):
        if not compact_targets:
            return _normalize(images), targets
        labels, counts = targets
        source = gather_batch(mesh, images, labels, counts) if gather else None
        images = _normalize(images)
        if draws is None:
            draws = _upload_draws(_rank_draws(spec, step, labels.shape[0],
                                              mesh), labels.device)
        if mosaic:
            if source is not None:
                source = (_normalize(source[0]), *source[1:])
            images, labels, valid = mosaic_compact_batch(
                images, labels, counts, 2.0 / cfg.img_size, *draws["mosaic"],
                source=source, packed=cfg.packed_stem)
        else:
            valid = prefix_valid(counts, labels.shape[1])
        if label_augment:
            images, labels = augment_compact_batch(
                images, labels, valid, *draws["augment"],
                packed=cfg.packed_stem)
        if whole:
            images = space_rows(mesh, images, grid).contiguous()
        if sparse:
            return images, (labels, valid)
        if af:
            return images, _af_gt(labels, valid, cfg.num_classes)
        return images, [space_rows(mesh, t, grid) if mesh is not None else t
                        for t in assign_targets_device_masked_batch(
                            labels, valid, anchors, cfg.img_size,
                            cfg.num_classes)]

    return expand


def _make_step_body(cfg: YoloConfig, quirk_640: bool, device, *,
                    device_augment, augment_seed: int, compact_targets: bool,
                    device_mosaic: bool, sparse_loss: bool, af_hp=None,
                    step_lr=None, ema_decay=None, mesh=None):
    """(spec, body): body(state, images, targets, draws, ema=None) ->
    (total, bbox, obj, cls) runs one optimizer update with `draws`
    (`spec.draw`'s layout, on the images' device) and leaves `state.step`
    to its caller. With `step_lr` the update first takes the learning rate
    of the draws' step; with `ema_decay` the EMA model `ema` is updated
    after it, at the step the update has advanced to. With `mesh` the loss
    is this rank's part of the global batch's, and the gradients are
    summed over the ranks before the clip."""
    af_compact = compact_targets and cfg.head_type == "anchor_free"
    sparse_loss = sparse_loss and compact_targets and not af_compact
    loss_fn = make_loss_fn(cfg, quirk_640, device, af_compact=af_compact,
                           sparse=sparse_loss, af_hp=af_hp)
    if step_lr is not None and not callable(step_lr):
        raise TypeError("step_lr must be a function of the step "
                        "(train/schedule.py::make_step_lr)")
    if ema_decay is not None and not 0.0 < ema_decay <= 1.0:
        raise ValueError(f"ema_decay must lie in (0, 1], got {ema_decay}")
    # the anchor-free compact and sparse paths augment at label level in
    # expand; the dense-level hook would not take their targets
    aug = (make_device_augment(cfg, augment_seed,
                               jitter=device_augment != "flip")
           if device_augment and not (af_compact or sparse_loss) else None)
    expand = _make_expand(cfg, compact_targets, device, mosaic=device_mosaic,
                          seed=augment_seed, device_augment=device_augment,
                          sparse=sparse_loss, mesh=mesh)
    share = _report_share(cfg, mesh)
    spec = DrawSpec(augment_seed, bool(device_mosaic), bool(device_augment),
                    device_augment != "flip",
                    steps=step_lr is not None or ema_decay is not None)

    def body(state, images, targets, draws, ema=None):
        if step_lr is not None:
            set_learning_rate(state, step_lr(draws["step"][0]))
        images, targets = expand(state.step, images, targets, draws)
        if aug is not None:
            images, targets = aug(state.step, images, targets,
                                  draws["augment"])
        state.optimizer.zero_grad(set_to_none=True)
        with data_parallel(mesh, p5_grid(cfg)):
            total, (bbox, obj, cls) = loss_fn(state.model, images, targets)
            total.backward()
        grads = [p.grad for p in state.model.parameters()]
        all_reduce_grads_(grads, mesh)
        sync_replicated_(state.model, grads)
        clip_by_global_norm_(grads, **clip_kwargs(state.model))
        state.optimizer.step()
        if ema_decay is not None:
            ema_update(ema, state.model, draws["step"][0] + 1, ema_decay)
        return tuple(t.detach() * share if share != 1.0 else t.detach()
                     for t in (total, bbox, obj, cls))

    return spec, body


def make_train_step(cfg: YoloConfig, quirk_640: bool = False, device=None, *,
                    device_augment=False, augment_seed: int = 0,
                    compact_targets: bool = False, device_mosaic: bool = False,
                    sparse_loss: bool = False, af_hp: dict | None = None,
                    mesh=None):
    """train_step(state, images, targets) -> (state, metrics): images
    (B, S, S, 3) float32 in [0, 1] or uint8, targets [P3, P4, P5] dense, or
    with `compact_targets` (labels (B, K, 5), counts (B,)), all on
    `device`; metrics are 0-dim device tensors under METRIC_KEYS. With
    `mesh` the batch is this rank's part of the global batch (equal on
    every rank), and the metrics are its parts of the global batch's (the
    sum over the ranks is the global loss).

    `device_augment` (False, True / 'full', 'flip'): random hflip and
    photometric jitter on the device; `device_mosaic` (compact only): the
    4-image mosaic; `sparse_loss` (compact, anchor head): the gather-based
    loss, no dense maps. Draws are keyed by `augment_seed` and
    `state.step`. `af_hp`: the anchor-free loss's keywords (AF_HP_KEYS).

    On a 2-D `data x space` mesh with the device mosaic the images are the
    data shard's whole images, whose rows the step cuts after the mosaic;
    the step's `takes_whole_images` says so to the input queue."""
    spec, body = _make_step_body(
        cfg, quirk_640, device, device_augment=device_augment,
        augment_seed=augment_seed, compact_targets=compact_targets,
        device_mosaic=device_mosaic, sparse_loss=sparse_loss, af_hp=af_hp,
        mesh=mesh)

    def train_step(state: TrainState, images, targets):
        draws = _upload_draws(_rank_draws(spec, state.step, images.shape[0],
                                          mesh), images.device)
        metrics = body(state, images, targets, draws)
        state.step += 1
        return state, dict(zip(METRIC_KEYS, metrics))

    train_step.takes_whole_images = bool(
        device_mosaic and compact_targets and mesh is not None
        and mesh.spatial)
    return train_step


def chunk_path(device, mesh=None) -> str:
    """How a scanned trainer runs its chunks on `device` under `mesh`, as
    the training banner names it: 'CUDA graph' or 'CUDA graph (nccl)' on
    a card, 'eager (CPU)', or 'eager (gloo cannot be captured)' where the
    mesh's collectives run on a backend other than NCCL, whose
    collectives a graph cannot hold."""
    if torch.device(device).type != "cuda":
        return "eager (CPU)"
    if mesh is None or mesh.group is None:
        return "CUDA graph"
    backend = dist.get_backend(mesh.group)
    if backend == "nccl":
        return "CUDA graph (nccl)"
    return f"eager ({backend} cannot be captured)"


class _ChunkTrainer:
    """N optimizer steps of `body` a call (the port's `lax.scan` over a
    chunk): eagerly on the CPU, the plain version; on the card as one CUDA
    graph, captured at the first call for a state and input layout and
    replayed at every later one. Under a `mesh` the steps' collectives
    (the gradient all-reduce, BatchNorm's statistics, the mosaic's
    gather) are in the graph with NCCL, every rank warming up and
    capturing in the same order; with `gloo`, whose collectives cannot be
    captured, the same steps run eagerly on the card (`chunk_path`). A
    capture that fails raises.

    train_steps(state, *resident, *chunk) -> (state, metrics): `chunk`
    tensors have N leading (and B next) and are copied into the graph's
    static inputs each call; `resident` tensors (the sample pool) are
    read where they lie and must be the same tensors at every replay.
    `select(resident, chunk, i)` gives step i's (images, targets). The
    metrics are the means over the N steps of each step's METRIC_KEYS, as
    `jax.tree.map(jnp.mean, metrics)` gives them; `state.step` advances
    by N. With `ema` the first argument and the result's first element
    are (state, ema_model), and the graph updates the EMA model in place.

    A graph is replayed only while the training state's tensors are the
    ones it captured (their addresses are compared at every call): a
    state whose tensors were replaced since (an optimizer's
    `load_state_dict`) is captured anew, never read through freed
    memory."""

    def __init__(self, spec, body, select, n_resident=0, ema=False,
                 mesh=None):
        self.spec, self.body, self.select = spec, body, select
        self.n_resident = n_resident
        self.ema = ema
        self.mesh = mesh
        self._graph = None

    def _steps(self, state, ema, resident, chunk, draws, metrics, count):
        for i in range(count):
            images, targets = self.select(resident, chunk, i)
            metrics[i] = torch.stack(self.body(state, images, targets,
                                               draws.step(i), ema))

    def __call__(self, carry, *args):
        state, ema = carry if self.ema else (carry, None)
        resident, chunk = args[:self.n_resident], args[self.n_resident:]
        n, b = chunk[0].shape[:2]
        device = chunk[0].device
        if chunk_path(device, self.mesh).startswith("eager"):
            draws = ChunkDraws(self.spec, n, b, device, self.mesh)
            draws.load(state.step)
            metrics = torch.empty((n, len(METRIC_KEYS)), device=device)
            self._steps(state, ema, resident, chunk, draws, metrics, n)
        else:
            metrics = self._replay(state, ema, resident, chunk, n, b)
        state.step += n
        metrics = dict(zip(METRIC_KEYS, metrics.mean(0).unbind()))
        return ((state, ema) if self.ema else state), metrics

    def _replay(self, state, ema, resident, chunk, n, b):
        from yolo_from_scratch_tpu_torch.train import graphs

        others = (ema,) if ema is not None else ()
        # the graph holds its model, optimizer and EMA, so their ids stay
        # unique
        key = (id(state.model), id(state.optimizer), id(ema),
               tuple((t.shape, t.dtype, t.device) for t in chunk),
               tuple((t.data_ptr(), t.shape, t.dtype) for t in resident))
        addresses = graphs.addresses(state.model, state.optimizer, *others)
        if (self._graph is None or self._graph[0] != key
                or self._graph[1] != addresses):
            self._graph = None  # the old graph's memory goes first
            captured = self._capture(state, ema, resident, chunk, n, b)
            self._graph = (key, graphs.addresses(state.model,
                                                 state.optimizer, *others),
                           state.model, state.optimizer, ema, *captured)
        graph, inputs, draws, metrics = self._graph[5:]
        for dst, src in zip(inputs, chunk):
            dst.copy_(src, non_blocking=True)
        draws.load(state.step)
        graph.replay()
        return metrics

    def _capture(self, state, ema, resident, chunk, n, b):
        from yolo_from_scratch_tpu_torch.train import graphs

        device = chunk[0].device
        inputs = [torch.empty_like(t) for t in chunk]
        for dst, src in zip(inputs, chunk):
            dst.copy_(src)
        draws = ChunkDraws(self.spec, n, b, device, self.mesh)
        draws.load(state.step)
        metrics = torch.zeros((n, len(METRIC_KEYS)), device=device)
        graph = graphs.capture(
            lambda: self._steps(state, ema, resident, inputs, draws,
                                metrics, n),
            lambda: self._steps(state, ema, resident, inputs, draws,
                                metrics, 1),
            state.model, state.optimizer,
            *((ema,) if ema is not None else ()))
        return graph, inputs, draws, metrics


def make_train_step_multi(cfg: YoloConfig, quirk_640: bool = False,
                          device=None, *, device_augment=False,
                          augment_seed: int = 0, af_hp: dict | None = None):
    """Scanned multi-step trainer on dense targets:
    train_steps(state, images (N, B, S, S, 3) float32 or uint8, t3, t4, t5
    (N, B, g, g, A, 5+nc)) -> (state, metrics averaged over the N steps).
    `device_augment`: the dense-level flip / jitter hook, its draws keyed
    by each step's index (the JAX package's `make_train_step_multi`).
    `af_hp`: the anchor-free loss's keywords (AF_HP_KEYS)."""
    spec, body = _make_step_body(
        cfg, quirk_640, device, device_augment=device_augment,
        augment_seed=augment_seed, compact_targets=False,
        device_mosaic=False, sparse_loss=False, af_hp=af_hp)
    return _ChunkTrainer(spec, body, lambda _, c, i: (
        c[0][i], [c[1][i], c[2][i], c[3][i]]))


def make_train_step_multi_compact(cfg: YoloConfig, quirk_640: bool = False,
                                  device=None, *, device_augment=False,
                                  augment_seed: int = 0,
                                  device_mosaic: bool = False,
                                  sparse_loss: bool = False, af_hp=None,
                                  step_lr=None, ema_decay=None, mesh=None):
    """Scanned multi-step trainer fed by compact labels, both heads:
    train_steps(state, images (N, B, S, S, 3) uint8 or float32, labels
    (N, B, K, 5), counts (N, B)) -> (state, metrics averaged over the N
    steps); the targets are built on the device in each step, as in
    `make_train_step(compact_targets=True)`.

    The recipe knobs (the JAX function's): `af_hp` the anchor-free loss's
    keywords (AF_HP_KEYS); `step_lr` a function of the step tensor giving
    that step's learning rate (`train/schedule.py::make_step_lr`), written
    into the optimizer before the step's update and left there after the
    chunk; `ema_decay` an EMA of the weights and BatchNorm statistics at
    that decay (tau 2000, `train/ema.py`), updated after every step at the
    step it advanced to. With `ema_decay` the trainer is ((state,
    ema_model), images, labels, counts) -> ((state, ema_model), metrics),
    `ema_model` from `train/ema.py::ema_init`, updated in place. Each
    step's index comes from the chunk's static device row (`ChunkDraws`),
    so a graph replays each step's own learning rate and decay.

    With a 1-D `mesh` (`--stream --distributed`) each step is the
    data-parallel step of `make_train_step(mesh=)` on this rank's columns
    of the chunk (`ChunkStream(process_shard=)`), its collectives inside
    the chunk's graph with NCCL, eager with `gloo` (`chunk_path`)."""
    spec, body = _make_step_body(
        cfg, quirk_640, device, device_augment=device_augment,
        augment_seed=augment_seed, compact_targets=True,
        device_mosaic=device_mosaic, sparse_loss=sparse_loss, af_hp=af_hp,
        step_lr=step_lr, ema_decay=ema_decay, mesh=mesh)
    return _ChunkTrainer(spec, body, lambda _, c, i: (
        c[0][i], (c[1][i], c[2][i])), ema=ema_decay is not None, mesh=mesh)


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
    place between calls. `af_hp`: the anchor-free loss's keywords
    (AF_HP_KEYS)."""
    spec, body = _make_step_body(
        cfg, quirk_640, device, device_augment=device_augment,
        augment_seed=augment_seed, compact_targets=True,
        device_mosaic=device_mosaic, sparse_loss=sparse_loss, af_hp=af_hp)
    return _ChunkTrainer(spec, body, _pool_batch, n_resident=3)


def make_train_step_accum(cfg: YoloConfig, n_accum: int,
                          quirk_640: bool = False, device=None, *,
                          device_augment=False, augment_seed: int = 0,
                          mesh=None):
    """Gradient accumulation on dense targets (the JAX package's
    `make_train_step_accum`): train_step(state, images (n_accum, B, S, S,
    3), t3, t4, t5 (n_accum, B, ...)) -> (state, metrics averaged over the
    micro-batches). One clip + Adam update from the mean of the n_accum
    micro-batch gradients (summed in micro-batch order, then divided by
    n_accum), the BatchNorm statistics carried from micro-batch to
    micro-batch, `state.step` advancing by one. Only one micro-batch's
    activations are alive at a time. `device_augment`: the dense-level
    hook, its draws keyed by step * n_accum + micro. With `mesh` each
    micro-batch is this rank's part of a global one, as in
    `make_train_step`: the mean gradient is summed over the ranks before
    the clip."""
    if n_accum < 1:
        raise ValueError(f"n_accum must be >= 1, got {n_accum}")
    loss_fn = make_loss_fn(cfg, quirk_640, device)
    share = _report_share(cfg, mesh)
    aug = (make_device_augment(cfg, augment_seed,
                               jitter=device_augment != "flip")
           if device_augment else None)
    spec = DrawSpec(augment_seed, False, bool(device_augment),
                    device_augment != "flip")

    def train_step(state: TrainState, images, t3, t4, t5):
        state.optimizer.zero_grad(set_to_none=True)
        per = []
        for micro in range(n_accum):
            imgs = _normalize(images[micro])
            targets = [t3[micro], t4[micro], t5[micro]]
            if aug is not None:
                key = state.step * n_accum + micro
                draws = _upload_draws(_rank_draws(spec, key, imgs.shape[0],
                                                  mesh), imgs.device)
                imgs, targets = aug(key, imgs, targets, draws["augment"])
            with data_parallel(mesh, p5_grid(cfg)):
                total, (bbox, obj, cls) = loss_fn(state.model, imgs, targets)
                total.backward()  # .grad holds the running sum
            per.append(torch.stack([t.detach()
                                    for t in (total, bbox, obj, cls)]))
        grads = [p.grad for p in state.model.parameters()]
        torch._foreach_div_(grads, float(n_accum))
        all_reduce_grads_(grads, mesh)
        sync_replicated_(state.model, grads)
        clip_by_global_norm_(grads, **clip_kwargs(state.model))
        state.optimizer.step()
        state.step += 1
        metrics = torch.stack(per).mean(0) * share
        return state, dict(zip(METRIC_KEYS, metrics.unbind()))

    return train_step


def make_eval_step(cfg: YoloConfig, conf_threshold=0.5, iou_threshold=0.5,
                   quirk_640: bool = False, device=None,
                   compact_targets: bool = False, mesh=None):
    """eval_step(model, images, targets) -> (loss, tp, fp, fn): the eval-mode
    loss and per-image (B,) int32 counts summed over the scales, all on the
    device. With `compact_targets` the batch is uint8 images and (labels,
    counts): the anchor head's maps are built on the device; the
    anchor-free head's loss reads the GT set and its grid metric the maps
    of `assign_targets_anchor_free_device_batch`.

    With a 2-D `mesh` the batch is this rank's row block of its data
    shard's batch (the shards' batches differ, so the step's collectives
    stay in the space group, `Mesh.space_view`): the counts are the
    block's cells', and the loss is this rank's part of the batch's, the
    parts summing to it over the space group."""
    sub = mesh.space_view() if mesh is not None and mesh.spatial else None
    share = _report_share(cfg, sub)
    if cfg.head_type == "anchor_free":

        @torch.no_grad()
        def eval_step_af(model, images, targets):
            with data_parallel(sub, p5_grid(cfg)):
                preds = model(_normalize(images), train=False)
                if compact_targets:
                    labels, counts = targets
                    valid = prefix_valid(counts, labels.shape[1])
                    loss, _, _ = yolo_loss_anchor_free_from_gt(
                        preds, *_af_gt(labels, valid, cfg.num_classes),
                        cfg.num_classes, cfg.img_size)
                    maps = assign_targets_anchor_free_device_batch(
                        labels, counts, cfg.img_size, cfg.num_classes)
                    targets = [space_rows(sub, t, p5_grid(cfg))
                               if sub is not None else t for t in maps]
                else:
                    loss, _, _ = yolo_loss_anchor_free(
                        preds, targets, cfg.num_classes, cfg.img_size)
                tp = fp = fn = 0
                for pred, tgt, stride in zip(preds, targets, STRIDES):
                    t, f, n = grid_metric_counts_anchor_free(
                        pred, tgt, stride, cfg.img_size, conf_threshold,
                        iou_threshold, per_image=True)
                    tp, fp, fn = tp + t, fp + f, fn + n
            return loss * share, tp, fp, fn

        return eval_step_af

    anchors = torch.as_tensor(cfg.anchors_array, device=device)
    expand = _make_expand(cfg, compact_targets, device, mesh=sub)

    @torch.no_grad()
    def eval_step(model, images, targets):
        images, targets = expand(0, images, targets)
        with data_parallel(sub, p5_grid(cfg)):
            preds = model(images, train=False)
            loss, _, _, _ = yolo_loss_multiscale(
                preds, targets, anchors, cfg.num_classes, cfg.img_size,
                quirk_640)
            tp = fp = fn = 0
            for pred, tgt, anc in zip(preds, targets, anchors):
                t, f, n = grid_metric_counts(pred, tgt, anc, cfg.img_size,
                                             conf_threshold, iou_threshold,
                                             quirk_640, per_image=True)
                tp, fp, fn = tp + t, fp + f, fn + n
        return loss, tp, fp, fn

    return eval_step
