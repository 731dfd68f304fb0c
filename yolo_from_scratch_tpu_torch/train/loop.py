"""Epoch-level orchestration: train loop, eval loop, checkpointing
(counterpart of `yolo_from_scratch_tpu/train/loop.py`, one device).

Per-epoch LR, eval and a checkpoint every epoch, the JAX package's stdout
line and JSONL record, with the detection-level P/R/F1 of `det_eval` when
given. Batches stream through the double-buffered `DeviceQueue`; per-batch
metrics stay on the device until the end of the epoch (one host sync),
never a per-batch `.item()`. With a `stream` (`data/stream.py`, `--stream`)
an epoch is the stream's `run_epoch` through a scanned trainer instead,
and a pool stream's fresh-ingest rate joins the epoch line and record.

`start_epoch` resumes mid-schedule (`restore_train_state` reads the
checkpoint back, `--resume`); `use_ema` keeps an EMA of the weights and
BatchNorm statistics (`train/ema.py`, `--ema`), with which evaluation and
`det_eval` run and which the checkpoint's `model` holds, the raw weights
and the step riding in `extra` as the JAX package writes them;
`multi_scale` rotates (train_step, loader) buckets per epoch
(`--multi-scale`).

With a `mesh` of several processes (`parallel/`, `--distributed`) every
rank starts from rank 0's weights (a broadcast), trains on its shard of
each global batch and prints the global loss (the ranks' per-step losses
summed, one all-reduce an epoch) and the global P/R/F1 (each rank
evaluates its own unpadded slice of the val split,
`parallel/distributed.py::global_eval_reduce`); only rank 0 appends to
the JSONL and writes checkpoints, as the JAX loop does. On a 2-D mesh
(`--spatial`) the loaders are sharded by data index, each rank takes its
block of rows of every batch (`DeviceQueue`), and the ranks of a space
group evaluate their data shard's slice together. On a `data x model`
mesh (`--model-parallel`) the model, its Adam state and the EMA are this
rank's channel slices: the start-up broadcast runs over the data group
(the ranks that hold the same slices), the ranks of a model group load
and evaluate the same images and count them once, and every rank joins
the gather of the weights and moments before rank 0 writes the
checkpoint in the canonical layout, which either package reads.
"""

from __future__ import annotations

import time
from datetime import datetime

import numpy as np
import torch

from yolo_from_scratch_tpu_torch.data.device_queue import DeviceQueue
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.parallel.distributed import (
    global_eval_reduce,
)
from yolo_from_scratch_tpu_torch.parallel.mesh import all_reduce
from yolo_from_scratch_tpu_torch.parallel.tensor import (
    full_state_dict,
    load_full_state_dict_,
    model_mesh,
)
from yolo_from_scratch_tpu_torch.train.ema import (
    ema_init,
    wrap_train_step_with_ema,
)
from yolo_from_scratch_tpu_torch.train.metrics import prf1
from yolo_from_scratch_tpu_torch.train.schedule import lr_at_epoch
from yolo_from_scratch_tpu_torch.train.steps import (
    METRIC_KEYS,
    create_train_state,
    load_optax_state,
    optax_state_dict,
    set_learning_rate,
)
from yolo_from_scratch_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    to_flax_variables,
)
from yolo_from_scratch_tpu_torch.utils.metrics_log import MetricsLogger


def train_epoch(train_step, state, loader, device, mesh=None):
    """One epoch. Returns (state, mean_total, mean_bbox, mean_obj, mean_cls,
    images_seen, seconds). With a `mesh` each step's metrics are this
    rank's parts of the global batch's, summed over the ranks here (the
    images seen stay this rank's). On a model mesh the ranks of a model
    group report the same parts, which are summed over the data group
    alone."""
    per_step = []
    n_images = 0
    t0 = time.perf_counter()
    for images, targets, valid in DeviceQueue(loader, device, mesh):
        n_images += valid
        state, metrics = train_step(state, images, targets)
        per_step.append(torch.stack([metrics[k] for k in METRIC_KEYS]))
    # single host sync at epoch end
    rows = None
    if per_step:
        rows = torch.stack(per_step)
        if mesh is not None and mesh.reduce_view().group is not None:
            all_reduce(rows, mesh.reduce_view())
        rows = rows.cpu().numpy()
    dt = time.perf_counter() - t0
    n = max(len(per_step), 1)
    # float32 running sums, as the JAX loop adds its float32 scalars
    means = [float(sum(rows[:, i])) / n if rows is not None else 0.0
             for i in range(len(METRIC_KEYS))]
    return (state, *means, n_images, dt)


def eval_epoch(eval_step, model, loader, device, mesh=None):
    """Loss + grid-aligned P/R/F1 over a loader. Returns (loss, P%, R%,
    F1%). With a `mesh` of several processes each rank counts its own
    shard of the split (the loader's) and the five sums are reduced over
    the ranks, so every rank returns the global values. On a 2-D mesh a
    rank counts its rows of its data shard's images (an `eval_step` made
    with the mesh), its losses are its parts of the batches' losses, and
    the batches are counted once a space group. On a model mesh the ranks
    of a model group evaluate the same images alike, and only model index
    0 counts them."""
    per_batch = [(*eval_step(model, images, targets), valid)
                 for images, targets, valid in DeviceQueue(loader, device,
                                                           mesh)]
    losses, tps, fps, fns = [], 0, 0, 0
    for loss, tp, fp, fn, valid in per_batch:
        losses.append(float(loss))
        # per-image count vectors: sum only the valid (non-padded) rows
        tps += int(tp[:valid].sum())
        fps += int(fp[:valid].sum())
        fns += int(fn[:valid].sum())
    if mesh is not None and mesh.size > 1:
        if mesh.model_index:
            losses, tps, fps, fns = [], 0, 0, 0
        n_batches = len(losses) if mesh.space_index == 0 else 0
        tps, fps, fns, loss_sum, n_batches = global_eval_reduce(
            tps, fps, fns, float(np.sum(losses)), n_batches)
        avg_loss = loss_sum / n_batches if n_batches else 0.0
    else:
        avg_loss = float(np.mean(losses)) if losses else 0.0
    return (avg_loss, *prf1(tps, fps, fns))


def fit(state, train_step, eval_step, train_loader, val_loader, cfg, *,
        device, epochs=100, initial_lr=1e-2, min_lr=1e-4, warmup_epochs=3,
        save_path=None, log=print, metrics_path=None, det_eval=None,
        stream=None, start_epoch=0, use_ema=False, ema_decay=0.9999,
        initial_ema=None, multi_scale=None, mesh=None):
    """Train + eval + checkpoint + LR step per epoch, epochs `start_epoch`
    to `epochs` - 1. Returns (state, save_path); the checkpoint goes to
    `yolo_<timestamp>.ckpt` in the working directory unless `save_path`
    is given.

    `det_eval`: optional callable (model) -> (P%, R%, F1%), the
    detection-level metrics (NMS output vs GT at a fixed confidence) on
    the val split, appended to the epoch line and the JSONL record. It is
    given the evaluated model (the live one, or the EMA) and must not
    change it (serve a copy of its weights: `BatchPredictor.load_weights`).

    `use_ema`: an EMA of the weights and BatchNorm statistics (decay
    `ema_decay`, tau 2000) updated after every step, starting from a copy
    of the state's model, or from the state dict `initial_ema` (a resumed
    average, `restore_train_state`'s). Evaluation and `det_eval` use it;
    the checkpoint's `model` holds it, and `extra` the raw weights
    (`raw_params`, `raw_batch_stats`) beside `step`.

    `multi_scale`: a list of (train_step, train_loader) pairs, one per
    resolution bucket; epoch e trains with pair e % len (the model is
    fully convolutional, so one state serves every bucket). Evaluation and
    the checkpoint stay at cfg.img_size, and the positional `train_step`
    / `train_loader` are then unused for training.

    `stream`: a `ChunkStream` or `PoolStream` whose `run_epoch` trains
    each epoch with `train_step`, a scanned trainer, in place of
    `train_loader` (not with `use_ema` or `multi_scale`: the CLI refuses
    them); it is stopped when fit returns or raises.

    `mesh`: the data-parallel run's (`parallel/mesh.py`), with train
    steps made for it; the state's model is first set to rank 0's (a
    broadcast of every weight and BatchNorm statistic), on a model mesh
    to data shard 0's slices of the same model index (a broadcast over
    the data group)."""
    if mesh is not None and mesh.reduce_view().group is not None:
        with torch.no_grad():
            for t in state.model.state_dict().values():
                # global rank of (data 0, this model index)
                torch.distributed.broadcast(t, mesh.model_index,
                                            group=mesh.reduce_view().group)
    schedule = (list(multi_scale) if multi_scale
                else [(train_step, train_loader)])
    ema = None
    if use_ema:
        ema = ema_init(state.model)
        if initial_ema is not None:
            # --resume: go on with the checkpointed average instead of
            # pinning it to the raw weights again
            load_full_state_dict_(ema, initial_ema)
        schedule = [(wrap_train_step_with_ema(fn, decay=ema_decay), loader)
                    for fn, loader in schedule]
    try:
        return _fit_epochs(state, ema, schedule, eval_step, val_loader, cfg,
                           device, start_epoch, epochs, initial_lr, min_lr,
                           warmup_epochs, save_path, log, metrics_path,
                           det_eval, stream, mesh)
    finally:
        if stream is not None and hasattr(stream, "stop"):
            # a pool stream's persistent refresher must not stage uploads
            # after the last epoch, nor after a training failure
            stream.stop()


def _fit_epochs(state, ema, schedule, eval_step, val_loader, cfg, device,
                start_epoch, epochs, initial_lr, min_lr, warmup_epochs,
                save_path, log, metrics_path, det_eval, stream, mesh):
    """fit()'s epoch loop, apart so that the stream's shutdown wraps it."""
    if save_path is None:
        timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        save_path = f"yolo_{timestamp}.ckpt"
    # only rank 0 appends the (possibly shared) JSONL and writes the
    # (identical) checkpoint: concurrent writers would race
    writer = mesh is None or mesh.rank == 0
    metrics_logger = MetricsLogger(metrics_path if writer else None)
    for epoch in range(start_epoch, epochs):
        lr = lr_at_epoch(epoch, warmup_epochs, epochs, initial_lr, min_lr)
        state = set_learning_rate(state, lr)
        epoch_step, epoch_loader = schedule[epoch % len(schedule)]
        ingest_img_s = None
        if stream is not None:
            state, means, n_imgs, dt = stream.run_epoch(epoch_step, state)
            loss, bbox, obj, cls = (means.get(k, 0.0) for k in METRIC_KEYS)
            ingest_img_s = means.get("ingest_img_s")
        elif ema is not None:
            (state, ema), loss, bbox, obj, cls, n_imgs, dt = train_epoch(
                epoch_step, (state, ema), epoch_loader, device, mesh)
        else:
            state, loss, bbox, obj, cls, n_imgs, dt = train_epoch(
                epoch_step, state, epoch_loader, device, mesh)
        evaluated = ema if ema is not None else state.model
        val_loss, val_p, val_r, val_f1 = eval_epoch(
            eval_step, evaluated, val_loader, device, mesh)
        det = det_eval(evaluated) if det_eval is not None else None
        det_str = (f" | Det: P {det[0]:.1f}%, R {det[1]:.1f}%, "
                   f"F1 {det[2]:.1f}%" if det is not None else "")
        ingest = (f" | ingest {ingest_img_s:.1f} img/s"
                  if ingest_img_s is not None else "")
        log(f"Epoch {epoch + 1}: "
            f"Loss: {loss:.4f} (bbox: {bbox:.4f}, obj: {obj:.4f}, "
            f"cls: {cls:.4f}) | "
            f"Val: Loss {val_loss:.4f}, P {val_p:.1f}%, R {val_r:.1f}%, "
            f"F1 {val_f1:.1f}%{det_str} | LR: {lr:.6f} | "
            f"{n_imgs / max(dt, 1e-9):.1f} img/s{ingest}")
        record = {
            "epoch": epoch + 1, "loss": loss, "bbox": bbox, "obj": obj,
            "cls": cls, "val_loss": val_loss, "val_precision": val_p,
            "val_recall": val_r, "val_f1": val_f1, "lr": lr,
            "images_per_sec": n_imgs / max(dt, 1e-9),
        }
        if det is not None:
            (record["det_precision"], record["det_recall"],
             record["det_f1"]) = det
        if ingest_img_s is not None:
            record["ingest_images_per_sec"] = ingest_img_s
        metrics_logger.log(record)
        # a cut model's ranks all join the gathers; then only rank 0 writes
        if not writer and model_mesh(state.model) is None:
            continue
        # 'model' holds the weights to serve (the EMA when kept); the raw
        # weights and the step ride in extra, and Adam's state in the JAX
        # package's optax layout, so that either package's --resume
        # continues the training itself
        extra = {"step": state.step}
        if ema is not None:
            raw = to_flax_variables(full_state_dict(state.model))
            extra["raw_params"] = raw["params"]
            extra["raw_batch_stats"] = raw["batch_stats"]
        weights = to_flax_variables(full_state_dict(evaluated))
        opt_state = optax_state_dict(state)
        if writer:
            save_checkpoint(save_path, weights, cfg, epoch=epoch,
                            opt_state=opt_state, extra=extra)
    return state, save_path


def restore_train_state(ckpt_path, learning_rate=1e-2, *, device,
                        weight_decay: float = 0.0, compute_dtype=None,
                        mesh=None):
    """Rebuild a train state from a checkpoint of either package for
    `--resume` (the JAX package's `restore_train_state`). Returns (state,
    cfg, start_epoch, ema_state_dict):

    - the weights are the raw ones of `extra` when the checkpoint was
      written with an EMA (`raw_params`, `raw_batch_stats`), else its
      `model`; `ema_state_dict` is then the checkpoint's `model`, the
      average to go on with (`fit(initial_ema=...)`), else None;
    - the optimizer is Adam, or AdamW when `weight_decay` > 0 (capturable
      on a CUDA device, as `create_train_state` makes it), and its state
      is read from the optax layout in place (`load_optax_state`), before
      any graph is captured on it;
    - `state.step` is `extra['step']`, and training starts at the
      checkpoint's epoch + 1.

    cfg is the checkpoint's (it governs the model, the loss and the data),
    with `compute_dtype` when given. On a model mesh the model is cut
    (`create_train_state(mesh=)`) and takes its rows of the checkpoint's
    canonical weights and moments; `ema_state_dict` stays full size."""
    model_sd, cfg, meta = load_checkpoint(ckpt_path)
    if compute_dtype is not None:
        cfg = cfg.with_(compute_dtype=compute_dtype)
    extra = meta.get("extra") or {}
    state = create_train_state(cfg, learning_rate, device=device,
                               weight_decay=weight_decay, mesh=mesh)
    ema_sd = None
    weights = model_sd
    if "raw_params" in extra:
        weights = from_flax_variables(
            {"params": extra["raw_params"],
             "batch_stats": extra["raw_batch_stats"]},
            YOLO(cfg, device="meta"))
        ema_sd = model_sd
    load_full_state_dict_(state.model, weights)
    if meta.get("opt_state") is not None:
        load_optax_state(state, meta["opt_state"])
    state.step = int(extra.get("step", 0))
    return state, cfg, meta["epoch"] + 1, ema_sd
