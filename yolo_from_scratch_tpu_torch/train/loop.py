"""Epoch-level orchestration: train loop, eval loop, checkpointing
(counterpart of `yolo_from_scratch_tpu/train/loop.py`, one device).

Per-epoch LR, eval and a checkpoint every epoch, the JAX package's stdout
line and JSONL record, with the detection-level P/R/F1 of `det_eval` when
given. Batches stream through the double-buffered `DeviceQueue`; per-batch
metrics stay on the device until the end of the epoch (one host sync),
never a per-batch `.item()`. With a `stream` (`data/stream.py`, `--stream`)
an epoch is the stream's `run_epoch` through a scanned trainer instead,
and a pool stream's fresh-ingest rate joins the epoch line and record.

Not ported: EMA, the multi-scale trainer and multi-host.
"""

from __future__ import annotations

import time
from datetime import datetime

import numpy as np
import torch

from yolo_from_scratch_tpu_torch.data.device_queue import DeviceQueue
from yolo_from_scratch_tpu_torch.train.metrics import prf1
from yolo_from_scratch_tpu_torch.train.schedule import lr_at_epoch
from yolo_from_scratch_tpu_torch.train.steps import (
    METRIC_KEYS,
    optax_state_dict,
    set_learning_rate,
)
from yolo_from_scratch_tpu_torch.utils.checkpoint import save_checkpoint
from yolo_from_scratch_tpu_torch.utils.convert import to_flax_variables
from yolo_from_scratch_tpu_torch.utils.metrics_log import MetricsLogger


def train_epoch(train_step, state, loader, device):
    """One epoch. Returns (state, mean_total, mean_bbox, mean_obj, mean_cls,
    images_seen, seconds)."""
    per_step = []
    n_images = 0
    t0 = time.perf_counter()
    for images, targets, valid in DeviceQueue(loader, device):
        n_images += valid
        state, metrics = train_step(state, images, targets)
        per_step.append(torch.stack([metrics[k] for k in METRIC_KEYS]))
    # single host sync at epoch end
    rows = torch.stack(per_step).cpu().numpy() if per_step else None
    dt = time.perf_counter() - t0
    n = max(len(per_step), 1)
    # float32 running sums, as the JAX loop adds its float32 scalars
    means = [float(sum(rows[:, i])) / n if rows is not None else 0.0
             for i in range(len(METRIC_KEYS))]
    return (state, *means, n_images, dt)


def eval_epoch(eval_step, model, loader, device):
    """Loss + grid-aligned P/R/F1 over a loader. Returns (loss, P%, R%,
    F1%)."""
    per_batch = [(*eval_step(model, images, targets), valid)
                 for images, targets, valid in DeviceQueue(loader, device)]
    losses, tps, fps, fns = [], 0, 0, 0
    for loss, tp, fp, fn, valid in per_batch:
        losses.append(float(loss))
        # per-image count vectors: sum only the valid (non-padded) rows
        tps += int(tp[:valid].sum())
        fps += int(fp[:valid].sum())
        fns += int(fn[:valid].sum())
    avg_loss = float(np.mean(losses)) if losses else 0.0
    return (avg_loss, *prf1(tps, fps, fns))


def fit(state, train_step, eval_step, train_loader, val_loader, cfg, *,
        device, epochs=100, initial_lr=1e-2, min_lr=1e-4, warmup_epochs=3,
        save_path=None, log=print, metrics_path=None, det_eval=None,
        stream=None):
    """Train + eval + checkpoint + LR step per epoch. Returns (state,
    save_path); the checkpoint goes to `yolo_<timestamp>.ckpt` in the
    working directory unless `save_path` is given.

    `det_eval`: optional callable (model) -> (P%, R%, F1%), the
    detection-level metrics (NMS output vs GT at a fixed confidence) on
    the val split, appended to the epoch line and the JSONL record. It is
    given the live training model and must not change it (serve a copy of
    its weights: `BatchPredictor.load_weights`).

    `stream`: a `ChunkStream` or `PoolStream` whose `run_epoch` trains
    each epoch with `train_step`, a scanned trainer, in place of
    `train_loader`; it is stopped when fit returns or raises."""
    try:
        return _fit_epochs(state, train_step, eval_step, train_loader,
                           val_loader, cfg, device, epochs, initial_lr,
                           min_lr, warmup_epochs, save_path, log,
                           metrics_path, det_eval, stream)
    finally:
        if stream is not None and hasattr(stream, "stop"):
            # a pool stream's persistent refresher must not stage uploads
            # after the last epoch, nor after a training failure
            stream.stop()


def _fit_epochs(state, train_step, eval_step, train_loader, val_loader, cfg,
                device, epochs, initial_lr, min_lr, warmup_epochs, save_path,
                log, metrics_path, det_eval, stream):
    """fit()'s epoch loop, apart so that the stream's shutdown wraps it."""
    if save_path is None:
        timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        save_path = f"yolo_{timestamp}.ckpt"
    metrics_logger = MetricsLogger(metrics_path)
    for epoch in range(epochs):
        lr = lr_at_epoch(epoch, warmup_epochs, epochs, initial_lr, min_lr)
        state = set_learning_rate(state, lr)
        ingest_img_s = None
        if stream is not None:
            state, means, n_imgs, dt = stream.run_epoch(train_step, state)
            loss, bbox, obj, cls = (means.get(k, 0.0) for k in METRIC_KEYS)
            ingest_img_s = means.get("ingest_img_s")
        else:
            state, loss, bbox, obj, cls, n_imgs, dt = train_epoch(
                train_step, state, train_loader, device)
        val_loss, val_p, val_r, val_f1 = eval_epoch(
            eval_step, state.model, val_loader, device)
        det = det_eval(state.model) if det_eval is not None else None
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
        # Adam's state in the JAX package's optax layout, so that its
        # --resume continues the moments instead of restarting them
        save_checkpoint(save_path, to_flax_variables(state.model.state_dict()),
                        cfg, epoch=epoch, opt_state=optax_state_dict(state),
                        extra={"step": state.step})
    return state, save_path
