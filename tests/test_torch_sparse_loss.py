"""The PyTorch port's sparse (gather-based) loss (`ops/losses_sparse.py`)
against its dense loss on the maps `assign_targets_device_masked_batch`
builds from the same labels, and both against the JAX package's, on the
CPU with seeded numpy predictions and labels (B=3, K=16, 128x128).

Tolerances, and why: the sparse and dense losses compute the same float32
terms, summed in another order (a mean over every cell of BCE(l, 0) less a
gathered sum, against a mean of BCE(l, z)): totals within 1e-5 relative,
components within 1e-5 relative or 1e-6 absolute (a component near 0, as
the class term with no objects); JAX's the same. Gradients with respect
to the head outputs agree analytically, and in float32 within 1e-5 of each
output's largest gradient magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu.config import YoloConfig
from yolo_from_scratch_tpu.data.assign_device import (
    assign_targets_device_masked_batch as jax_assign,
)
from yolo_from_scratch_tpu.ops.losses import yolo_loss_multiscale as jax_dense
from yolo_from_scratch_tpu.ops.losses_sparse import (
    yolo_loss_multiscale_sparse as jax_sparse,
)
from yolo_from_scratch_tpu_torch.data.assign_device import (
    assign_targets_device_masked_batch,
)
from yolo_from_scratch_tpu_torch.ops.losses import yolo_loss_multiscale
from yolo_from_scratch_tpu_torch.ops.losses_sparse import (
    yolo_loss_multiscale_sparse,
)

B, K, IMG = 3, 16, 128
RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5


def _batch(nc, seed):
    """Predictions, labels with exact duplicates and same-box-other-class
    rows (one slot, first wins), padding rows, and a validity mask."""
    rng = np.random.default_rng(seed)
    cfg = YoloConfig(num_classes=nc, img_size=IMG)
    preds = [rng.standard_normal((B, g, g, 3, 5 + nc)).astype(np.float32)
             for g in cfg.grid_sizes]
    labels = np.zeros((B, K, 5), np.float32)
    counts = rng.integers(4, K, B)
    for b in range(B):
        n = counts[b]
        labels[b, :n, 0] = rng.integers(0, nc, n)
        labels[b, :n, 1:3] = rng.uniform(0.05, 0.95, (n, 2))
        labels[b, :n, 3:5] = rng.uniform(0.03, 0.4, (n, 2))
        labels[b, 2] = labels[b, 1]
        labels[b, 3, 1:] = labels[b, 0, 1:]
    valid = np.arange(K)[None] < counts[:, None]
    return cfg, preds, labels, valid


def _port(cfg, preds, labels, valid, quirk, sparse):
    labels, valid = torch.from_numpy(labels), torch.from_numpy(valid)
    if sparse:
        return yolo_loss_multiscale_sparse(
            preds, labels, valid, cfg.anchors_array, cfg.num_classes,
            cfg.img_size, quirk)
    targets = assign_targets_device_masked_batch(
        labels, valid, cfg.anchors_array, cfg.img_size, cfg.num_classes)
    return yolo_loss_multiscale(preds, targets, cfg.anchors_array,
                                cfg.num_classes, cfg.img_size, quirk)


def _jax(cfg, preds, labels, valid, quirk, sparse):
    preds = [jnp.asarray(p) for p in preds]
    if sparse:
        return jax_sparse(preds, jnp.asarray(labels), jnp.asarray(valid),
                          cfg.anchors_array, cfg.num_classes, cfg.img_size,
                          quirk)
    targets = jax_assign(jnp.asarray(labels), jnp.asarray(valid),
                         cfg.anchors_array, cfg.img_size, cfg.num_classes)
    return jax_dense(preds, targets, cfg.anchors_array, cfg.num_classes,
                     cfg.img_size, quirk)


def _check(cfg, preds, labels, valid, quirk):
    tp = [torch.from_numpy(p) for p in preds]
    sparse = [float(v) for v in _port(cfg, tp, labels, valid, quirk, True)]
    for other in (_port(cfg, tp, labels, valid, quirk, False),
                  _jax(cfg, preds, labels, valid, quirk, True),
                  _jax(cfg, preds, labels, valid, quirk, False)):
        np.testing.assert_allclose(sparse, [float(v) for v in other],
                                   rtol=RTOL, atol=ATOL)
    return sparse


@pytest.mark.parametrize("nc", [1, 3, 80])
@pytest.mark.parametrize("quirk", [False, True])
def test_sparse_equals_dense_and_jax(nc, quirk):
    cfg, preds, labels, valid = _batch(nc, nc)
    total, bbox, _, cls = _check(cfg, preds, labels, valid, quirk)
    assert bbox > 0 and cls > 0 and total > 0


def test_no_objects():
    cfg, preds, labels, _ = _batch(3, 7)
    _, bbox, obj, cls = _check(cfg, preds, labels, np.zeros((B, K), bool),
                               False)
    assert bbox == cls == 0.0 and obj > 0


def test_out_of_range_class_ids():
    cfg, preds, labels, valid = _batch(3, 8)
    labels[:, 1, 0] = 99.0
    labels[:, 5, 0] = -1.0
    _check(cfg, preds, labels, valid, False)


@pytest.mark.parametrize("nc", [1, 80])
def test_gradients_equal_dense_and_jax(nc):
    cfg, preds, labels, valid = _batch(nc, 9)
    grads = []
    for sparse in (True, False):
        leaves = [torch.from_numpy(p).requires_grad_(True) for p in preds]
        _port(cfg, leaves, labels, valid, False, sparse)[0].backward()
        grads.append([leaf.grad.numpy() for leaf in leaves])
    want = jax.jit(jax.grad(lambda p: _jax(cfg, p, labels, valid, False,
                                           True)[0]))(preds)
    for s, (gs, gd, gj) in enumerate(zip(*grads, want)):
        scale = np.abs(gd).max()
        for other in (gd, np.asarray(gj)):
            np.testing.assert_allclose(gs, other, rtol=0,
                                       atol=GRAD_TOL * scale,
                                       err_msg=f"scale {s}")
