"""Loss ops of the PyTorch port (`ops/ciou.py`, `ops/losses.py`) against
the JAX package, values and gradients, on the CPU.

Same numpy inputs on both sides, float32. Tolerances: values 1e-5
relative (elementwise float32 ops with an atan and a log1p, summed over
a few hundred cells in another order); gradients 1e-4 relative / 1e-7
absolute (each cell's gradient is a handful of ulps of a value divided by
the cell count).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu.config import DEFAULT_ANCHORS
from yolo_from_scratch_tpu.data.dataset import assign_targets
from yolo_from_scratch_tpu.ops.ciou import ciou as jax_ciou
from yolo_from_scratch_tpu.ops.ciou import ciou_loss as jax_ciou_loss
from yolo_from_scratch_tpu.ops.losses import (
    yolo_loss_multiscale as jax_loss_multiscale,
)
from yolo_from_scratch_tpu_torch.ops import ciou, losses

ANCHORS = np.asarray(DEFAULT_ANCHORS, np.float32)


def _boxes(rng, n):
    """n center-format boxes with nonzero w, h inside the unit square."""
    wh = rng.uniform(0.05, 0.5, (n, 2))
    xy = rng.uniform(0.25, 0.75, (n, 2))
    return np.concatenate([xy, wh], 1).astype(np.float32)


def test_ciou_values_and_gradients_match_jax():
    rng = np.random.default_rng(0)
    pred, tgt = _boxes(rng, 64), _boxes(rng, 64)
    mask = rng.random(64) < 0.5
    got = ciou.ciou(torch.from_numpy(pred), torch.from_numpy(tgt))
    want = jax_ciou(jnp.asarray(pred), jnp.asarray(tgt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)

    for m in (None, mask):
        p = torch.from_numpy(pred).requires_grad_(True)
        loss = ciou.ciou_loss(p, torch.from_numpy(tgt),
                              None if m is None else torch.from_numpy(m))
        loss.backward()
        jm = None if m is None else jnp.asarray(m)
        want_loss, want_grad = jax.value_and_grad(
            lambda b: jax_ciou_loss(b, jnp.asarray(tgt), jm))(
                jnp.asarray(pred))
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad),
                                   rtol=1e-4, atol=1e-7)


def test_ciou_alpha_is_detached(monkeypatch):
    """The aspect term's alpha carries no gradient: with its detach made a
    no-op, the gradient moves away from the JAX one."""
    rng = np.random.default_rng(1)
    pred, tgt = _boxes(rng, 32), _boxes(rng, 32)
    want = np.asarray(jax.grad(lambda b: jax_ciou_loss(
        b, jnp.asarray(tgt)))(jnp.asarray(pred)))

    def grad():
        p = torch.from_numpy(pred).requires_grad_(True)
        ciou.ciou_loss(p, torch.from_numpy(tgt)).backward()
        return p.grad.numpy()

    np.testing.assert_allclose(grad(), want, rtol=1e-4, atol=1e-7)
    monkeypatch.setattr(torch.Tensor, "detach", lambda self: self)
    assert np.abs(grad() - want).max() > 1e-4


def _targets(rng, b, img_size, nc):
    """Dense host targets from the JAX package's own assignment."""
    per_image = []
    for _ in range(b):
        n = int(rng.integers(1, 5))
        boxes = _boxes(rng, n)
        per_image.append(assign_targets(boxes, rng.integers(0, nc, n),
                                        ANCHORS, img_size, nc))
    return [np.stack([t[s] for t in per_image]) for s in range(3)]


@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("quirk_640", [False, True])
def test_multiscale_loss_and_gradients_match_jax(nc, quirk_640):
    img_size = 128
    rng = np.random.default_rng(nc + 10 * quirk_640)
    targets = _targets(rng, 2, img_size, nc)
    preds = [rng.normal(0, 1, t.shape).astype(np.float32) for t in targets]

    tp = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    got = losses.yolo_loss_multiscale(tp, [torch.from_numpy(t)
                                           for t in targets],
                                      torch.from_numpy(ANCHORS), nc,
                                      img_size, quirk_640)
    got[0].backward()

    def jax_total(ps, ts):
        out = jax_loss_multiscale(ps, ts, ANCHORS, nc, img_size, quirk_640)
        return out[0], out

    (_, want), want_grads = jax.jit(jax.value_and_grad(
        jax_total, has_aux=True))([jnp.asarray(p) for p in preds],
                                  [jnp.asarray(t) for t in targets])
    for g, w in zip(got, want):  # total, bbox, obj, cls
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    for p, w in zip(tp, want_grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-7)


def test_bce_is_the_stable_form():
    x = torch.tensor([-100.0, -3.0, 0.0, 2.5, 100.0])
    z = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0])
    want = torch.nn.functional.binary_cross_entropy_with_logits(
        x, z, reduction="none")
    torch.testing.assert_close(losses.sigmoid_bce(x, z), want, rtol=1e-6,
                               atol=1e-6)
