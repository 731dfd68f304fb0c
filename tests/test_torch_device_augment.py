"""The PyTorch port's device mosaic and augmentation (`ops/mosaic_device.py`,
`ops/augment.py`) against the JAX package's, on the CPU.

JAX draws from `jax.random`, which torch cannot replay, so the port's
functions take their draws explicitly. Each test here recomputes JAX's
draws from the key it hands the JAX function, the way that function makes
them (`split`, then `bernoulli` / `randint` / `uniform` of the same shapes:
`mosaic_device.py:75-77`, `augment.py:74-87`), and passes them to the
port. Labels, masks and dense targets must then be equal bit for bit
(copies, flips, multiplications by 0.5 and 1 - cx are exact in float32);
images within 1e-6 (the mean-pool's four-term sum and the jitter's
multiply-add may round in another order; values lie in [0, 1]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu.config import YoloConfig
from yolo_from_scratch_tpu.data.assign_device import pack_labels
from yolo_from_scratch_tpu.data.dataset import assign_targets as jax_assign
from yolo_from_scratch_tpu.models.anchor_free import (
    assign_targets_anchor_free as jax_assign_af,
)
from yolo_from_scratch_tpu.ops import augment as jaug
from yolo_from_scratch_tpu.ops import mosaic_device as jmos
from yolo_from_scratch_tpu_torch.data.assign_device import (
    assign_targets_device_batch,
    assign_targets_device_masked_batch,
    prefix_valid,
)
from yolo_from_scratch_tpu_torch.models.anchor_free import (
    assign_targets_anchor_free_device_batch,
)
from yolo_from_scratch_tpu_torch.ops import augment as taug
from yolo_from_scratch_tpu_torch.ops import mosaic_device as tmos

B, K, IMG, NC = 6, 8, 64, 3
IMAGE_TOL = 1e-6


def _inputs(seed, b=B):
    """float32 images in [0, 1] as uint8 * INV255, compact labels (a few
    boxes small enough for the mosaic's min_box filter), counts."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, IMG, IMG, 3)).astype(np.float32) / 255
    boxes, classes = [], []
    for _ in range(b):
        n = int(rng.integers(0, K + 3))
        wh = rng.uniform(0.01, 0.6, (n, 2))
        wh[::3] = rng.uniform(0.01, 0.06, wh[::3].shape)
        xy = rng.uniform(0.05, 0.95, (n, 2))
        boxes.append(np.concatenate([xy, wh], 1).astype(np.float32))
        classes.append(rng.integers(0, NC, n))
    labels, counts = pack_labels(boxes, classes, K)
    return images.astype(np.float32), labels, counts


def _jax_mosaic_draws(key, b, p=jmos.MOSAIC_P):
    kp, ki = jax.random.split(key)
    return (np.asarray(jax.random.bernoulli(kp, p, (b,))),
            np.asarray(jax.random.randint(ki, (3, b), 0, b)))


def _jax_augment_draws(key, b):
    kf, kg, kb = jax.random.split(key, 3)
    return (np.asarray(jax.random.bernoulli(kf, jaug.FLIP_P, (b,))),
            np.asarray(jax.random.uniform(kg, (b, 1, 1, 1), jnp.float32,
                                          *jaug.GAIN_RANGE)).reshape(b),
            np.asarray(jax.random.uniform(kb, (b, 1, 1, 1), jnp.float32,
                                          *jaug.BIAS_RANGE)).reshape(b))


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrays]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mosaic_matches_jax_given_its_draws(seed):
    images, labels, counts = _inputs(seed)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    do, idx = _jax_mosaic_draws(key, B)
    assert 0 < do.sum() < B  # both branches
    want = jmos.mosaic_compact_batch(key, jnp.asarray(images),
                                     jnp.asarray(labels), jnp.asarray(counts),
                                     min_box=2.0 / IMG)
    got = tmos.mosaic_compact_batch(*_t(images, labels, counts), 2.0 / IMG,
                                    *_t(do, idx))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=IMAGE_TOL)
    for g, w in zip(got[1:], want[1:]):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the filter dropped small boxes of mosaicked images
    assert int(got[2].sum()) < int(sum(counts[i] if not do[i] else
                                       counts[i] + counts[idx[:, i]].sum()
                                       for i in range(B)))


@pytest.mark.parametrize("anchor_free", [False, True])
@pytest.mark.parametrize("jitter", [True, False])
def test_augment_batch_matches_jax_given_its_draws(anchor_free, jitter):
    images, labels, counts = _inputs(3)
    assign, args = ((jax_assign_af, (IMG, NC)) if anchor_free else
                    (jax_assign, (YoloConfig().anchors_array, IMG, NC)))
    per = [assign(labels[i, :counts[i], 1:5],
                  labels[i, :counts[i], 0].astype(np.int64), *args)
           for i in range(B)]
    targets = [np.stack([p[s] for p in per]) for s in range(3)]
    key = jax.random.fold_in(jax.random.PRNGKey(11), 3)
    do_flip, gain, bias = _jax_augment_draws(key, B)
    assert 0 < do_flip.sum() < B
    want = jaug.augment_batch(key, jnp.asarray(images),
                              [jnp.asarray(t) for t in targets],
                              anchor_free=anchor_free, jitter=jitter)
    got = taug.augment_batch(*_t(images), _t(*targets),
                             *_t(do_flip, *((gain, bias) if jitter
                                            else (None, None))),
                             anchor_free=anchor_free)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=IMAGE_TOL)
    assert (got[0].numpy() != images).any()
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("jitter", [True, False])
def test_augment_compact_batch_matches_jax_given_its_draws(jitter):
    images, labels, counts = _inputs(4)
    valid = np.arange(K)[None] < counts[:, None]
    key = jax.random.fold_in(jax.random.PRNGKey(12), 3)
    do_flip, gain, bias = _jax_augment_draws(key, B)
    assert 0 < do_flip.sum() < B
    want = jaug.augment_compact_batch(key, jnp.asarray(images),
                                      jnp.asarray(labels), jnp.asarray(valid),
                                      jitter=jitter)
    got = taug.augment_compact_batch(
        *_t(images, labels, valid, do_flip),
        *_t(*((gain, bias) if jitter else (None, None))))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=IMAGE_TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("anchor_free", [False, True])
def test_flip_commutes_with_assignment(anchor_free):
    """Assign then flip the dense maps == flip the labels (cx -> 1 - cx on
    valid rows) then assign: the dense-level and label-level augmentations
    agree (no centre lies on a cell boundary here)."""
    images, labels, counts = _inputs(5)
    labels, counts = torch.from_numpy(labels), torch.from_numpy(counts)
    do_flip = torch.tensor([True, False] * (B // 2))

    def assign(lab):
        if anchor_free:
            return assign_targets_anchor_free_device_batch(lab, counts, IMG,
                                                           NC)
        return assign_targets_device_batch(lab, counts,
                                           YoloConfig().anchors_array, IMG, NC)

    images = torch.from_numpy(images)
    _, dense = taug.augment_batch(images, assign(labels), do_flip,
                                  anchor_free=anchor_free)
    _, flipped = taug.augment_compact_batch(
        images, labels, prefix_valid(counts, K), do_flip)
    for d, f in zip(dense, assign(flipped)):
        torch.testing.assert_close(d, f, rtol=0, atol=0)


def test_double_flip_is_the_identity():
    images, labels, counts = _inputs(6)
    targets = assign_targets_device_batch(
        torch.from_numpy(labels), torch.from_numpy(counts),
        YoloConfig().anchors_array, IMG, NC)
    do_flip = torch.ones(B, dtype=torch.bool)
    once = taug.augment_batch(torch.from_numpy(images), targets, do_flip)
    twice = taug.augment_batch(*once, do_flip)
    assert not torch.equal(once[0], twice[0])
    torch.testing.assert_close(twice[0], torch.from_numpy(images), rtol=0,
                               atol=0)
    for t, w in zip(twice[1], targets):
        # 1 - (1 - cx) rounds twice in float32: within 2^-24 of cx
        torch.testing.assert_close(t[..., 1:], w[..., 1:], rtol=0, atol=0)
        torch.testing.assert_close(t[..., 0], w[..., 0], rtol=0,
                                   atol=2.0 ** -24)


def test_samplers_are_deterministic_per_seed_and_step():
    """The same (seed, step) gives the same draws, another step or seed
    others; over 4,096 images the flip and the mosaic each fire about half
    the time (5 sigma of a fair coin: 0.5 +- 0.04), partners cover the
    batch, gain and bias stay in their ranges."""
    def draws(seed, step, b=8):
        return (taug.augment_draws(taug.step_generator(seed, step), b)
                + tmos.mosaic_draws(taug.step_generator(seed, step), b))

    first = draws(0, 3)
    for again, other in ((draws(0, 3), True), (draws(0, 4), False),
                         (draws(1, 3), False)):
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        assert same is other
    do_flip, gain, bias = taug.augment_draws(taug.step_generator(7, 0), 4096)
    do, idx = tmos.mosaic_draws(taug.step_generator(7 ^ 0x6D6F7361, 0), 4096)
    assert abs(do_flip.float().mean().item() - 0.5) < 0.04
    assert abs(do.float().mean().item() - 0.5) < 0.04
    assert idx.min() == 0 and idx.max() == 4095 and idx.shape == (3, 4096)
    assert 0.7 <= gain.min() and gain.max() < 1.3
    assert -0.08 <= bias.min() and bias.max() < 0.08
    assert taug.augment_draws(taug.step_generator(7, 0), 4,
                              jitter=False)[1:] == (None, None)


def test_make_device_augment_draws_from_the_step():
    images, labels, counts = _inputs(8)
    targets = assign_targets_device_batch(
        torch.from_numpy(labels), torch.from_numpy(counts),
        YoloConfig().anchors_array, IMG, NC)
    aug = taug.make_device_augment(YoloConfig(num_classes=NC), seed=5)
    got = aug(9, torch.from_numpy(images), targets)
    want = taug.augment_batch(torch.from_numpy(images), targets,
                              *taug.augment_draws(taug.step_generator(5, 9),
                                                  B))
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for g, w in zip(got[1], want[1]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    flip_only = taug.make_device_augment(YoloConfig(num_classes=NC), seed=5,
                                         jitter=False)(9, torch.from_numpy(
                                             images), targets)[0]
    assert set(np.unique(flip_only.numpy())) <= set(np.unique(images))


def test_train_steps_draw_from_the_seed_and_step():
    """The train step's mosaic and augmentation are the functions above
    with the draws of `step_generator`: (seed ^ MOSAIC_SALT, step) for the
    mosaic, (seed, step) for the flip and jitter. The step's loss equals
    the loss of the batch mosaicked / augmented by hand, bit for bit."""
    import copy

    from yolo_from_scratch_tpu_torch.models.yolo import YOLO
    from yolo_from_scratch_tpu_torch.train.steps import (
        MOSAIC_SALT,
        TrainState,
        make_loss_fn,
        make_optimizer,
        make_train_step,
    )

    cfg = YoloConfig(num_classes=NC, img_size=IMG, width_mult=0.25,
                     depth_mult=0.33)
    model = YOLO(cfg).reset_parameters(torch.Generator().manual_seed(0))
    images, labels, counts = _inputs(9)
    images, labels, counts = _t(images, labels, counts)
    dense = assign_targets_device_batch(labels, counts, cfg.anchors_array,
                                        IMG, NC)
    seed = 3

    def step_loss(batch, **kw):
        m = copy.deepcopy(model)
        state = TrainState(m, make_optimizer(m.parameters(), 1e-3))
        return make_train_step(cfg, augment_seed=seed, **kw)(
            state, *batch)[1]["loss"]

    def hand_loss(images, targets):
        return make_loss_fn(cfg)(copy.deepcopy(model), images, targets)[0]

    got = step_loss((images, dense), device_augment=True)
    want = hand_loss(*taug.augment_batch(images, dense, *taug.augment_draws(
        taug.step_generator(seed, 0), B)))
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)

    got = step_loss((images, [labels, counts]), compact_targets=True,
                    device_mosaic=True)
    m_images, m_labels, m_valid = tmos.mosaic_compact_batch(
        images, labels, counts, 2.0 / IMG, *tmos.mosaic_draws(
            taug.step_generator(seed ^ MOSAIC_SALT, 0), B))
    want = hand_loss(m_images, assign_targets_device_masked_batch(
        m_labels, m_valid, cfg.anchors_array, IMG, NC))
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)
