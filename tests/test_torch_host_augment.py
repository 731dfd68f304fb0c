"""The port's load-time augmentation (`data/dataset.py`: `resize_linear`,
`mosaic_4`, `augment_image_and_boxes`, `YoloDataset(augment=True)`)
against the JAX package's, on the CPU.

The JAX mosaic resizes its quadrants with OpenCV's
`cv2.resize(INTER_LINEAR)`; the port computes the same half-pixel,
non-antialiased bilinear in numpy (OpenCV is not on the card's machine).
The two differ by OpenCV's vectorized multiply-adds: images within 1e-6
(absolute, in [0, 1]). Everything drawn from the generator is the JAX
package's to the bit: the mosaic's partners and centre, the flip, gain and
bias (the generators' states equal after every item), and so are the
boxes, classes and dense targets of both heads.
"""

import cv2
import numpy as np
import pytest

from yolo_from_scratch_tpu.data import dataset as jax_dataset
from yolo_from_scratch_tpu_torch.data import dataset as port_dataset

IMAGE_TOL = 1e-6


@pytest.mark.parametrize("src,dst", [(64, (32, 32)), (64, (19, 44)),
                                     (128, (38, 89)), (128, (127, 2)),
                                     (640, (192, 448)), (640, (27, 45)),
                                     (640, (213, 320))])
def test_resize_linear_matches_cv2(src, dst):
    img = np.random.default_rng(src + dst[0]).random((src, src, 3),
                                                     dtype=np.float32)
    w, h = dst
    want = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    got = port_dataset.resize_linear(img, w, h)
    assert got.dtype == np.float32 and got.shape == (h, w, 3)
    np.testing.assert_allclose(got, want.reshape(h, w, 3), rtol=0,
                               atol=IMAGE_TOL)


def _samples(rng, s=64, n=4):
    out = []
    for _ in range(n):
        m = int(rng.integers(0, 5))
        boxes = np.concatenate([rng.uniform(0.1, 0.9, (m, 2)),
                                rng.uniform(0.001, 0.5, (m, 2))],
                               1).astype(np.float32)
        out.append((rng.random((s, s, 3), dtype=np.float32), boxes,
                    rng.integers(0, 3, m)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_mosaic_4_matches_jax(seed):
    samples = _samples(np.random.default_rng(seed))
    rngs = [np.random.default_rng(100 + seed) for _ in range(2)]
    want = jax_dataset.mosaic_4(samples, rngs[0], min_box=2.0 / 64)
    got = port_dataset.mosaic_4(samples, rngs[1], min_box=2.0 / 64)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=IMAGE_TOL)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert rngs[0].bit_generator.state == rngs[1].bit_generator.state


@pytest.mark.parametrize("seed", range(4))
def test_augment_image_and_boxes_matches_jax(seed):
    img, boxes, _ = _samples(np.random.default_rng(seed), n=1)[0]
    rngs = [np.random.default_rng(seed) for _ in range(2)]
    want = jax_dataset.augment_image_and_boxes(img, boxes, rngs[0])
    got = port_dataset.augment_image_and_boxes(img, boxes, rngs[1])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert rngs[0].bit_generator.state == rngs[1].bit_generator.state


def _datasets(root, head, seed):
    images = str(root / "train" / "images")
    anchors = np.asarray(jax_dataset.YoloDataset(images).anchors)
    kw = dict(num_classes=1, anchors=anchors, img_size=64, head_type=head,
              augment=True, seed=seed)
    return (port_dataset.YoloDataset(images, backend="pil", **kw),
            jax_dataset.YoloDataset(images, backend="pil", **kw))


@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
def test_dataset_items_match_jax(temp_dataset_dir, head):
    """Two passes over the 5-image split (mosaics with p=0.5): each item's
    targets equal, its image within IMAGE_TOL, the draws in step."""
    port, jax_ds = _datasets(temp_dataset_dir, head, seed=3)
    for idx in list(range(len(port))) * 2:
        (img, targets), (want_img, want_targets) = port[idx], jax_ds[idx]
        np.testing.assert_allclose(img, want_img, rtol=0, atol=IMAGE_TOL)
        for t, w in zip(targets, want_targets):
            np.testing.assert_array_equal(t, w)
        assert (port._aug_rng.bit_generator.state
                == jax_ds._aug_rng.bit_generator.state)


def test_load_batch_takes_the_augmented_items(temp_dataset_dir):
    """load_batch runs the items in index order through the augmentation,
    as the JAX package's does (its per-item path)."""
    port, jax_ds = _datasets(temp_dataset_dir, "anchor", seed=5)
    for batch in ([0, 1, 2], [4, 3]):
        (imgs, targets), (want_imgs, want_targets) = (
            port.load_batch(batch), jax_ds.load_batch(batch))
        np.testing.assert_allclose(imgs, want_imgs, rtol=0, atol=IMAGE_TOL)
        for t, w in zip(targets, want_targets):
            np.testing.assert_array_equal(t, w)
    # off by default, and then the plain items
    plain = port_dataset.YoloDataset(str(temp_dataset_dir / "train" /
                                         "images"), img_size=64)
    assert not plain.augment
    np.testing.assert_array_equal(plain[0][0], plain._load_raw(0)[0])
