"""The packed layouts' data path in the PyTorch port against the JAX
package's, on the CPU: the loader's host packing (dense and compact
batches, a process shard), the packed flip, augmentation and device mosaic
(given JAX's draws, recomputed from its key as in
`tests/test_torch_device_augment.py`), and the train step's input adapter
under packing against the unpacked one, packed afterwards. Labels, masks
and dense targets equal bit for bit; images within 1e-6 (the mosaic's
mean-pool and the jitter may round in another order) or bit for bit where
only data moves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_device_augment import (
    IMAGE_TOL,
    _inputs,
    _jax_augment_draws,
    _jax_mosaic_draws,
    _t,
)

from yolo_from_scratch_tpu.data.dataset import YoloDataset as JaxDataset
from yolo_from_scratch_tpu.data.loader import DataLoader as JaxLoader
from yolo_from_scratch_tpu.models import packed as jpk
from yolo_from_scratch_tpu.ops import augment as jaug
from yolo_from_scratch_tpu.ops import mosaic_device as jmos
from yolo_from_scratch_tpu_torch.config import YoloConfig
from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
from yolo_from_scratch_tpu_torch.models.packed import pack_s2d, unpack_s2d
from yolo_from_scratch_tpu_torch.ops import augment as taug
from yolo_from_scratch_tpu_torch.ops import mosaic_device as tmos
from yolo_from_scratch_tpu_torch.train.steps import DrawSpec, _make_expand

B, IMG = 6, 64


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Six test workers share the cores: torch's default threads would
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _packed(images):
    return jpk.pack_s2d_host(images)


@pytest.mark.parametrize("f", [2, 4])
def test_packed_flip_bit_equal(f):
    x = np.random.default_rng(f).random((3, 32, 32, 3)).astype(np.float32)
    packed = jpk.pack_s2d_host(x, f)
    got = taug.flip_images_lr(torch.from_numpy(packed), packed=True, f=f)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jaug.flip_images_lr(jnp.asarray(packed),
                                                    packed=True, f=f)))
    # the packing of the flipped pixels
    np.testing.assert_array_equal(got.numpy(),
                                  jpk.pack_s2d_host(x[:, :, ::-1], f))


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_mosaic_matches_jax_given_its_draws(seed):
    images, labels, counts = _inputs(seed)
    packed = _packed(images)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    do, idx = _jax_mosaic_draws(key, B)
    assert 0 < do.sum() < B
    want = jmos.mosaic_compact_batch(key, jnp.asarray(packed),
                                     jnp.asarray(labels), jnp.asarray(counts),
                                     min_box=2.0 / IMG, packed=True)
    got = tmos.mosaic_compact_batch(*_t(packed, labels, counts), 2.0 / IMG,
                                    *_t(do, idx), packed=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=IMAGE_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # == the unpacked mosaic, packed; partners from a gathered source too
    flat = tmos.mosaic_compact_batch(*_t(images, labels, counts), 2.0 / IMG,
                                     *_t(do, idx))
    np.testing.assert_array_equal(got[0].numpy(),
                                  pack_s2d(flat[0]).numpy())
    src = tmos.mosaic_compact_batch(*_t(packed, labels, counts), 2.0 / IMG,
                                    *_t(do, idx), packed=True,
                                    source=_t(packed, labels, counts))
    for g, w in zip(src, got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("jitter", [True, False])
def test_packed_augment_matches_jax_given_its_draws(jitter):
    images, labels, counts = _inputs(4)
    packed = _packed(images)
    valid = np.arange(labels.shape[1])[None] < counts[:, None]
    key = jax.random.fold_in(jax.random.PRNGKey(12), 3)
    do_flip, gain, bias = _jax_augment_draws(key, B)
    assert 0 < do_flip.sum() < B
    draws = _t(do_flip, *((gain, bias) if jitter else (None, None)))
    want = jaug.augment_compact_batch(key, jnp.asarray(packed),
                                      jnp.asarray(labels), jnp.asarray(valid),
                                      packed=True, jitter=jitter)
    got = taug.augment_compact_batch(*_t(packed, labels, valid), *draws,
                                     packed=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=IMAGE_TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    targets = [np.zeros((B, IMG // s, IMG // s, 3, 8), np.float32)
               for s in (8, 16, 32)]
    want = jaug.augment_batch(key, jnp.asarray(packed),
                              [jnp.asarray(t) for t in targets], packed=True,
                              jitter=jitter)
    got = taug.augment_batch(*_t(packed), _t(*targets), *draws, packed=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=IMAGE_TOL)


@pytest.mark.parametrize("compact", [0, 8])
@pytest.mark.parametrize("shard", [None, (1, 2)])
def test_loader_packs_as_jax(temp_dataset_multiclass, compact, shard):
    images = str(temp_dataset_multiclass / "train" / "images")
    kw = dict(batch_size=2, shuffle=True, seed=3, prefetch=0,
              compact=compact, process_shard=shard, pack_images=True)
    port = DataLoader(YoloDataset(images, 3, img_size=IMG, backend="pil"),
                      **kw)
    ref = JaxLoader(JaxDataset(images, 3, img_size=IMG, backend="pil"), **kw)
    n = 0
    for (gi, gt), (wi, wt) in zip(port, ref):
        assert gi.shape[1:] == (IMG // 4, IMG // 4, 48)
        np.testing.assert_array_equal(gi, wi)
        for g, w in zip(gt, wt):
            np.testing.assert_array_equal(g, w)
        n += 1
    assert n == len(port) > 0
    # the prefetch thread packs the same batches
    kw["prefetch"] = 2
    threaded = DataLoader(YoloDataset(images, 3, img_size=IMG,
                                      backend="pil"), **kw)
    for (gi, _), (wi, _) in zip(threaded, JaxLoader(
            JaxDataset(images, 3, img_size=IMG, backend="pil"), **kw)):
        np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
def test_packed_expand_is_the_unpacked_one_packed(head):
    """The train step's input adapter (uint8 normalize, mosaic, label-level
    flip and jitter, target assignment) on the packed batch == on the
    pixel batch, with the images packed after; same draws."""
    images, labels, counts = _inputs(6)
    u8 = np.round(images * 255).astype(np.uint8)
    cfg = YoloConfig(num_classes=3, img_size=IMG, head_type=head)
    packed_cfg = cfg.with_(packed_stem=True, packed_interior=True,
                           packed_p3=True)
    kw = dict(mosaic=True, seed=9, device_augment=True,
              sparse=head == "anchor")
    draws = DrawSpec(9, True, True, True).draw(3, B)
    want = _make_expand(cfg, True, **kw)(3, *_t(u8), _t(labels, counts),
                                         draws)
    got = _make_expand(packed_cfg, True, **kw)(
        3, *_t(_packed(u8)), _t(labels, counts), draws)
    np.testing.assert_array_equal(unpack_s2d(got[0]).numpy(),
                                  want[0].numpy())
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
