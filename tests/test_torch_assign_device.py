"""On-device target assignment of the PyTorch port
(`data/assign_device.py`, `models/anchor_free.py::
assign_targets_anchor_free_device_batch`) and its compact data path
(`pack_labels`, `YoloDataset.load_batch_compact`, `DataLoader(compact=K)`,
`DeviceQueue`) against the JAX package, on the CPU with seeded numpy
labels.

Every comparison is bit for bit: the assignment is comparisons, an argmax,
truncations and copies of the label values, and its float32 expressions
(the shape IoU, centre * gs, max(w, h) against the size thresholds) are
the host's, evaluated in float32 on every side. Labels carry duplicate
slots (same box, or same cell and anchor), centres at and beyond 0 and 1,
a full K, empty images and garbage in the padding rows. Out-of-range class
ids are held against JAX's device assignment only (zero class row): the
host assignments index out of bounds there.
"""

import io
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu.config import YoloConfig
from yolo_from_scratch_tpu.data import assign_device as jad
from yolo_from_scratch_tpu.data.dataset import YoloDataset as JaxDataset
from yolo_from_scratch_tpu.data.dataset import assign_targets as jax_host
from yolo_from_scratch_tpu.data.loader import DataLoader as JaxLoader
from yolo_from_scratch_tpu.models import anchor_free as jaf
from yolo_from_scratch_tpu_torch import config as port_config
from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
from yolo_from_scratch_tpu_torch.data import assign_device as tad
from yolo_from_scratch_tpu_torch.data.dataset import assign_targets
from yolo_from_scratch_tpu_torch.data.device_queue import DeviceQueue
from yolo_from_scratch_tpu_torch.models import anchor_free as taf

CPU = torch.device("cpu")
K = 16


def _random_labels(rng, b, nc, k=K, lo=0.01, hi=0.6):
    """(labels (B, K, 5), counts (B,)): counts from 0 to K (one image empty,
    one full), duplicates of earlier rows, centres on 0, 1 and beyond, and
    garbage in the padding."""
    labels = rng.uniform(-3.0, 3.0, (b, k, 5)).astype(np.float32)  # garbage
    counts = rng.integers(1, k, b).astype(np.int32)
    counts[0], counts[-1] = 0, k
    for i in range(b):
        n = counts[i]
        labels[i, :n, 0] = rng.integers(0, nc, n)
        labels[i, :n, 1:3] = rng.uniform(0.0, 1.0, (n, 2))
        labels[i, :n, 3:5] = rng.uniform(lo, hi, (n, 2))
        if n >= 6:
            labels[i, 2] = labels[i, 1]                  # the same box twice
            labels[i, 3, 1:] = labels[i, 0, 1:]          # ... another class
            labels[i, 4, 1:3] = (0.0, 1.0)               # centres on the edges
            labels[i, 5, 1:3] = (1.0 + 1e-3, -0.25)      # and off the image
    return labels, counts


def _host(fn, labels, counts, *args):
    per = [fn(labels[i, :n, 1:5], labels[i, :n, 0].astype(np.int64), *args)
           for i, n in enumerate(counts)]
    return [np.stack([p[s] for p in per]) for s in range(3)]


def _same(got, want):
    for g, w in zip(got, want, strict=True):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("nc,img", [(1, 64), (3, 128), (80, 128)])
def test_anchor_assignment_bit_equal(nc, img):
    cfg = YoloConfig(num_classes=nc, img_size=img)
    anchors = cfg.anchors_array
    labels, counts = _random_labels(np.random.default_rng(nc), 6, nc)
    got = tad.assign_targets_device_batch(
        torch.from_numpy(labels), torch.from_numpy(counts), anchors, img, nc)
    assert [tuple(g.shape) for g in got] == [
        (6, gs, gs, 3, 5 + nc) for gs in cfg.grid_sizes]
    _same(got, _host(assign_targets, labels, counts, anchors, img, nc))
    _same(got, _host(jax_host, labels, counts, anchors, img, nc))
    _same(got, jad.assign_targets_device_batch(
        jnp.asarray(labels), jnp.asarray(counts), anchors, img, nc))
    assert sum(int(g[..., 4].sum()) for g in got) < counts.sum()  # clashes


@pytest.mark.parametrize("nc", [1, 3, 80])
def test_anchor_assignment_masked_and_out_of_range_ids(nc):
    """An interleaved validity mask (the mosaic's), ids below 0 and past
    nc: equal to JAX's device assignment (nc=1 writes 1 whatever the id,
    as the host does)."""
    rng = np.random.default_rng(10 + nc)
    labels, _ = _random_labels(rng, 4, nc)
    labels[:, ::3, 0] = rng.choice([-2.0, -1.0, nc, nc + 7.5], (4, 6))
    valid = rng.random((4, K)) < 0.6
    got = tad.assign_targets_device_masked_batch(
        torch.from_numpy(labels), torch.from_numpy(valid),
        YoloConfig().anchors_array, 128, nc)
    want = jad.assign_targets_device_masked_batch(
        jnp.asarray(labels), jnp.asarray(valid), YoloConfig().anchors_array,
        128, nc)
    _same(got, want)
    onehot = tad.class_onehot(torch.from_numpy(labels[..., 0]).int(), nc)
    np.testing.assert_array_equal(onehot.numpy(), np.stack([
        np.asarray(jad.class_onehot(jnp.asarray(labels[i, :, 0]).astype(
            jnp.int32), nc)) for i in range(4)]))


def test_transport_slots_bit_equal():
    labels, counts = _random_labels(np.random.default_rng(5), 4, 3)
    valid = np.arange(K)[None] < counts[:, None]
    got = tad.transport_slots(torch.from_numpy(labels),
                              torch.from_numpy(valid),
                              YoloConfig().anchors_array, 128)
    for i in range(4):
        want = jad.transport_slots(jnp.asarray(labels[i]),
                                   jnp.asarray(valid[i]),
                                   YoloConfig().anchors_array, 128)
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))
        for s in range(3):
            np.testing.assert_array_equal(got[1][s][i].numpy(),
                                          np.asarray(want[1][s]))
            np.testing.assert_array_equal(got[2][s][i].numpy(),
                                          np.asarray(want[2][s]))


def test_empty_labels_and_garbage_padding_write_nothing():
    labels = np.full((3, 8, 5), 7.7, np.float32)
    got = tad.assign_targets_device_batch(
        torch.from_numpy(labels), torch.zeros(3, dtype=torch.int32),
        YoloConfig().anchors_array, 64, 5)
    assert all(float(g.abs().sum()) == 0.0 for g in got)
    got = taf.assign_targets_anchor_free_device_batch(
        torch.from_numpy(labels), torch.zeros(3, dtype=torch.int32), 64, 5)
    assert all(float(g.abs().sum()) == 0.0 for g in got)


@pytest.mark.parametrize("nc,img", [(1, 64), (3, 128), (80, 128)])
def test_anchor_free_assignment_bit_equal(nc, img):
    """Sizes on both sides of the 0.1 / 0.25 routing thresholds."""
    rng = np.random.default_rng(20 + nc)
    labels, counts = _random_labels(rng, 6, nc, lo=0.02, hi=0.5)
    labels[:, 6::3, 3:5] = rng.uniform(0.02, 0.1, (6, 4, 2))  # small: P3
    got = taf.assign_targets_anchor_free_device_batch(
        torch.from_numpy(labels), torch.from_numpy(counts), img, nc)
    assert [tuple(g.shape) for g in got] == [
        (6, img // s, img // s, 5 + nc) for s in (8, 16, 32)]
    _same(got, _host(taf.assign_targets_anchor_free, labels, counts, img, nc))
    _same(got, _host(jaf.assign_targets_anchor_free, labels, counts, img, nc))
    _same(got, jaf.assign_targets_anchor_free_device_batch(
        jnp.asarray(labels), jnp.asarray(counts), img, nc))
    assert all(int(g[..., 4].sum()) > 0 for g in got)  # every scale used

    labels[:, ::4, 0] = -1.0  # out-of-range ids: JAX's device assignment
    labels[:, 1::4, 0] = nc
    got = taf.assign_targets_anchor_free_device_batch(
        torch.from_numpy(labels), torch.from_numpy(counts), img, nc)
    _same(got, jaf.assign_targets_anchor_free_device_batch(
        jnp.asarray(labels), jnp.asarray(counts), img, nc))


def test_pack_labels_truncates_to_the_first_k():
    rng = np.random.default_rng(30)
    boxes = [rng.random((n, 4)).astype(np.float32) for n in (0, 3, 9)]
    classes = [rng.integers(0, 5, len(b)) for b in boxes]
    got = tad.pack_labels(boxes, classes, 4)
    want = jad.pack_labels(boxes, classes, 4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], [0, 3, 4])
    np.testing.assert_array_equal(got[0][2, :, 1:], boxes[2][:4])


@pytest.fixture(scope="module")
def crowded_dir(tmp_path_factory, temp_dataset_multiclass):
    """The multiclass split with one label file of 20 boxes."""
    import shutil

    root = tmp_path_factory.mktemp("crowded")
    shutil.copytree(temp_dataset_multiclass / "train", root / "train")
    rng = np.random.default_rng(31)
    rows = [f"{int(c)} {x:.6f} {y:.6f} {w:.6f} {h:.6f}" for c, x, y, w, h in
            zip(rng.integers(0, 3, 20), *rng.uniform(0.1, 0.9, (2, 20)),
                *rng.uniform(0.05, 0.3, (2, 20)))]
    (root / "train" / "labels" / "img_1.txt").write_text("\n".join(rows))
    return str(root / "train" / "images")


def test_load_batch_compact_and_loader_match_jax(crowded_dir):
    """The port's compact batch equals the JAX PIL backend's at K=8 (one
    image holds 20 boxes: the first 8 kept, one warning); the loader and
    DeviceQueue carry (uint8 images, [labels, counts]) over two shuffled
    epochs like JAX's loader, and the device assignment of the batch
    equals the dense batch's targets."""
    port = YoloDataset(crowded_dir, 3, img_size=64, backend="pil")
    jds = JaxDataset(crowded_dir, 3, img_size=64, backend="pil")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        got = port.load_batch_compact([0, 1, 2], capacity=8)
        port.load_batch_compact([1], capacity=8)
    assert err.getvalue().count("WARNING: image with 20 boxes exceeds") == 1
    want = jds.load_batch_compact([0, 1, 2], capacity=8)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.uint8 and got[2][1] == 8
    np.testing.assert_array_equal(got[0][:1] * port_config.INV255,
                                  port.load_batch([0])[0])

    kw = {"batch_size": 3, "shuffle": True, "seed": 4, "compact": 8}
    p_loader, j_loader = DataLoader(port, **kw), JaxLoader(jds, **kw)
    for _ in range(2):
        for (pim, (plab, pcnt)), (jim, (jlab, jcnt)) in zip(
                p_loader, j_loader, strict=True):
            for g, w in ((pim, jim), (plab, jlab), (pcnt, jcnt)):
                np.testing.assert_array_equal(g, w)
    images, targets, valid = next(iter(DeviceQueue(
        DataLoader(port, batch_size=4, compact=32), CPU)))
    assert images.dtype == torch.uint8 and valid == 4
    labels, counts = targets
    dense = port.load_batch(range(4))[1]
    _same(tad.assign_targets_device_batch(labels, counts, port.anchors, 64,
                                          3), dense)
