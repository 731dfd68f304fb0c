"""The port's own copies of the JAX package's host modules match it.

`yolo_from_scratch_tpu_torch/config.py`, `data/letterbox.py`,
`data/dataset.py` and `data/loader.py` are copies, so that the port
imports nothing of the JAX package; these tests hold them to the JAX
originals. Everything here is exact on both sides (numpy and PIL on the
same inputs), so every comparison is bit for bit. The native JPEG loader
and compact targets are ported: `backend="native"` is accepted, and
`auto` resolves as the JAX package's does (`tests/test_torch_native.py`
holds the native path to the JAX package's).
"""

import dataclasses

import numpy as np
import pytest
from PIL import Image

from yolo_from_scratch_tpu import config as jax_config
from yolo_from_scratch_tpu.data import dataset as jax_dataset
from yolo_from_scratch_tpu.data import letterbox as jax_letterbox
from yolo_from_scratch_tpu.data import loader as jax_loader
from yolo_from_scratch_tpu_torch import config as port_config
from yolo_from_scratch_tpu_torch.data import dataset as port_dataset
from yolo_from_scratch_tpu_torch.data import letterbox as port_letterbox
from yolo_from_scratch_tpu_torch.data import loader as port_loader

VARIANTS = [{}, {"num_classes": 3}, {"img_size": 320},
            {"compute_dtype": "bfloat16"}, {"head_type": "anchor_free"},
            {"anchors": ((10, 14), (23, 27), (37, 58))}]


def _same(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("size", sorted(jax_config.YOLO_SIZES))
@pytest.mark.parametrize("kw", VARIANTS, ids=lambda kw: ",".join(kw) or "base")
def test_config_fields_and_derived_values_match(size, kw):
    jc = jax_config.YoloConfig.from_size(size, **kw)
    pc = port_config.YoloConfig.from_size(size, **kw)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    _same(pc.anchors_array, jc.anchors_array)
    for name in ("grid_sizes", "num_anchors", "output_dim", "c_stem", "c_p3",
                 "c_p4", "c_p5"):
        _same(getattr(pc, name), getattr(jc, name))
    assert [pc.repeats(n) for n in (1, 3, 9)] == \
        [jc.repeats(n) for n in (1, 3, 9)]
    for kw2 in ({"img_size": 256}, {"num_classes": 5, "width_mult": 0.75}):
        assert (dataclasses.asdict(pc.with_(**kw2))
                == dataclasses.asdict(jc.with_(**kw2)))


def test_config_constants_are_bit_equal():
    for name in ("DEFAULT_ANCHORS", "YOLO_SIZES", "STRIDES",
                 "NUM_ANCHORS_PER_SCALE"):
        assert getattr(port_config, name) == getattr(jax_config, name), name
    _same(port_config.INV255, jax_config.INV255)
    assert port_config.INV255.tobytes() == jax_config.INV255.tobytes()
    for anchors in (None, [[1, 2], [3, 4], [5, 6]],
                    np.arange(18).reshape(3, 3, 2)):
        _same(port_config.normalize_anchors(anchors),
              jax_config.normalize_anchors(anchors))


def test_config_rejects_what_jax_rejects():
    for kw in ({"img_size": 100}, {"head_type": "x"},
               {"packed_interior": True}):
        for mod in (jax_config, port_config):
            with pytest.raises(ValueError):
                mod.YoloConfig(**kw)


@pytest.mark.parametrize("wh", [(640, 480), (60, 200), (1000, 1), (128, 128),
                                (333, 517)])
@pytest.mark.parametrize("target", [128, 640])
def test_letterbox_params_and_image_bit_equal(wh, target):
    assert (port_letterbox.letterbox_params(*wh, target)
            == jax_letterbox.letterbox_params(*wh, target))
    rng = np.random.default_rng(wh[0] * 7 + wh[1])
    pil = Image.fromarray(rng.integers(0, 256, (wh[1], wh[0], 3),
                                       dtype=np.uint8))
    got = port_letterbox.letterbox_image(pil, target)
    want = jax_letterbox.letterbox_image(pil, target)
    _same(got[0], want[0])
    assert got[1:] == want[1:]
    boxes = rng.uniform(0, 1, (6, 4)).astype(np.float32)
    _same(port_letterbox.adjust_boxes_for_letterbox(boxes, *wh, *got[1:],
                                                    target),
          jax_letterbox.adjust_boxes_for_letterbox(boxes, *wh, *want[1:],
                                                   target))


@pytest.mark.parametrize("num_classes", [1, 4])
def test_assign_targets_bit_equal(num_classes):
    rng = np.random.default_rng(num_classes)
    anchors = np.asarray(jax_config.DEFAULT_ANCHORS, np.float32)
    boxes = rng.uniform(0.02, 0.98, (40, 4)).astype(np.float32)
    boxes[:5] = boxes[0]  # first-wins slots
    boxes[5, :2] = (-0.3, 1.4)  # clamped centers
    classes = rng.integers(0, num_classes, 40)
    for n in (0, 1, 40):
        got = port_dataset.assign_targets(boxes[:n], classes[:n], anchors,
                                          128, num_classes)
        want = jax_dataset.assign_targets(boxes[:n], classes[:n], anchors,
                                          128, num_classes)
        for g, w in zip(got, want, strict=True):
            _same(g, w)


def _datasets(cfg, split_dir):
    args = (str(split_dir), cfg.num_classes, cfg.anchors_array, cfg.img_size)
    return (port_dataset.YoloDataset(*args, backend="pil"),
            jax_dataset.YoloDataset(*args, backend="pil"))


@pytest.mark.parametrize("split,n", [("train", 5), ("val", 5)])
def test_dataset_items_bit_equal(cfg, temp_dataset_dir, split, n):
    port, jax_ds = _datasets(cfg, temp_dataset_dir / split / "images")
    assert len(port) == len(jax_ds) == n
    assert port.imgs == jax_ds.imgs and port.labels == jax_ds.labels
    for i in range(len(port)):
        (pi, pt), (ji, jt) = port[i], jax_ds[i]
        _same(pi, ji)
        for g, w in zip(pt, jt, strict=True):
            _same(g, w)
    assert sum(float(t[..., 4].sum()) for t in port[0][1]) > 0


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("batch_size,sizes", [(2, [2, 2, 1]), (5, [5])])
def test_loader_batches_bit_equal(cfg, temp_dataset_dir, shuffle, prefetch,
                                  batch_size, sizes):
    port, jax_ds = _datasets(cfg, temp_dataset_dir / "val" / "images")
    kw = {"batch_size": batch_size, "shuffle": shuffle, "seed": 3,
          "prefetch": prefetch}
    p_loader = port_loader.DataLoader(port, **kw)
    j_loader = jax_loader.DataLoader(jax_ds, **kw)
    assert len(p_loader) == len(j_loader) == len(sizes)
    for _ in range(2):  # two epochs: the shuffle's generator advances alike
        batches = list(zip(p_loader, j_loader, strict=True))
        assert [b[0][0].shape[0] for b in batches] == sizes
        for (pim, ptg), (jim, jtg) in batches:
            _same(pim, jim)
            for g, w in zip(ptg, jtg, strict=True):
                _same(g, w)


def test_unported_paths_raise(cfg, temp_dataset_dir):
    """Once 'not ported' assertions, now the ported behaviour: the native
    backend is accepted, `auto` resolves as the JAX package's, compact
    targets load, and only an unknown backend raises."""
    split = str(temp_dataset_dir / "train" / "images")
    assert port_dataset.YoloDataset(split, backend="native").backend == \
        "native"
    ds = port_dataset.YoloDataset(split, backend="auto")
    assert ds.backend == jax_dataset.YoloDataset(split).backend
    # compact targets are ported: (uint8 images, labels, counts)
    images, labels, counts = ds.load_batch_compact([0, 1])
    assert images.dtype == np.uint8 and labels.shape == (2, 64, 5)
    assert counts.tolist() == [len(port_dataset.parse_label_file(
        ds.labels[i])) for i in (0, 1)]
    _, (labels, counts) = next(iter(port_loader.DataLoader(ds, compact=16)))
    assert labels.shape[1:] == (16, 5) and counts.dtype == np.int32
    with pytest.raises(ValueError, match="unknown backend"):
        port_dataset.YoloDataset(split, backend="turbo")
