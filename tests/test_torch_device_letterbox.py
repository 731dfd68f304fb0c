"""The port's device letterbox against the JAX package's and against the
host PIL letterbox, on the CPU.

- staging (`bucket_shape`, `stage_to_bucket`, `letterbox_geometry`): host
  numpy, bit-equal.
- `letterbox_device_bucketed` and `letterbox_device` against JAX: 1e-5.
  Both rebuild the same antialiased triangle weights in float32 and sum
  the same products in another order (values in [0, 1]).
- content against PIL: within 1.5/255 (the JAX function's own contract,
  tests/test_device_letterbox.py), the pad exact.
- `BatchPredictor` / `Predictor` with `device_letterbox=True` against the
  host path: rtol 0.05, atol 1 px, as tests/test_device_letterbox.py
  requires of the JAX predictors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_predict import _state

from yolo_from_scratch_tpu.data import letterbox as jax_lb
from yolo_from_scratch_tpu_torch.data import letterbox as lb
from yolo_from_scratch_tpu_torch.infer.predict import (
    BatchPredictor,
    Predictor,
    _stage_batch,
)
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.utils.convert import random_variables

CPU = torch.device("cpu")
TARGET = 128
# (h, w): shrinks both ways, grows both ways, shrinks one axis only
GEOMETRIES = ((480, 517), (37, 53), (60, 200), (700, 250))


def _arrays(seed=0):
    return [(np.random.default_rng(seed + i).random(hw + (3,)) * 255).astype(
        np.uint8) for i, hw in enumerate(GEOMETRIES)]


def test_staging_bit_equal_to_jax():
    for h, w in ((100, 100), (257, 512), (1080, 1920), (1024, 768), (1, 1),
                 (720, 1280)):
        assert lb.bucket_shape(h, w) == jax_lb.bucket_shape(h, w)
        assert lb.bucket_shape(h, w, 64, 32) == jax_lb.bucket_shape(h, w, 64,
                                                                    32)
        geom, *rest = lb.letterbox_geometry(w, h, 640)
        j_geom, *j_rest = jax_lb.letterbox_geometry(w, h, 640)
        assert geom.dtype == j_geom.dtype == np.float32
        np.testing.assert_array_equal(geom, j_geom)
        assert rest == j_rest
    for arr in _arrays():
        bucket = lb.bucket_shape(*arr.shape[:2])
        np.testing.assert_array_equal(lb.stage_to_bucket(arr, bucket),
                                      jax_lb.stage_to_bucket(arr, bucket))
    with pytest.raises(ValueError):
        lb.stage_to_bucket(np.zeros((300, 10, 3), np.uint8), (256, 256))


@pytest.fixture(scope="module")
def staged():
    """The four geometries in one shared bucket, as `_stage_batch` puts a
    batch: (arrays, bufs, geoms, scales)."""
    arrs = _arrays()
    return (arrs, *_stage_batch(arrs, TARGET))


def test_bucketed_matches_jax(staged):
    arrs, bufs, geoms, _ = staged
    assert bufs.shape == (4, 768, 768, 3)
    want = np.asarray(jax_lb.letterbox_device_bucketed(
        jnp.asarray(bufs), jnp.asarray(geoms), TARGET))
    got = lb.letterbox_device_bucketed(torch.from_numpy(bufs),
                                       torch.from_numpy(geoms), TARGET)
    assert got.shape == (4, TARGET, TARGET, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("index", range(len(GEOMETRIES)))
def test_letterbox_device_matches_jax(index):
    arr = _arrays()[index]
    h, w = arr.shape[:2]
    # in a buffer larger than the content, as the JAX function allows
    buf = lb.stage_to_bucket(arr, lb.bucket_shape(h, w))
    want = np.asarray(jax_lb.letterbox_device(jnp.asarray(buf), w, h, TARGET))
    got = lb.letterbox_device(torch.from_numpy(buf), w, h, TARGET)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        lb.letterbox_device(torch.from_numpy(arr), w + 1, h, TARGET)


def test_bucketed_within_lsb_of_pil(staged):
    arrs, bufs, geoms, _ = staged
    out = lb.letterbox_device_bucketed(torch.from_numpy(bufs),
                                       torch.from_numpy(geoms), TARGET).numpy()
    for i, arr in enumerate(arrs):
        host, _, pad_top, pad_left = lb.letterbox_image(Image.fromarray(arr),
                                                        TARGET)
        hostf = host.astype(np.float32) / 255.0
        _, _, _, new_w, new_h = lb.letterbox_params(arr.shape[1],
                                                    arr.shape[0], TARGET)
        pad = np.ones((TARGET, TARGET), bool)
        pad[pad_top:pad_top + new_h, pad_left:pad_left + new_w] = False
        assert pad.any()
        np.testing.assert_allclose(out[i][pad], hostf[pad], rtol=0, atol=1e-6)
        content = np.abs(out[i][~pad] - hostf[~pad])
        assert content.max() < 1.5 / 255.0, (GEOMETRIES[i], content.max())


@pytest.fixture(scope="module")
def variables(cfg):
    return random_variables(YOLO(cfg, device="meta"), seed=0)


def _assert_close_lists(a, b):
    """Same count, and a one-to-one match within rtol 0.05, atol 1 on
    (x1, y1, x2, y2, conf) with equal classes. Matched, not compared in
    order: random weights give many scores within ~1e-8 of each other,
    whose order an ulp of input moves."""
    assert len(a) == len(b)
    ga, gb = np.asarray(a, np.float64), np.asarray(b, np.float64)
    close = ((np.abs(ga[:, None, :5] - gb[None, :, :5])
              <= 1.0 + 0.05 * np.abs(gb[None, :, :5])).all(-1)
             & (ga[:, None, 5] == gb[None, :, 5]))
    free = np.ones(len(gb), bool)
    for i in range(len(ga)):
        j = np.flatnonzero(close[i] & free)
        assert len(j), f"{a[i]} has no counterpart"
        free[j[0]] = False


def test_batch_predictor_device_letterbox_matches_host(cfg, variables,
                                                       temp_dataset_dir):
    imgs = [str(p) for p in
            sorted((temp_dataset_dir / "val" / "images").glob("*.jpg"))[:2]]
    state = _state(cfg, variables)
    host = BatchPredictor(state, cfg, conf_threshold=1e-3, max_outputs=32,
                          device=CPU)(imgs)
    dev = BatchPredictor(state, cfg, conf_threshold=1e-3, max_outputs=32,
                         device_letterbox=True, device=CPU)(imgs)
    assert len(host) == len(dev) == 2
    for a, b in zip(host, dev):
        assert len(a) == 32
        _assert_close_lists(a, b)


def test_predictor_device_letterbox_matches_host(cfg, variables,
                                                 temp_dataset_dir):
    img = sorted((temp_dataset_dir / "val" / "images").glob("*.jpg"))[0]
    state = _state(cfg, variables)
    host = Predictor(state, cfg, conf_threshold=1e-3, max_outputs=32,
                     device=CPU)
    dev = Predictor(state, cfg, conf_threshold=1e-3, max_outputs=32,
                    device_letterbox=True, device=CPU)
    a = host(str(img))
    assert len(a) == 32
    _assert_close_lists(a, dev(str(img)))
    # an array needs no PIL on this path either
    arr = np.asarray(Image.open(img).convert("RGB"))
    _assert_close_lists(a, dev(arr))
