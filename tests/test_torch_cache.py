"""The port's on-disk training cache (`yolo_from_scratch_tpu_torch/data/
cache.py`) against the JAX package's (`yolo_from_scratch_tpu/data/
cache.py`) on the same synthetic dataset: the files byte-equal, each
package opens the other's cache, a stale fingerprint rebuilds, and the
packed (space-to-depth) layout's files are byte-equal too."""

import os
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from yolo_from_scratch_tpu.data import cache as jcache
from yolo_from_scratch_tpu.data.dataset import YoloDataset as JaxDataset
from yolo_from_scratch_tpu.models import packed as jpk
from yolo_from_scratch_tpu_torch.data import cache as tcache
from yolo_from_scratch_tpu_torch.data.dataset import YoloDataset

FILES = ("images.u8", "labels.f32", "counts.i32", "meta.json")
IMG, K = 64, 8


def _datasets(split_dir):
    images = str(split_dir / "images")
    return (YoloDataset(images, 3, img_size=IMG, backend="pil"),
            JaxDataset(images, 3, img_size=IMG, backend="pil"))


@pytest.fixture(scope="module")
def caches(temp_dataset_multiclass, tmp_path_factory):
    """The same split cached by each package."""
    port_ds, jax_ds = _datasets(temp_dataset_multiclass / "train")
    root = tmp_path_factory.mktemp("caches")
    port = tcache.build_cache(port_ds, str(root / "port"), capacity=K,
                              batch=3, log=None)
    jax = jcache.build_cache(jax_ds, str(root / "jax"), capacity=K, batch=3,
                             log=None)
    return port_ds, port, jax


def test_files_are_byte_equal(caches):
    _, port, jax = caches
    for name in FILES:
        assert (Path(port.dir) / name).read_bytes() == \
            (Path(jax.dir) / name).read_bytes(), name
    assert port.images.shape == (4, IMG, IMG, 3)


def test_contents_are_the_datasets_compact_batch(caches):
    ds, port, _ = caches
    images, labels, counts = ds.load_batch_compact(range(len(ds)), K)
    np.testing.assert_array_equal(np.asarray(port.images), images)
    np.testing.assert_array_equal(port.labels, labels)
    np.testing.assert_array_equal(port.counts, counts)
    floats = ds.load_batch_compact([0], K, image_dtype="float32")[0]
    np.testing.assert_array_equal(floats, images[:1].astype(np.float32)
                                  * np.float32(1 / 255))


def test_each_package_opens_the_others_cache(caches):
    ds, port, jax = caches
    fp = tcache.dataset_fingerprint(ds.imgs)
    assert fp == jcache.dataset_fingerprint(ds.imgs)
    for opened, other in ((jcache.open_cache(port.dir, fingerprint=fp), port),
                          (tcache.open_cache(jax.dir, fingerprint=fp), jax)):
        assert opened is not None and len(opened) == len(other)
        np.testing.assert_array_equal(np.asarray(opened.images),
                                      np.asarray(other.images))
        np.testing.assert_array_equal(opened.labels, other.labels)
        np.testing.assert_array_equal(opened.counts, other.counts)
    assert tcache.open_cache(jax.dir, fingerprint="deadbeef") is None
    assert tcache.open_cache(str(Path(jax.dir) / "missing")) is None


def test_default_dir_is_the_jax_packages(caches):
    ds, _, _ = caches
    img_dir = str(Path(ds.imgs[0]).parent)
    assert tcache.cache_dir_for(img_dir, IMG, K) == jcache.cache_dir_for(
        img_dir, IMG, K, False)
    assert tcache.cache_dir_for(img_dir, IMG, K).endswith(
        f".yolo_tpu_cache_s{IMG}_k{K}_p1")


def test_stale_fingerprint_rebuilds(temp_dataset_multiclass, tmp_path):
    """A hit keeps the cache; touching an image changes the fingerprint and
    ensure_cache rebuilds (in the default directory beside the images)."""
    split = tmp_path / "train"
    shutil.copytree(temp_dataset_multiclass / "train", split)
    ds, _ = _datasets(split)
    c1 = tcache.ensure_cache(ds, capacity=K, log=None)
    assert Path(c1.dir) == split / f".yolo_tpu_cache_s{IMG}_k{K}_p1"
    mtime = os.stat(Path(c1.dir) / "images.u8").st_mtime_ns
    c2 = tcache.ensure_cache(ds, capacity=K, log=None)
    assert c2.meta == c1.meta
    assert os.stat(Path(c2.dir) / "images.u8").st_mtime_ns == mtime
    later = time.time() + 10
    os.utime(ds.imgs[0], (later, later))
    c3 = tcache.ensure_cache(ds, capacity=K, log=None)
    assert c3.meta["fingerprint"] != c1.meta["fingerprint"]
    assert c3.meta["fingerprint"] == tcache.dataset_fingerprint(ds.imgs)


def test_packed_raises(caches, tmp_path):
    """The packed cache (`packed=True`, the layout of a packed model): its
    files byte-equal to the JAX package's, in the JAX package's `_p4`
    directory, opened by `ensure_cache(packed=True)` alone; an empty
    dataset still raises."""
    ds, port, _ = caches
    jax_ds = JaxDataset(str(Path(ds.imgs[0]).parent), 3, img_size=IMG,
                        backend="pil")
    got = tcache.build_cache(ds, str(tmp_path / "p"), capacity=K,
                             packed=True, batch=3, log=None)
    want = jcache.build_cache(jax_ds, str(tmp_path / "j"), capacity=K,
                              packed=True, batch=3, log=None)
    for name in FILES:
        assert (Path(got.dir) / name).read_bytes() == \
            (Path(want.dir) / name).read_bytes(), name
    assert got.packed and got.images.shape == (4, IMG // 4, IMG // 4, 48)
    np.testing.assert_array_equal(
        np.asarray(got.images),
        jpk.pack_s2d_host(np.asarray(port.images)))
    img_dir = str(Path(ds.imgs[0]).parent)
    assert tcache.cache_dir_for(img_dir, IMG, K, packed=True) == \
        jcache.cache_dir_for(img_dir, IMG, K, True)
    assert tcache.cache_dir_for(img_dir, IMG, K, packed=True).endswith("_p4")
    # each layout opens only its own cache
    assert tcache.open_cache(got.dir, packed=False) is None
    assert tcache.open_cache(port.dir, packed=True) is None
    assert tcache.open_cache(got.dir, packed=True).packed
    with pytest.raises(ValueError, match="empty"):
        tcache.build_cache(ds.__class__(str(tmp_path), 3, img_size=IMG),
                           str(tmp_path / "e"), log=None)
