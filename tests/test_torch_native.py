"""The port's native loader (`yolo_from_scratch_tpu_torch/native/`,
`yolodata.cc` built into build/torch_native/) against the JAX package's
(`yolo_from_scratch_tpu/native/`), on the CPU.

Both libraries are the same source built with the same flags on this
machine, so every comparison with the JAX package's native path is bit
for bit: the decoded canvases, scales and pads, the failure counts, the
dataset's batches (dense targets, compact labels as uint8 and float32) and
the on-disk cache. Against PIL the native path is exact only without a
resize on a lossless file (PNG at scale 1); with a resize the two filters
differ, held to the JAX test's bound (mean absolute difference < 0.02,
`tests/test_native_loader.py`), the geometry and targets equal.
"""

import io
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from yolo_from_scratch_tpu import native as jax_native
from yolo_from_scratch_tpu.data import cache as jax_cache
from yolo_from_scratch_tpu.data.dataset import YoloDataset as JaxDataset
from yolo_from_scratch_tpu_torch import native
from yolo_from_scratch_tpu_torch.data import cache as port_cache
from yolo_from_scratch_tpu_torch.data.dataset import YoloDataset

IMG = 64
# (name, height, width, PIL mode, suffix)
IMAGES = (("rgb_jpeg", 48, 80, "RGB", "jpg"),
          ("rgb_png", 61, 47, "RGB", "png"),
          ("gray_png", 40, 90, "L", "png"),
          ("palette_png", 33, 70, "P", "png"),
          ("rgba_png", 77, 52, "RGBA", "png"),
          ("gray16_png", 50, 45, "I;16", "png"),
          ("tall_jpeg", 300, 1, "RGB", "jpg"),
          ("wide_png", 1, 300, "RGB", "png"),
          ("odd_jpeg", 97, 211, "RGB", "jpg"),
          ("same_png", IMG, IMG, "RGB", "png"))


@pytest.fixture(autouse=True, scope="module")
def _jax_library_builds():
    """The JAX package's library is the reference (decided here, at run
    time, not while the module is imported)."""
    if not jax_native.available():
        pytest.skip("the JAX package's native loader does not build here")


def _write(path, h, w, mode, rng):
    if mode == "I;16":
        img = Image.fromarray(rng.integers(0, 65536, (h, w), dtype=np.uint16))
    else:
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        img = img.convert(mode) if mode != "P" else img.quantize(16)
    img.save(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The image files of IMAGES, a missing path and a corrupt file."""
    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    paths = []
    for name, h, w, mode, suffix in IMAGES:
        paths.append(root / f"{name}.{suffix}")
        _write(paths[-1], h, w, mode, rng)
    corrupt = root / "corrupt.jpg"
    corrupt.write_bytes(b"\xff\xd8\xff\xe0" + bytes(rng.integers(
        0, 256, 200, dtype=np.uint8)))
    return [str(p) for p in paths] + [str(root / "missing.jpg"),
                                      str(corrupt)]


@pytest.mark.parametrize("target", [64, 96])
def test_library_bit_equal_to_jax(files, target):
    got = native.decode_letterbox_batch(files, target)
    want = jax_native.decode_letterbox_batch(files, target)
    for g, w in zip(got[:4], want[:4], strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # the missing and the corrupt file: gray slots, scale 0, counted
    assert got[4] == want[4] == 2
    assert (got[1][-2:] == 0).all() and (got[1][:-2] > 0).all()
    np.testing.assert_array_equal(got[0][-2:], np.float32(114.0 / 255.0))
    # the 1x300 and 300x1 images keep a 1-pixel side, not 0
    assert got[0].shape == (len(files), target, target, 3)


def test_threads_bit_equal(files):
    one = native.decode_letterbox_batch(files, IMG, n_threads=1)
    four = native.decode_letterbox_batch(files, IMG, n_threads=4)
    for a, b in zip(one, four, strict=True):
        np.testing.assert_array_equal(a, b)


def test_png_at_scale_one_bit_equal_to_pil(files):
    """No resample on a lossless file: the native path equals PIL's."""
    same = [p for p in files if "same_png" in p]
    img = native.decode_letterbox_batch(same, IMG)[0][0]
    pil = np.asarray(Image.open(same[0]).convert("RGB"), np.float32)
    np.testing.assert_array_equal(img, pil * np.float32(1.0 / 255.0))


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """An images/labels split of resized JPEGs and PNGs, nc=3."""
    root = tmp_path_factory.mktemp("native_split")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(1)
    for i, (h, w) in enumerate([(48, 80), (100, 70), (64, 64), (33, 120),
                                (90, 90)]):
        suffix = "png" if i % 2 else "jpg"
        _write(root / "images" / f"{i}.{suffix}", h, w, "RGB", rng)
        rows = [f"{int(rng.integers(0, 3))} {rng.uniform(0.3, 0.7):.4f} "
                f"{rng.uniform(0.3, 0.7):.4f} {rng.uniform(0.1, 0.4):.4f} "
                f"{rng.uniform(0.1, 0.4):.4f}" for _ in range(1 + i % 3)]
        (root / "labels" / f"{i}.txt").write_text("\n".join(rows) + "\n")
    return str(root / "images")


@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
def test_load_batch_bit_equal_to_jax(split, head):
    port = YoloDataset(split, 3, img_size=IMG, backend="native",
                       head_type=head)
    jds = JaxDataset(split, 3, img_size=IMG, backend="native",
                     head_type=head)
    got, want = port.load_batch([4, 0, 2, 1]), jds.load_batch([4, 0, 2, 1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.float32
    for g, w in zip(got[1], want[1], strict=True):
        np.testing.assert_array_equal(g, w)
    assert sum(float(t.sum()) for t in got[1]) > 0


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_load_batch_compact_bit_equal_to_jax(split, dtype):
    port = YoloDataset(split, 3, img_size=IMG, backend="native")
    jds = JaxDataset(split, 3, img_size=IMG, backend="native")
    got = port.load_batch_compact([3, 1, 0], capacity=4, image_dtype=dtype)
    want = jds.load_batch_compact([3, 1, 0], capacity=4, image_dtype=dtype)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.dtype(dtype)


def test_native_against_pil_geometry_and_bound(split):
    """Resized images: within the JAX test's bound of PIL; the targets
    (integer geometry) equal."""
    nat = YoloDataset(split, 3, img_size=IMG, backend="native")
    pil = YoloDataset(split, 3, img_size=IMG, backend="pil")
    (imgs_n, tgts_n), (imgs_p, tgts_p) = (nat.load_batch(range(5)),
                                          pil.load_batch(range(5)))
    assert np.abs(imgs_n - imgs_p).mean() < 0.02
    for a, b in zip(tgts_n, tgts_p, strict=True):
        np.testing.assert_array_equal(a, b)


def test_auto_resolves_as_jax(split):
    port = YoloDataset(split, 3, img_size=IMG)
    jds = JaxDataset(split, 3, img_size=IMG)
    assert port.backend == jds.backend == "native"
    assert YoloDataset(split, backend="pil").backend == "pil"


def test_both_caches_hold_the_same_bytes(split, tmp_path):
    """With `auto` resolving to native, both packages' caches are built
    through the native loader and hold the same files."""
    port = port_cache.build_cache(YoloDataset(split, 3, img_size=IMG),
                                  str(tmp_path / "port"), capacity=4,
                                  batch=2, log=None)
    jax = jax_cache.build_cache(JaxDataset(split, 3, img_size=IMG),
                                str(tmp_path / "jax"), capacity=4, batch=2,
                                log=None)
    for name in ("images.u8", "labels.f32", "counts.i32"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    assert len(port) == len(jax) == 5


BUILD_AND_DECODE = """
import sys
import numpy as np
from yolo_from_scratch_tpu_torch import native
native._lib = native.load(native.build(sys.argv[1]))
out = native.decode_letterbox_batch(sys.argv[2:], 64)
np.save(sys.stdout.buffer, out[0])
"""


def test_concurrent_builds_both_load(files, tmp_path):
    """Two processes building into one empty directory at once: the lock
    and the rename leave one library both load, and both decode as the
    process's own library does."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_DECODE,
                               str(tmp_path), *files[:3]],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(2)]
    want = native.decode_letterbox_batch(files[:3], 64)[0]
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=240)
        finally:
            proc.kill()
        assert proc.returncode == 0, err.decode()
        np.testing.assert_array_equal(np.load(io.BytesIO(out)), want)
    built = sorted(p.name for p in tmp_path.iterdir())
    assert built == ["build.lock", native.library_path().name]


def test_failed_build_keeps_stderr(tmp_path, monkeypatch, split):
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-include", "no_such_header.h"))
    with pytest.raises(RuntimeError, match="no_such_header.h"):
        native.build(tmp_path)
    assert not list(tmp_path.glob("*.so"))
    # the process's library: unavailable, and the native backend raises
    # with the compiler's message at its first batch
    real_build = native.build
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "build", lambda: real_build(tmp_path))
    assert not native.available()
    assert YoloDataset(split, 3, img_size=IMG).backend == "pil"
    ds = YoloDataset(split, 3, img_size=IMG, backend="native")
    with pytest.raises(RuntimeError, match="no_such_header.h"):
        ds.load_batch([0])
