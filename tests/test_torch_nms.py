"""NMS of the PyTorch port against the JAX package, on the CPU.

The port's plain versions (`yolo_from_scratch_tpu_torch/ops/nms.py`) are
the oracles of its CUDA kernel; here they are held against the JAX lax
oracle and the Pallas kernel in interpret mode, on the same numpy inputs.
Keep masks and NMS outputs must be BIT-EQUAL (no tolerance): both sides
compute each IoU with unfused float32 ops in the same order. A mismatch
can only come from an IoU within one ulp of the threshold (jitted XLA on
the CPU may round an IoU an ulp differently), and the assertion message
says so rather than the test loosening.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu.ops import nms as jnms
from yolo_from_scratch_tpu.ops.nms_pallas import (
    batched_nms_fixed_pallas,
    batched_nms_fixed_pallas_images,
    nms_keep_mask_pallas,
    nms_keep_mask_pallas_batched,
)
from yolo_from_scratch_tpu_torch.ops import nms as tnms
from yolo_from_scratch_tpu_torch.ops import nms_cuda

ULP_NOTE = ("keep masks differ: check for an IoU within one float32 ulp of "
            "the threshold before suspecting the port")


def _random_boxes(seed, n, spread=60):
    """The box generator of tests/test_nms_pallas.py."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, spread, (n, 2))
    wh = rng.uniform(5, 40, (n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    return boxes, scores


def _tied(seed, n):
    """Clustered boxes whose scores take only 5 values: many exact ties."""
    boxes, _ = _random_boxes(seed, n, spread=30)
    rng = np.random.default_rng(seed + 100)
    scores = rng.choice(np.float32([0.9, 0.7, 0.5, 0.3, 0.1]), n)
    return boxes, scores.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_keep(boxes, scores, thr, max_keep=None):
    return np.asarray(jnms.nms_keep_mask(jnp.asarray(boxes),
                                         jnp.asarray(scores), thr,
                                         max_keep=max_keep))


@pytest.mark.parametrize("make", [_random_boxes, _tied])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [17, 128, 300])
def test_keep_mask_matches_jax_oracle_and_pallas(make, seed, n):
    boxes, scores = make(seed, n)
    expected = _jax_keep(boxes, scores, 0.5)
    pallas = np.asarray(nms_keep_mask_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5, interpret=True))
    got = tnms.nms_keep_mask(_t(boxes), _t(scores), 0.5).numpy()
    np.testing.assert_array_equal(got, expected, err_msg=ULP_NOTE)
    np.testing.assert_array_equal(got, pallas, err_msg=ULP_NOTE)


def test_padding_rows_never_kept():
    boxes, scores = _random_boxes(0, 32)
    scores[10:] = tnms.NEG_INF
    got = tnms.nms_keep_mask(_t(boxes), _t(scores), 0.5).numpy()
    assert not got[10:].any()
    np.testing.assert_array_equal(got, _jax_keep(boxes, scores, 0.5))


@pytest.mark.parametrize("max_keep", [1, 5, 16])
def test_max_keep_cap(max_keep):
    # widely separated boxes: nothing suppressed, the cap must truncate
    boxes = np.zeros((16, 4), np.float32)
    for i in range(16):
        boxes[i] = [i * 100, 0, i * 100 + 10, 10]
    scores = np.linspace(1.0, 0.1, 16).astype(np.float32)
    got = tnms.nms_keep_mask(_t(boxes), _t(scores), 0.5,
                             max_keep=max_keep).numpy()
    assert got.sum() == max_keep and got[:max_keep].all()
    np.testing.assert_array_equal(
        got, _jax_keep(boxes, scores, 0.5, max_keep=max_keep))


def test_max_keep_with_suppression_matches_jax():
    boxes, scores = _tied(3, 300)
    got = tnms.nms_keep_mask(_t(boxes), _t(scores), 0.4, max_keep=7).numpy()
    np.testing.assert_array_equal(got, _jax_keep(boxes, scores, 0.4, 7),
                                  err_msg=ULP_NOTE)


def _batch(seeds, n, make=_random_boxes):
    boxes = np.stack([make(s, n)[0] for s in seeds])
    scores = np.stack([make(s, n)[1] for s in seeds])
    return boxes, scores


@pytest.mark.parametrize("presorted", [False, True])
def test_batched_keep_mask_matches_pallas_grid(presorted):
    boxes, scores = _batch(range(5), 200)
    scores[2, 150:] = tnms.NEG_INF  # one image with padding rows
    if presorted:
        order = np.argsort(-scores, axis=1, kind="stable")
        boxes = np.take_along_axis(boxes, order[..., None], axis=1)
        scores = np.take_along_axis(scores, order, axis=1)
    expected = np.asarray(nms_keep_mask_pallas_batched(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5, interpret=True,
        presorted=presorted))
    got = tnms.nms_keep_mask(_t(boxes), _t(scores), 0.5,
                             presorted=presorted).numpy()
    np.testing.assert_array_equal(got, expected, err_msg=ULP_NOTE)
    for i in range(len(boxes)):  # and per image against the lax oracle
        np.testing.assert_array_equal(got[i],
                                      _jax_keep(boxes[i], scores[i], 0.5))


def test_class_offset_boxes_matches_jax():
    boxes, _ = _random_boxes(5, 50)
    boxes[3, 2] = np.inf  # non-finite coordinates are ignored for the scale
    classes = np.random.default_rng(5).integers(0, 4, 50).astype(np.int32)
    expected = np.asarray(jnms._class_offset_boxes(jnp.asarray(boxes),
                                                   jnp.asarray(classes)))
    got = tnms._class_offset_boxes(_t(boxes), _t(classes)).numpy()
    np.testing.assert_array_equal(got, expected)
    # batched: one offset scale per image, as vmap gives
    bb = np.stack([boxes, boxes * 2])
    cc = np.stack([classes, classes[::-1].copy()])
    got_b = tnms._class_offset_boxes(_t(bb), _t(cc)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got_b[i], np.asarray(
            jnms._class_offset_boxes(jnp.asarray(bb[i]), jnp.asarray(cc[i]))))


@pytest.mark.parametrize("make", [_random_boxes, _tied])
@pytest.mark.parametrize("n,max_outputs,ncls", [(200, 64, 3), (160, 160, 1),
                                                 (300, 32, 4)])
def test_batched_nms_fixed_matches_jax_and_pallas(make, n, max_outputs, ncls):
    boxes, scores = make(4, n)
    scores[n - 20:] = tnms.NEG_INF
    classes = np.random.default_rng(4).integers(0, ncls, n).astype(np.int32)
    args = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes))
    expected = jnms.batched_nms_fixed(*args, 0.4, max_outputs=max_outputs)
    pallas = batched_nms_fixed_pallas(*args, 0.4, max_outputs=max_outputs,
                                      interpret=True)
    got = tnms.batched_nms_fixed(_t(boxes), _t(scores), _t(classes), 0.4,
                                 max_outputs)
    for g, e, p in zip(got, expected, pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e),
                                      err_msg=ULP_NOTE)
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))


def test_cuda_wrapper_on_cpu_runs_plain_and_counts_nothing():
    before = nms_cuda.launches
    boxes, scores = _batch(range(10, 13), 160, _tied)
    classes = np.random.default_rng(7).integers(0, 4, (3, 160)).astype(
        np.int32)
    got = nms_cuda.batched_nms_fixed_cuda_images(
        _t(boxes), _t(scores), _t(classes), 0.4, max_outputs=32)
    expected = batched_nms_fixed_pallas_images(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), 0.4,
        max_outputs=32, interpret=True)
    for g, e in zip(got, expected):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e),
                                      err_msg=ULP_NOTE)
    keep = nms_cuda.nms_keep_mask_batched(_t(boxes), _t(scores), 0.5)
    np.testing.assert_array_equal(
        keep.numpy(), tnms.nms_keep_mask(_t(boxes), _t(scores), 0.5).numpy())
    single = nms_cuda.batched_nms_fixed_cuda(
        _t(boxes[0]), _t(scores[0]), _t(classes[0]), 0.4, 32)
    for g, e in zip(single, (x[0] for x in got)):
        np.testing.assert_array_equal(g.numpy(), e.numpy())
    assert nms_cuda.launches == before


def test_cuda_wrapper_refuses_other_devices():
    boxes = torch.zeros((1, 8, 4), device="meta")
    scores = torch.zeros((1, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        nms_cuda.nms_keep_mask_batched(boxes, scores, 0.5)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises (it never falls back to the plain NMS)."""
    from yolo_from_scratch_tpu_torch.kernels import build

    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    if build.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this host has a CUDA toolkit at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
