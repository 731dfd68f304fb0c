"""Serving path of the PyTorch port against the JAX package, on the CPU.

Same seeded numpy weights (flax layout) and the same conftest dataset
image in both packages. Tolerances, and why:

- decode: 1e-6 absolute. Elementwise float32 on values of magnitude <= ~2;
  XLA may strength-reduce a divide by the grid size to a reciprocal
  multiply, an ulp or two away.
- pre-NMS candidates: corners 1e-3 px, probabilities 1e-6. The two
  forwards agree to ~1e-6 on the logits (tests/test_torch_model.py); a
  pixel coordinate multiplies that error by at most the image size.
- NMS on the same candidates: bit-equal (see tests/test_torch_nms.py).
- end-to-end detections: boxes 1e-2 px, conf 1e-5, classes equal, same
  count. A count mismatch could only come from a score within ~1e-6 of the
  gate or an IoU within ~1e-6 of the NMS threshold; the message says so.
"""

import os
import re
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from yolo_from_scratch_tpu.config import INV255
from yolo_from_scratch_tpu.data.letterbox import letterbox_image
from yolo_from_scratch_tpu.infer.predict import Predictor as JaxPredictor
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu.ops import nms as jnms
from yolo_from_scratch_tpu.ops.decode import (
    decode_predictions as jax_decode,
)
from yolo_from_scratch_tpu.utils.checkpoint import save_checkpoint
from yolo_from_scratch_tpu_torch.infer.predict import (
    Predictor,
    default_topk,
    letterbox_input,
)
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import nms as tnms
from yolo_from_scratch_tpu_torch.ops.decode import decode_predictions
from yolo_from_scratch_tpu_torch.utils.checkpoint import load_checkpoint
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)

REPO_ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
COUNT_NOTE = ("detection counts differ: check for a score within ~1e-6 of "
              "the gate or an IoU within ~1e-6 of the NMS threshold")


@pytest.fixture(scope="module")
def variables(cfg):
    return random_variables(YOLO(cfg, device="meta"), seed=0)


@pytest.fixture(scope="module")
def served(cfg, variables):
    """Weights whose objectness sits near 0.5 (the head's obj bias raised
    by 4.6), so the CLI's default gate of 0.5 keeps about half the
    predictions and the end-to-end lists are long."""
    params = jax.tree_util.tree_map(np.copy, variables)
    for head in ("head_p3", "head_p4", "head_p5"):
        bias = params["params"][head]["pred"]["bias"].reshape(3, -1)
        bias[:, 4] += np.float32(4.6)
    return params


@pytest.fixture(scope="module")
def sample_image(temp_dataset_dir):
    return str(sorted((temp_dataset_dir / "val" / "images").glob("*.jpg"))[0])


def _state(cfg, variables):
    return from_flax_variables(variables, YOLO(cfg, device="meta"))


def test_default_topk():
    assert default_topk(640) == 4096
    assert default_topk(128) == 3 * (16 * 16 + 8 * 8 + 4 * 4)


def test_decode_matches_jax(default_anchors):
    raw = np.random.default_rng(0).normal(size=(2, 8, 6, 3, 7)).astype(
        np.float32)
    for anc in default_anchors:
        expected = np.asarray(jax_decode(jnp.asarray(raw), anc, 256))
        got = decode_predictions(torch.from_numpy(raw), anc, 256).numpy()
        np.testing.assert_allclose(got, expected, rtol=0, atol=1e-6)


def _jax_decode_all(cfg, variables, img_u8):
    """JAX counterpart of the port's `postprocess.decode`: the lines of
    `yolo_from_scratch_tpu/infer/predict.py` before the gate, at scale 1
    and no padding (an S x S image), as one jitted program."""

    @jax.jit
    def run(variables, img_u8):
        img = img_u8[None].astype(jnp.float32) * INV255
        preds = JaxYOLO(cfg).apply(variables, img, train=False)
        boxes, obj, cls = [], [], []
        for pred, anc in zip(preds, cfg.anchors_array):
            flat = jax_decode(pred, anc, cfg.img_size).reshape(-1, 5 + 1)
            boxes.append(flat[:, 0:4])
            obj.append(jax.nn.sigmoid(flat[:, 4]))
            cls.append(jax.nn.sigmoid(flat[:, 5]))
        b = jnp.concatenate(boxes) * cfg.img_size
        cx, cy, w, h = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        corners = jnp.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                            1)
        return corners, jnp.concatenate(obj), jnp.concatenate(cls)

    return tuple(np.asarray(a) for a in run(variables, jnp.asarray(img_u8)))


def test_candidates_match_and_nms_on_them_bit_equal(cfg, variables,
                                                    sample_image):
    thr = 1e-2
    img_u8, scale, pad_top, pad_left = letterbox_image(
        Image.open(sample_image).convert("RGB"), cfg.img_size)
    assert (scale, pad_top, pad_left) == (1.0, 0, 0)

    predictor = Predictor(_state(cfg, variables), cfg, conf_threshold=thr,
                          device=CPU)
    args = predictor.stage(sample_image)
    corners, obj, cls_prob, cls_id = (
        t.numpy() for t in predictor.postprocess.decode(*args))
    j_corners, j_obj, j_cls = _jax_decode_all(cfg, variables, img_u8)
    np.testing.assert_allclose(corners, j_corners, rtol=0, atol=1e-3)
    np.testing.assert_allclose(obj, j_obj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cls_prob, j_cls, rtol=0, atol=1e-6)
    assert not cls_id.any()
    gated = obj > thr
    assert 0 < gated.sum() < len(obj)  # the gate does cut at this seed
    near = np.abs(j_obj - thr) < 1e-5
    np.testing.assert_array_equal(gated[~near], (j_obj > thr)[~near])

    boxes, scores, classes = (t.numpy() for t in
                              predictor.postprocess.candidates(*args))
    k = default_topk(cfg.img_size)
    assert boxes.shape == (k, 4) and scores.shape == classes.shape == (k,)
    j_score = np.where(j_obj > thr, j_obj * j_cls, tnms.NEG_INF)
    j_top = np.asarray(jax.lax.top_k(jnp.asarray(j_score), k)[0])
    np.testing.assert_allclose(scores, j_top, rtol=0, atol=1e-6)

    # both packages' NMS on the SAME candidates: bit-equal
    cand = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes))
    expected = jnms.batched_nms_fixed(*cand, 0.4, k)
    got = tnms.batched_nms_fixed(*(torch.from_numpy(c) for c in
                                   (boxes, scores, classes)), 0.4, k,
                                 presorted=True)
    for g, e in zip(got, expected):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    assert got[3].sum() > 1  # NMS kept several boxes


@pytest.fixture(scope="module")
def jax_predictor(cfg, served):
    return JaxPredictor(served, cfg)


@pytest.fixture(scope="module")
def jax_detections(jax_predictor, sample_image):
    dets = jax_predictor(sample_image)
    assert dets, "the raised objectness bias must give detections"
    return dets


def _assert_same_detections(got, expected, box_tol=1e-2, conf_tol=1e-5):
    """Same count, and a one-to-one match within the tolerances. Matching
    rather than comparing in order: detections whose confidences lie within
    the tolerance of each other may come out in either order."""
    assert len(got) == len(expected), COUNT_NOTE
    g, e = np.asarray(got, np.float64), np.asarray(expected, np.float64)
    close = ((np.abs(g[:, None, :4] - e[None, :, :4]) <= box_tol).all(-1)
             & (np.abs(g[:, None, 4] - e[None, :, 4]) <= conf_tol)
             & (g[:, None, 5] == e[None, :, 5]))
    free = np.ones(len(e), bool)
    for i in range(len(g)):
        j = np.flatnonzero(close[i] & free)
        assert len(j), f"port detection {got[i]} has no JAX counterpart"
        free[j[0]] = False


def test_end_to_end_detections_match_jax(cfg, served, sample_image,
                                         jax_detections):
    got = Predictor(_state(cfg, served), cfg, device=CPU)(sample_image)
    _assert_same_detections(got, jax_detections)
    assert len(got) > 1


def test_rect_image_unletterbox_matches_jax(cfg, served, jax_predictor,
                                            tmp_path):
    """A 60x200 image: letterbox scale 0.64 and 45 px of padding on top,
    undone in the port's postprocess as in the JAX package's."""
    path = tmp_path / "rect.jpg"
    rng = np.random.default_rng(3)
    Image.fromarray((rng.random((60, 200, 3)) * 255).astype(np.uint8)).save(
        path)
    predictor = Predictor(_state(cfg, served), cfg, device=CPU)
    _, scale, pad_top, pad_left = predictor.stage(str(path))
    assert (scale, pad_top, pad_left) == (0.64, 45.0, 0.0)
    got = predictor(str(path))
    _assert_same_detections(got, jax_predictor(str(path)))
    assert len(got) > 1


def test_array_input_needs_no_letterbox(cfg, served, sample_image):
    img_u8, *_ = letterbox_image(Image.open(sample_image).convert("RGB"),
                                 cfg.img_size)
    staged, scale, pad_top, pad_left = letterbox_input(img_u8, cfg.img_size)
    assert staged is img_u8 and (scale, pad_top, pad_left) == (1.0, 0, 0)
    predictor = Predictor(_state(cfg, served), cfg, device=CPU)
    assert predictor(img_u8) == predictor(sample_image)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory, cfg, served):
    path = tmp_path_factory.mktemp("torch_ckpt") / "served.ckpt"
    save_checkpoint(path, served, cfg, epoch=3)
    return path


def test_jax_checkpoint_loads_and_serves(cfg, served, jax_checkpoint,
                                         sample_image, jax_detections):
    state, cfg2, meta = load_checkpoint(jax_checkpoint)
    assert asdict(cfg2) == asdict(cfg)
    assert meta["epoch"] == 3 and meta["version"] == 1
    for key, t in _state(cfg, served).items():
        torch.testing.assert_close(state[key], t, rtol=0, atol=0)
    _assert_same_detections(Predictor(state, cfg2, device=CPU)(sample_image),
                            jax_detections)


def _run_port_cli(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", "yolo_from_scratch_tpu_torch", *args],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT, env=env)


def test_cli_inference_stdout_matches_jax(jax_checkpoint, sample_image,
                                          jax_detections):
    result = _run_port_cli([sample_image, str(jax_checkpoint),
                            "--device", "cpu"])
    assert result.returncode == 0, result.stderr
    out = result.stdout.splitlines()
    n = len(jax_detections)
    assert out[:2] == [f"Running inference on {sample_image}",
                       f"Model: {jax_checkpoint}, Classes: 1, Image size: 128"]
    assert out[2:4] == ["", f"Detected {n} object(s):"]
    pattern = re.compile(r"  (\d+)\. Box: \((.+), (.+), (.+), (.+)\), "
                         r"Confidence: (.+), Class: (\d+)")
    rows = [pattern.fullmatch(line).groups() for line in out[4:]]
    assert [int(r[0]) for r in rows] == list(range(1, n + 1))
    # the printed values round to 0.1 px and 0.001: the tolerances widen
    # by half of that
    _assert_same_detections([tuple(map(float, r[1:])) for r in rows],
                            jax_detections, box_tol=0.05 + 1e-2,
                            conf_tol=0.0005 + 1e-5)


def test_cli_inspect_and_unported_modes(jax_checkpoint, cfg):
    result = _run_port_cli([str(jax_checkpoint)])
    assert result.returncode == 0, result.stderr
    n = sum(p.numel() for p in YOLO(cfg, device="meta").parameters())
    assert f"Total parameters: {n:,}" in result.stdout
    assert "Model architecture:" in result.stdout
    # training, evaluation, --compute-anchors and data-parallel training
    # are ported (tests/test_torch_eval.py, tests/test_torch_anchors.py,
    # tests/test_torch_parallel.py), as are spatial partitioning
    # (tests/test_torch_spatial.py) and tensor parallelism
    # (tests/test_torch_tensor_parallel.py): --model-parallel without
    # --data-parallel exits 1 with the JAX CLI's line
    result = _run_port_cli(["data.yaml", "--model-parallel", "2"])
    assert result.returncode == 1
    assert ("--spatial/--model-parallel require --data-parallel"
            in result.stdout)


def test_train_torch_script_and_device_letterbox_inference(
        jax_checkpoint, sample_image, jax_detections):
    """`python train_torch.py` is the port's CLI: it inspects a checkpoint,
    and serves an image with the letterbox on the device."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    result = subprocess.run(
        [sys.executable, "train_torch.py", str(jax_checkpoint)],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT, env=env)
    assert result.returncode == 0, result.stderr
    assert result.stdout.startswith(f"Model loaded from {jax_checkpoint}\n")
    assert "Total parameters: " in result.stdout
    result = _run_port_cli([sample_image, str(jax_checkpoint), "--device",
                            "cpu", "--device-letterbox"])
    assert result.returncode == 0, result.stderr
    # a 128x128 image: the device letterbox is the identity up to an ulp
    assert f"Detected {len(jax_detections)} object(s):" in result.stdout
