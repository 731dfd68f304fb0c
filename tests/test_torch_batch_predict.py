"""Batched and pipelined serving of the PyTorch port against the JAX
package and against the port's own single-image path, on the CPU.

The same seeded weights as tests/test_torch_predict.py (`served`: the
objectness bias raised by 4.6, so the default gate of 0.5 keeps about half
the predictions). Tolerances, and why:

- BatchPredictor vs the JAX BatchPredictor, images of mixed sizes: boxes
  1e-2 px, conf 1e-5, classes equal, same count, as the single-image
  end-to-end test (the forwards agree to ~1e-6; a pixel coordinate scales
  that by at most the image size over the letterbox scale).
- BatchPredictor at B=1 vs Predictor: equal. Both run the same forward at
  B=1 and the same plain NMS; the batch caps NMS at 300 kept boxes, and a
  greedy walk's first 300 do not depend on the cap.
- PipelinedPredictor vs Predictor: equal (the same program, in flight).
- the batch's pre-NMS candidates vs the JAX package's per-image top-k:
  scores 1e-6 (probabilities of magnitude <= 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_predict import _assert_same_detections, _state

from yolo_from_scratch_tpu.config import INV255
from yolo_from_scratch_tpu.data.letterbox import letterbox_image
from yolo_from_scratch_tpu.infer.predict import (
    BatchPredictor as JaxBatchPredictor,
)
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu.ops.decode import (
    decode_predictions as jax_decode,
)
from yolo_from_scratch_tpu_torch.infer.predict import (
    BatchPredictor,
    PipelinedPredictor,
    Predictor,
    default_topk,
    make_batch_postprocess,
)
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import nms_cuda
from yolo_from_scratch_tpu_torch.utils.convert import random_variables

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def served(cfg):
    """tests/test_torch_predict.py's `served` weights."""
    v = random_variables(YOLO(cfg, device="meta"), seed=0)
    for head in ("head_p3", "head_p4", "head_p5"):
        v["params"][head]["pred"]["bias"].reshape(3, -1)[:, 4] += 4.6
    return v


@pytest.fixture(scope="module")
def val_images(temp_dataset_dir):
    return [str(p) for p in
            sorted((temp_dataset_dir / "val" / "images").glob("*.jpg"))]


@pytest.fixture(scope="module")
def mixed_images(tmp_path_factory, val_images):
    """A 128x128 dataset image, the 60x200 rectangle of
    tests/test_torch_predict.py (scale 0.64, 45 px of padding on top) and a
    tall 150x90 one (scale 0.8533, padding at the sides)."""
    root = tmp_path_factory.mktemp("mixed")
    paths = [val_images[0]]
    for seed, hw in ((3, (60, 200)), (4, (150, 90))):
        rng = np.random.default_rng(seed)
        path = root / f"{hw[0]}x{hw[1]}.jpg"
        Image.fromarray((rng.random(hw + (3,)) * 255).astype(np.uint8)).save(
            path)
        paths.append(str(path))
    return paths


def test_batch_predictor_matches_jax_on_mixed_sizes(cfg, served,
                                                    mixed_images):
    want = JaxBatchPredictor(served, cfg)(mixed_images)
    nms_cuda.launches = 0
    got = BatchPredictor(_state(cfg, served), cfg, device=CPU)(mixed_images)
    assert nms_cuda.launches == 0  # CPU tensors take the plain version
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_same_detections(g, w)
        assert len(g) > 1


def test_batch_of_one_equals_predictor(cfg, served, val_images):
    state = _state(cfg, served)
    single = Predictor(state, cfg, device=CPU)(val_images[0])
    (batched,) = BatchPredictor(state, cfg, device=CPU)([val_images[0]])
    assert len(single) > 1
    assert batched == single[:300]


def test_batch_predictor_empty_at_a_high_gate(cfg, served, val_images):
    predictor = BatchPredictor(_state(cfg, served), cfg,
                               conf_threshold=0.999, device=CPU)
    assert predictor(val_images[:2]) == [[], []]


@pytest.fixture(scope="module")
def single_detections(cfg, served, val_images):
    predictor = Predictor(_state(cfg, served), cfg, device=CPU)
    return [predictor(p) for p in val_images]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipelined_predictor_equals_predictor(cfg, served, val_images,
                                              single_detections, depth):
    want = single_detections
    pipelined = PipelinedPredictor(_state(cfg, served), cfg, depth=depth,
                                   device=CPU)
    assert len(val_images) == 5
    assert pipelined(val_images) == want
    # incrementally: results leave the window once it holds `depth`
    first = pipelined.submit(val_images[0])
    assert first == []
    assert pipelined.drain() == want[:1]


def _jax_batch_top_scores(cfg, variables, imgs_u8, thr, k):
    """The JAX package's per-image NMS input scores of
    `make_batch_postprocess` (gate, then `lax.top_k`), nc=1."""

    @jax.jit
    def run(variables, imgs_u8):
        imgs = imgs_u8.astype(jnp.float32) * INV255
        preds = JaxYOLO(cfg).apply(variables, imgs, train=False)
        obj, cls = [], []
        for pred, anc in zip(preds, cfg.anchors_array):
            flat = jax_decode(pred, anc, cfg.img_size).reshape(
                imgs.shape[0], -1, 6)
            obj.append(jax.nn.sigmoid(flat[..., 4]))
            cls.append(jax.nn.sigmoid(flat[..., 5]))
        obj = jnp.concatenate(obj, axis=1)
        cls = jnp.concatenate(cls, axis=1)
        score = jnp.where(obj > thr, obj * cls, -1e30)
        return jax.lax.top_k(score, k)[0]

    return np.asarray(run(variables, jnp.asarray(imgs_u8)))


def test_batch_candidates_match_jax(cfg, served, mixed_images):
    thr = 0.5
    staged = [letterbox_image(Image.open(p).convert("RGB"), cfg.img_size)
              for p in mixed_images]
    imgs = np.stack([s[0] for s in staged])
    scales, pts, pls = (torch.tensor([s[i] for s in staged],
                                     dtype=torch.float32) for i in (1, 2, 3))
    k = default_topk(cfg.img_size)
    predictor = BatchPredictor(_state(cfg, served), cfg, device=CPU)
    post = make_batch_postprocess(predictor.model, cfg, thr)
    boxes, scores, classes = post.candidates(torch.from_numpy(imgs), scales,
                                             pts, pls)
    assert boxes.shape == (3, k, 4) and scores.shape == classes.shape == (3, k)
    assert not classes.any()
    want = _jax_batch_top_scores(cfg, served, imgs, thr, k)
    np.testing.assert_allclose(scores.numpy(), want, rtol=0, atol=1e-6)
    gated = scores > -1e29
    assert (0 < gated.sum(1)).all() and (gated.sum(1) < k).all()
    # descending per image, as the kernel's `presorted` needs
    assert (scores[:, 1:] <= scores[:, :-1]).all()
