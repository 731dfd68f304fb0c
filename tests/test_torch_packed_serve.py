"""Serving under the packed layouts, and `approx_topk`: the PyTorch port
against the JAX package, on the CPU.

A packed `Predictor` and `BatchPredictor` (the host packs each letterboxed
image) against the JAX package's packed predictors on the same weights:
NMS keep masks bit for bit, the kept boxes within 1e-3 px and scores within
1e-5. Behind the device letterbox the port serves the unpacked model on the
same weights, as the JAX package does. `approx_topk=True` selects the exact
top-k, which is what the JAX package computes off the TPU
(`lax.approx_max_k` equals `lax.top_k` on the CPU). The packed int8
predictor and the packed export run on the packed model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_predict import _assert_same_detections

from yolo_from_scratch_tpu.infer.predict import (
    BatchPredictor as JaxBatchPredictor,
)
from yolo_from_scratch_tpu.infer.predict import Predictor as JaxPredictor
from yolo_from_scratch_tpu_torch.infer.predict import (
    BatchPredictor,
    Predictor,
)
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)

CPU = torch.device("cpu")
P3 = dict(packed_stem=True, packed_interior=True, packed_p3=True)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Six test workers share the cores: torch's default threads would
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served(cfg):
    """tests/test_torch_predict.py's weights: objectness near 0.5."""
    v = random_variables(YOLO(cfg, device="meta"), seed=0)
    for head in ("head_p3", "head_p4", "head_p5"):
        v["params"][head]["pred"]["bias"].reshape(3, -1)[:, 4] += 4.6
    return v


@pytest.fixture(scope="module")
def images(temp_dataset_dir):
    return [str(p) for p in
            sorted((temp_dataset_dir / "val" / "images").glob("*.jpg"))][:3]


def _state(cfg, variables):
    return from_flax_variables(variables, YOLO(cfg, device="meta"))


def _assert_same_outputs(got, want):
    """(boxes, scores, classes, valid) of a postprocess: the keep masks
    bit for bit, the kept detections matched one to one within 1e-3 px and
    1e-5 (scores within 1e-5 of each other may come out in either
    order)."""
    got, want = ([np.asarray(t) for t in out] for out in (got, want))
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3].sum() > 1
    if got[3].ndim == 1:  # one image
        got, want = ([t[None] for t in out] for out in (got, want))
    for i in range(len(got[3])):
        dets = [[(*b, s, c) for b, s, c, v in zip(*(t[i] for t in out)) if v]
                for out in (got, want)]
        _assert_same_detections(*dets, box_tol=1e-3)


@pytest.mark.parametrize("layout", [dict(packed_stem=True), P3])
def test_packed_predictor_matches_jax(cfg, served, images, layout):
    pcfg = cfg.with_(**layout)
    port = Predictor(_state(pcfg, served), pcfg, device=CPU)
    ref = JaxPredictor(served, pcfg)
    args = port.stage(images[0])
    assert tuple(args[0].shape) == (1, cfg.img_size // 4, cfg.img_size // 4,
                                    48)
    want = ref._post(served, jnp.asarray(args[0].numpy()), *args[1:])
    _assert_same_outputs([t.numpy() for t in port.postprocess(*args)], want)
    _assert_same_detections(port(images[0]), ref(images[0]))


def test_packed_batch_predictor_matches_jax(cfg, served, images):
    pcfg = cfg.with_(**P3)
    port = BatchPredictor(_state(pcfg, served), pcfg, device=CPU)
    ref = JaxBatchPredictor(served, pcfg)
    args = port.stage(images)
    want = ref._post(served, *(jnp.asarray(a.numpy()) for a in args))
    _assert_same_outputs([t.numpy() for t in port.postprocess(*args)], want)
    for g, w in zip(port(images), ref(images)):
        _assert_same_detections(g, w)


def test_packed_device_letterbox_serves_the_unpacked_model(cfg, served,
                                                           images):
    state = _state(cfg, served)
    pcfg = cfg.with_(**P3)
    for cls in (Predictor, BatchPredictor):
        got = cls(state, pcfg, device=CPU, device_letterbox=True)
        want = cls(state, cfg, device=CPU, device_letterbox=True)
        batch = images if cls is BatchPredictor else images[0]
        assert got(batch) == want(batch)
    # new weights reach both of a packed BatchPredictor's models
    bp = BatchPredictor(state, pcfg, device=CPU, device_letterbox=True)
    zeroed = {k: torch.zeros_like(v) for k, v in state.items()}
    bp.load_weights(zeroed)
    for model in (bp.model, bp._lb_model):
        assert all(not t.any() for t in model.state_dict().values())


@pytest.mark.parametrize("layout", [{}, P3])
def test_approx_topk_matches_jax(cfg, served, images, layout):
    pcfg = cfg.with_(**layout)
    want = JaxBatchPredictor(served, pcfg, approx_topk=True)(images)
    exact = JaxBatchPredictor(served, pcfg)(images)
    got = BatchPredictor(_state(pcfg, served), pcfg, device=CPU,
                         approx_topk=True)(images)
    assert got == BatchPredictor(_state(pcfg, served), pcfg,
                                 device=CPU)(images)
    for g, w, e in zip(got, want, exact):
        # approx_max_k is the exact top-k off the TPU (equal scores may
        # come out in another order)
        _assert_same_detections(w, e, box_tol=0, conf_tol=0)
        _assert_same_detections(g, w)


def test_approx_max_k_is_top_k_off_the_tpu():
    score = jnp.asarray(np.random.default_rng(0).random(25200).astype(
        np.float32))
    approx = jax.lax.approx_max_k(score, 4096, recall_target=0.95)
    exact = jax.lax.top_k(score, 4096)
    for a, e in zip(approx, exact):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(e))


def test_packed_int8_serving_and_export_raise(cfg, served, images):
    """Both compositions now run on the packed model (neither raises nor
    serves the unpacked model in its place): the int8 `Predictor` quantizes
    the packed convs and serves the host-packed image; the export takes
    the 4x-packed batch and says so in its header
    (`tests/test_torch_packed_int8.py` and `tests/test_torch_packed_export.py`
    hold both to the JAX package). The test keeps the name it had while
    both raised, so that it stays the same test ID."""
    from yolo_from_scratch_tpu_torch.infer.export import export_serving
    from yolo_from_scratch_tpu_torch.infer.quantize import QuantConvBNSiLU
    from yolo_from_scratch_tpu_torch.models.packed import PackedConvBNSiLU

    pcfg = cfg.with_(packed_stem=True)
    port = Predictor(_state(pcfg, served), pcfg, device=CPU,
                     quantize_calib=images[:1])
    assert isinstance(port.model.stem0, PackedConvBNSiLU)
    assert isinstance(port.model.stem1, QuantConvBNSiLU)
    assert port.model.stem1.k == 2 and port.model.stem1.stride == 1
    assert tuple(port.stage(images[0])[0].shape) == (
        1, cfg.img_size // 4, cfg.img_size // 4, 48)
    assert all(len(d) == 6 for d in port(images[0]))
    exported, header = export_serving(_state(pcfg, served), pcfg, 2,
                                      platforms=["cpu"])
    assert header["packed_stem"] is True
    img_spec = exported.graph_signature.user_inputs[0]
    shape = [n for n in exported.graph.nodes if n.name == img_spec][0].meta[
        "val"].shape
    assert tuple(shape) == (2, cfg.img_size // 4, cfg.img_size // 4, 48)
