"""The plain reference held to the program at a small size on the CPU, and
the yardstick's counts: the reference's forward, training step, serving
pipeline and int8 arithmetic against the port's, and the FLOPs of an
image at 640."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.core import registry, traffic
from portbench.core import serve as S
from portbench.core import train as T
from portbench.core.common import port_config
from portbench.core.roofline import bound_ms, conv_flops, nms_work
from portbench.core.weights import make_state_dict
from portbench.reference import model as M
from portbench.reference import quant as Q
from portbench.reference import serve as RS
from portbench.reference import train as RT
from portbench.tests.conftest import tiny

SMALL = {"width_mult": 0.25, "depth_mult": 0.33, "num_classes": 80,
         "img_size": 64, "head_type": "anchor", "compute_dtype": "float32"}


def _port_model(cfg, p):
    from yolo_from_scratch_tpu_torch.models.yolo import YOLO

    model = YOLO(port_config(cfg), device="meta")
    model.load_state_dict({k: v.clone() for k, v in p.items()}, strict=True,
                          assign=True)
    return model


@pytest.mark.parametrize("size,gflop", [("yfs-s", 7.64), ("yfs-l", 31.53)])
def test_flops_an_image_at_640(size, gflop):
    assert round(conv_flops(registry.config(size)) / 1e9, 2) == gflop


@pytest.mark.parametrize("size", ["yfs-s", "yfs-l"])
def test_state_dict_keys_and_shapes_are_the_programs(size):
    from yolo_from_scratch_tpu_torch.models.yolo import YOLO

    cfg = registry.config(size)
    port = YOLO(port_config(cfg), device="meta").state_dict()
    shapes = M.param_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in port.items()} == shapes
    assert sum(np.prod(s) for k, s in shapes.items()
               if M.is_param(k)) == cfg["parameters"]


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_program(train):
    p = make_state_dict(SMALL, 1, "cpu")
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        port = _port_model(SMALL, p)(x, train=train)
        ref = M.forward(p, SMALL, x, train=train)
    for a, b in zip(port, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_training_steps_match_the_program():
    """The window's first chunk through the program's chunk trainer (eager
    on the CPU) against the reference following it step by step, float32:
    every step's gradient and the chunk's update."""
    cell = tiny(registry.workload("s-train-stream-b64"))
    state, _, chunks, cache, p0, _, prog = T.first_chunk(cell, 3, "cpu")
    chunks.close()
    n, b = cell["mix"]["steps_per_chunk"], cell["batch"]
    rows = prog["rows"]
    assert rows.shape == (n * b,) and len(set(rows.tolist())) == n * b
    assert int(state.step) == n and len(prog["grads"]) == n
    numbers = T.follow(cell, cache, p0, prog, "cpu")["program"]
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4 and numbers["grad_diff"] < 1e-4
    assert numbers["step_gap"] < 1e-4


def test_chunk_rows_are_found_by_their_pixels():
    cache = traffic.train_cache(
        registry.mix("train_stream") | {"images": 8}, 32, 5, "cpu")
    order = np.array([5, 2, 7, 0])
    chunk = torch.from_numpy(cache.images[order]).reshape(2, 2, 32, 32, 3)
    np.testing.assert_array_equal(T.chunk_rows(chunk, cache), order)
    chunk[1, 1, 0, 0, 0] ^= 1
    np.testing.assert_array_equal(T.chunk_rows(chunk, cache), [5, 2, 7, -1])


def test_assignment_matches_the_program():
    from yolo_from_scratch_tpu_torch.data.assign_device import (
        assign_targets_device_batch,
    )

    cache = traffic.train_cache(
        registry.mix("train_stream") | {"images": 8}, 128, 5, "cpu")
    ref = RT.assign(cache.labels, cache.counts, 128, 80)
    port = assign_targets_device_batch(
        torch.from_numpy(cache.labels), torch.from_numpy(cache.counts),
        np.asarray(M.ANCHORS_PX, np.float32).reshape(3, 3, 2), 128, 80)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), b)


def test_serving_matches_the_program_in_float32():
    cell = tiny(registry.workload("l-serve-b32"))
    p, pool, sched, calib = S.build(cell, 4, "cpu")
    frames = [pool[j] for j in sched.call(0)]
    served = S.predictor(cell, p, calib, "cpu")(frames)
    ref = S.reference_lists(cell, p, frames, "cpu", None)
    for lists, (dets, _) in zip(served, ref):
        a = np.asarray(lists).reshape(-1, 6)
        # the same detections; equal scores may come in either order
        np.testing.assert_allclose(a[np.lexsort(a.T)], dets[np.lexsort(
            dets.T)], rtol=1e-5, atol=1e-4)
    numbers = S.numbers(cell, served, ref)
    assert numbers["det_gap"] < 1e-4 and numbers["rank_gap"] < 1e-4


def test_k1_bound_counts_the_reference_walk():
    """K1's bound from the reference's candidates and kept boxes: every
    kept box against every later candidate, plus the slots' bytes."""
    cell = tiny(registry.workload("l-serve-b32"))
    p, pool, sched, calib = S.build(cell, 4, "cpu")
    frames = [pool[j] for j in sched.call(0)]
    mix = cell["mix"]
    tests = 0
    for corners, obj, cls in zip(*RS.raw_predictions(
            p, cell["config"], frames, "cpu")):
        box, _, label = RS.candidates(corners, obj, cls,
                                      mix["conf_threshold"], mix["topk"])
        keep = RS.greedy_walk(box, label, mix["iou_threshold"],
                              mix["max_outputs"])
        tests += sum(len(box) - 1 - k for k in keep)
    assert tests > 0
    expected = bound_ms(*nms_work(len(frames) * mix["topk"], tests),
                        "float32")[0]
    got = S.k1_bound_ms(cell, p, [frames, frames], "cpu", None)
    assert got == pytest.approx(expected)


def test_letterbox_matches_the_program():
    from yolo_from_scratch_tpu_torch.infer.predict import letterbox_input

    rng = np.random.default_rng(0)
    for h, w in ((480, 640), (640, 480), (500, 900)):
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        a, *geo_a = letterbox_input(frame, 640)
        b, *geo_b = RS.letterbox(frame, 640)
        np.testing.assert_array_equal(a, b)
        assert np.allclose(geo_a, geo_b)


def test_int8_reference_is_the_programs_arithmetic():
    """The program's int8 model (plain Q1 / Q2 on the CPU) against the
    reference's int8 arithmetic: within a few quantization steps of each
    other, and far closer than the int4 control is."""
    cell = tiny(registry.workload("l-serve-b32-int8"))
    p, pool, _, calib = S.build(cell, 6, "cpu")
    pred = S.predictor(cell, p, calib, "cpu")
    x = torch.from_numpy(np.stack([RS.letterbox(f, 64)[0] for f in pool[:2]]))
    with torch.no_grad():
        port = pred.model(M.normalize(x))
        ref8 = M.forward(p, cell["config"], M.normalize(x),
                         num=S.reference_numerics(cell, p, calib, "cpu"))
        ref4 = M.forward(p, cell["config"], M.normalize(x),
                         num=S.reference_numerics(cell, p, calib, "cpu", 4))
    for a, b, c in zip(port, ref8, ref4):
        gap8, gap4 = (a - b).abs().mean(), (c - b).abs().mean()
        assert gap8 < 0.2 * gap4


def test_fold_matches_the_program():
    from yolo_from_scratch_tpu_torch.infer.quantize import quantize_params

    p = make_state_dict(SMALL, 2, "cpu")
    q = quantize_params(p, {"bb_p4_down": 0.1})["bb_p4_down"]
    num = Q.QuantNumerics(p, {"bb_p4_down": 12.7})
    _, wq, w_scale, bias = num.layers["bb_p4_down"]
    np.testing.assert_array_equal(wq.permute(2, 3, 1, 0).numpy(),
                                  q["w_int8"])
    np.testing.assert_allclose(w_scale.numpy(), q["w_scale"], rtol=1e-6)
    np.testing.assert_allclose(bias.numpy(), q["bias"], rtol=1e-5,
                               atol=1e-6)


def test_fp8_control_rounds_operands():
    p = make_state_dict(SMALL, 1, "cpu")
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = M.forward(p, SMALL, x, train=True)
        b = M.forward(p, SMALL, x, train=True, num=M.Fp8Numerics())
    gap = max(float((u - v).abs().max()) for u, v in zip(a, b))
    assert 1e-3 < gap < 10.0
