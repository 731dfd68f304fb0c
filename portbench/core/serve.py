"""The serving cells: one client, one `infer/predict.py::BatchPredictor`
call outstanding at a time (a closed loop), B frames a call from the
mix's pool, the host letterbox, bfloat16 or, with `precision` int8, the
predictor's int8 model calibrated (`quantize_calib`) on the mix's
calibration frames.

Set-up makes the weights, sets their BatchNorm statistics from one
reference forward over the calibration frames (`core/weights.py`),
builds the predictor and warms it up with `warmup_calls` calls. The
window runs calls back to back for `--seconds`, each timed on the host
from the call to its returned lists; with `--trace 1` two traces of
`trace.count` calls follow it. A sample of the window's calls,
drawn from the seed, keeps its frames and lists; once the window has
closed and the predictor is freed, the reference serves the same frames
(float32, or its own int8 arithmetic calibrated again on the same frames)
and `core/check.py` compares; in a traced run the reference also counts
the IoU tests of the traced calls' frames, K1's bound.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.core import check, traffic
from portbench.core.roofline import bound_ms, conv_flops, conv_walk, \
    int8_conv_work, nms_iou_count, nms_work
from portbench.core.trace import WindowTrace, first_sound
from portbench.core.common import port_config, stage, tf32_off
from portbench.core.weights import calibrate_batchnorm, make_state_dict, \
    sub_seed
from portbench.reference import quant as ref_quant
from portbench.reference import serve as ref_serve
from portbench.reference.model import normalize

K1_KERNELS = ("nms_mask_pass", "nms_scan")
Q2_KERNEL = "int8_conv_tma_kernel"
TRACES = 2


def _letterboxed(frames, size, device):
    return torch.from_numpy(np.stack(
        [ref_serve.letterbox(f, size)[0] for f in frames])).to(device)


def build(cell, seed, device):
    """(state dict, pool, schedule, calibration frames)."""
    cfg, mix = cell["config"], cell["mix"]
    pool = traffic.frame_pool(mix, seed, device)
    sched = traffic.FrameSchedule(len(pool), cell["batch"], seed)
    calib = [pool[i] for i in sched.calibration(mix["calibration_frames"])]
    with tf32_off():
        p = calibrate_batchnorm(make_state_dict(cfg, seed, device), cfg,
                                _letterboxed(calib, cfg["img_size"], device))
    return p, pool, sched, calib


def predictor(cell, p, calib, device, int8=None):
    from yolo_from_scratch_tpu_torch.infer.predict import BatchPredictor

    mix = cell["mix"]
    int8 = cell["precision"] == "int8" if int8 is None else int8
    return BatchPredictor(
        p, port_config(cell["config"]), conf_threshold=mix["conf_threshold"],
        iou_threshold=mix["iou_threshold"], max_outputs=mix["max_outputs"],
        topk=mix["topk"], quantize_calib=calib if int8 else None,
        device=device)


def reference_numerics(cell, p, calib, device, bits=None):
    """The reference's numerics for the cell: float32, or int8 (`bits`
    8, or 4 for the int8 cell's control) calibrated on the frames."""
    bits = bits or (8 if cell["precision"] == "int8" else None)
    if bits is None:
        return None
    x = normalize(_letterboxed(calib, cell["config"]["img_size"], device))
    amax = ref_quant.calibrate(p, cell["config"], [x])
    return ref_quant.QuantNumerics(p, amax, bits)


def reference_lists(cell, p, frames, device, num):
    """Per frame: (reference detections (K, 6) numpy, (corners, obj, cls)
    of every prediction)."""
    mix = cell["mix"]
    out = []
    for i in range(0, len(frames), 8):
        corners, obj, cls = ref_serve.raw_predictions(
            p, cell["config"], frames[i:i + 8], device, num)
        for j in range(corners.shape[0]):
            dets = ref_serve.nms(corners[j], obj[j], cls[j],
                                 mix["conf_threshold"], mix["iou_threshold"],
                                 mix["topk"], mix["max_outputs"])
            out.append((dets, (corners[j], obj[j], cls[j])))
    return out


def numbers(cell, served: list, ref: list) -> dict:
    """The check's numbers over served lists and the reference's."""
    k = cell["mix"]["max_outputs"]
    top = cell["mix"]["check_top"]
    det, rank, n_ref, hits = [], [], [], []
    for lists, (ref_dets, preds) in zip(served, ref):
        dets = np.asarray(lists, np.float32).reshape(-1, 6)
        det.append(check.det_gaps(dets, *preds))
        rank.append(check.rank_gaps(dets, ref_dets, k))
        n_ref.append(len(ref_dets))
        hits.append(check.found(dets, ref_dets, top))
    return check.serve_numbers(det, rank, n_ref, hits, top)


def sample_calls(cell, seed) -> set:
    """Indices (in the window) of the calls the check compares."""
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    mix = cell["mix"]
    return set(rng.choice(mix["sample_from"], mix["check_calls"],
                          replace=False).tolist())


def k1_bound_ms(cell, p, batches, device, num) -> float:
    """K1's least time a call on these batches: the IoU tests that the
    greedy walk over each image's `topk` candidate slots needs (each kept
    box against every later candidate), counted from the reference's
    candidates and kept boxes on the same frames."""
    mix = cell["mix"]
    total = 0.0
    for frames in batches:
        tests = 0
        for i in range(0, len(frames), 8):
            preds = ref_serve.raw_predictions(p, cell["config"],
                                              frames[i:i + 8], device, num)
            for corners, obj, cls in zip(*preds):
                box, _, label = ref_serve.candidates(
                    corners, obj, cls, mix["conf_threshold"], mix["topk"])
                keep = ref_serve.greedy_walk(box, label,
                                             mix["iou_threshold"],
                                             mix["max_outputs"])
                kept = torch.zeros(len(box), dtype=torch.bool)
                kept[keep] = True
                tests += nms_iou_count(kept, torch.ones_like(kept))
        total += bound_ms(*nms_work(len(frames) * mix["topk"], tests),
                          "float32")[0]
    return total / len(batches)


def q2_bound_ms(cell) -> float:
    """Q2's least time a call: every quantized conv (all conv + BN + SiLU
    layers but the first) at the cell's batch, bfloat16 output."""
    total = 0.0
    for name, x, w, stride, _ in conv_walk(cell["config"], cell["batch"]):
        if name in ref_quant.FLOAT_LAYERS or name.endswith(".pred"):
            continue
        b, cin, h, wd = x
        total += bound_ms(*int8_conv_work(b, h, wd, cin, w[0], w[2], stride,
                                          2), "int8")[0]
    return total


def run(cell, seed, seconds, traced, device, clock, hooks=None):
    """One run of a serving cell; returns its outcome dict."""
    cuda = torch.device(device).type == "cuda"
    mix, b = cell["mix"], cell["batch"]
    p, pool, sched, calib = build(cell, seed, device)
    stage(clock, "weights and frames")
    pred = predictor(cell, p, calib, device)
    stage(clock, "predictor")
    serve = pred if hooks is None else hooks.predictor(
        pred, cell=cell, p=p, calib=calib, device=device)
    warm = mix["warmup_calls"]
    for i in range(warm):
        serve([pool[j] for j in sched.call(i)])
    picks = [sched.call(warm + i) for i in range(mix["schedule_calls"])]
    sample = sample_calls(cell, seed)
    gc.collect()
    setup_s = clock()
    stage(clock, "warm-up calls")
    kept, latency = {}, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = len(latency)
        frames = [pool[j] for j in picks[i % len(picks)]]
        t = time.perf_counter()
        lists = serve(frames)
        latency.append(time.perf_counter() - t)
        if i in sample:
            kept[i] = lists
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    record = {"window_s": window_s, "calls": len(latency),
              "img_s": len(latency) * b / window_s,
              "flops_per_img": conv_flops(cell["config"]),
              "dtype": "int8" if cell["precision"] == "int8" else "bfloat16"}
    trace, traced_calls = None, None
    if traced:
        traces, batches, count = [], [], cell["trace"]["count"]
        for _ in range(TRACES):
            first = len(latency) + len(batches) * count
            calls = [[pool[j] for j in picks[(first + c) % len(picks)]]
                     for c in range(count)]
            with WindowTrace() as tracer:
                for frames in calls:
                    with tracer.call():
                        serve(frames)
            traces.append(tracer)
            batches.append(calls)
        for tracer, calls in zip(traces, batches):
            trace = first_sound([tracer], _expected(cell))
            if trace is not None:
                traced_calls = calls
                if cell["precision"] == "int8":
                    record["q2_bound_ms"] = q2_bound_ms(cell)
                break
    del pred, serve
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    served, frames = [], []
    for i in sorted(kept):
        served += kept[i]
        frames += [pool[j] for j in picks[i % len(picks)]]
    with tf32_off():
        num = reference_numerics(cell, p, calib, device)
        ref = reference_lists(cell, p, frames, device, num)
        if traced_calls is not None:
            record["k1_bound_ms"] = k1_bound_ms(cell, p, traced_calls,
                                                device, num)
    return {
        "setup_s": setup_s,
        "e2e": {"serve_img_s": record["img_s"],
                "batch_p95_ms": float(np.percentile(latency, 95)) * 1e3},
        "attempted": len(latency) * b, "failed": 0,
        "memory_peak_bytes": peak,
        "numbers": numbers(cell, served, ref),
        "trace": trace,
        "record": record,
        "checked": len(frames),
    }


def _expected(cell):
    """Kernels every traced call launches, and how often."""
    out = {k: 1 for k in K1_KERNELS}
    if cell["precision"] == "int8":
        n = sum(1 for name, *_ in conv_walk(cell["config"])
                if name not in ref_quant.FLOAT_LAYERS
                and not name.endswith(".pred"))
        out[Q2_KERNEL] = n
    return out
