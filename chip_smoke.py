"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Drives the port's single-image serving path, the 's' model (width 0.50,
depth 0.33) at 640x640, nc=1, anchor head, random weights from a seed,
through `Predictor` on the card, and checks the hand-written CUDA NMS
kernel against its plain PyTorch version. Phases, each of which raises on
failure (the script then exits non-zero and prints no result):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the kernels from `csrc/` into `build/torch_kernels/`;
3. kernel vs plain version on the card, bit-equal keep masks over
   clustered, tied, padded, 1- and 4-class boxes at B in {1, 8} and
   N in {300, 4096}, presorted or not, max_keep below N or equal to it;
   kernel and plain times at N=4096;
4. the slice: serves requests, counts the kernel's launches, checks the
   detections, the TF32-off parity of the pre-NMS candidates with the CPU,
   and equality with the plain NMS on the card; prints the p50 latency;
5. one bfloat16 request, which must be finite.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from yolo_from_scratch_tpu_torch import INV255, YoloConfig
from yolo_from_scratch_tpu_torch.device import cuda_device, tf32_disabled
from yolo_from_scratch_tpu_torch.infer.predict import Predictor
from yolo_from_scratch_tpu_torch.kernels.build import build, load_library
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import nms as nms_plain
from yolo_from_scratch_tpu_torch.ops import nms_cuda
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)

SEED = 0
CONF = 0.005  # random weights give obj ~ sigmoid(-4.6) ~ 0.01
IOU = 0.4
N_REQUESTS = 20
TIMING_RUNS = 20
# TF32 off, cuDNN vs the CPU, float32: the convolutions sum in another
# order, so the logits agree to ~1e-5; a corner in pixels scales that by
# up to the largest anchor (373 px), a probability by at most 1/4.
CORNER_TOL_PX = 1e-2
PROB_TOL = 1e-5


def log(msg):
    print(msg, flush=True)


def median_ms(fn, runs=TIMING_RUNS, warmup=2):
    """Median over `runs` synchronised runs, each timed by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nms_case(rng, b, n, ncls, tied):
    """Clustered, heavily overlapping boxes, a NEG_INF padding tail, class
    ids, and scores that are either continuous or take only 6 values."""
    centers = rng.uniform(50, 590, (b, 12, 2))
    which = rng.integers(0, 12, (b, n))
    xy = np.take_along_axis(centers, which[..., None], axis=1)
    xy = xy + rng.normal(0, 8, (b, n, 2))
    wh = rng.uniform(20, 80, (b, n, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    if tied:
        scores = rng.choice(np.float32([0.9, 0.8, 0.6, 0.4, 0.2, 0.05]),
                            (b, n))
    else:
        scores = rng.uniform(0.01, 1.0, (b, n))
    scores = scores.astype(np.float32)
    scores[:, n - n // 7:] = nms_plain.NEG_INF
    classes = rng.integers(0, ncls, (b, n)).astype(np.int32)
    return boxes, scores, classes


def phase_kernel_vs_plain(dev):
    rng = np.random.default_rng(SEED)
    n_cases = 0
    max_abs_err = 0.0
    for b in (1, 8):
        for n in (300, 4096):
            for ncls in (1, 4):
                boxes, scores, classes = nms_case(rng, b, n, ncls,
                                                  tied=ncls == 4)
                cpu = [torch.from_numpy(a) for a in (boxes, scores, classes)]
                gpu = [t.to(dev) for t in cpu]
                for presorted in (False, True):
                    for max_keep in (100, n):
                        args = []
                        for bx, sc, cl in (cpu, gpu):
                            bx = nms_plain._class_offset_boxes(bx, cl)
                            if presorted:
                                sc, order = nms_plain.sort_desc(sc, dim=1)
                                bx = torch.gather(
                                    bx, 1, order[..., None].expand(b, n, 4))
                            args.append((bx, sc))
                        kernel = nms_cuda.nms_keep_mask_batched(
                            *args[1], IOU, max_keep=max_keep,
                            presorted=presorted)
                        plain_gpu = nms_plain.nms_keep_mask(
                            *args[1], IOU, max_keep=max_keep,
                            presorted=presorted)
                        plain_cpu = nms_plain.nms_keep_mask(
                            *args[0], IOU, max_keep=max_keep,
                            presorted=presorted)
                        torch.cuda.synchronize()
                        k, pg = kernel.cpu(), plain_gpu.cpu()
                        err = (k.float() - pg.float()).abs().max().item()
                        max_abs_err = max(max_abs_err, err)
                        if not (torch.equal(k, pg)
                                and torch.equal(k, plain_cpu)):
                            raise AssertionError(
                                f"keep masks differ at B={b} N={n} "
                                f"classes={ncls} presorted={presorted} "
                                f"max_keep={max_keep}: kernel kept "
                                f"{int(k.sum())}, plain (card) "
                                f"{int(pg.sum())}, plain (CPU) "
                                f"{int(plain_cpu.sum())}")
                        n_cases += 1
                        log(f"  B={b} N={n} classes={ncls} "
                            f"presorted={presorted} max_keep={max_keep}: "
                            f"bit-equal, kept {int(k.sum())}")
                # the full class-aware entry point against the plain one
                got = nms_cuda.batched_nms_fixed_cuda_images(
                    *gpu, IOU, max_outputs=n)
                for i in range(b):
                    want = nms_plain.batched_nms_fixed(
                        cpu[0][i], cpu[1][i], cpu[2][i], IOU, n)
                    for g, w in zip(got, want):
                        if not torch.equal(g[i].cpu(), w):
                            raise AssertionError(
                                f"batched_nms_fixed_cuda_images differs at "
                                f"B={b} N={n} classes={ncls}, image {i}")
    log(f"kernel vs plain: {n_cases} keep-mask cases bit-equal on the card "
        f"and against the CPU")

    for b in (1, 8):
        boxes, scores, _ = nms_case(rng, b, 4096, 1, tied=False)
        sc, order = nms_plain.sort_desc(torch.from_numpy(scores).to(dev), 1)
        bx = torch.gather(torch.from_numpy(boxes).to(dev), 1,
                          order[..., None].expand(b, 4096, 4))
        kept = int(nms_plain.nms_keep_mask(bx, sc, IOU, presorted=True).sum())
        k_ms = median_ms(lambda: nms_cuda.nms_keep_mask_batched(
            bx, sc, IOU, presorted=True))
        p_ms = median_ms(lambda: nms_plain.nms_keep_mask(
            bx, sc, IOU, presorted=True))
        log(f"NMS keep mask B={b} N=4096 presorted, {kept} kept in all: "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
            f"(median of {TIMING_RUNS}, CUDA events)")
    return max_abs_err


def phase_slice(dev):
    cfg = YoloConfig.from_size("s", num_classes=1, img_size=640)
    meta_model = YOLO(cfg, device="meta")
    state = from_flax_variables(random_variables(meta_model, SEED),
                                meta_model)
    predictor = Predictor(state, cfg, conf_threshold=CONF, iou_threshold=IOU,
                          device=dev)
    rng = np.random.default_rng(SEED + 1)
    requests = [rng.integers(0, 256, (640, 640, 3), dtype=np.uint8)
                for _ in range(N_REQUESTS)]
    log(f"slice: 's' @640 nc=1 float32 (cuDNN default TF32 convs), "
        f"conf_threshold={CONF}, iou_threshold={IOU}, "
        f"{sum(p.numel() for p in predictor.model.parameters()):,} params")

    predictor(requests[0])  # warm-up: cuDNN handles and algorithm choice
    torch.cuda.synchronize()
    nms_cuda.launches = 0
    latencies, results = [], []
    for img in requests:
        t0 = time.perf_counter()
        results.append(predictor(img))  # ends in a device -> host copy
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = nms_cuda.launches
    if launches != N_REQUESTS:
        raise AssertionError(f"NMS kernel launched {launches} times for "
                             f"{N_REQUESTS} requests")
    for i, dets in enumerate(results):
        if not dets or not np.isfinite(np.asarray(dets, np.float64)).all():
            raise AssertionError(f"request {i}: {len(dets)} detections, "
                                 f"finite={np.isfinite(dets).all()}")
    p50 = statistics.median(latencies)
    log(f"served {N_REQUESTS} requests, NMS kernel launches {launches}, "
        f"detections per request {[len(d) for d in results]}")
    log(f"request latency p50 {p50:.3f} ms (min {min(latencies):.3f}, max "
        f"{max(latencies):.3f}; host clock, letterbox-free 640x640 uint8 "
        f"array in, detections out, conf_threshold={CONF})")

    # stage split of one request, CUDA events
    args = predictor.stage(requests[1])
    with torch.inference_mode():
        img = args[0].float() * float(INV255)
        fwd_ms = median_ms(lambda: predictor.model(img))
        cand = predictor.postprocess.candidates(*args)
        post_ms = median_ms(lambda: predictor.postprocess(*args))
    boxes, scores, classes = cand
    off = nms_plain._class_offset_boxes(boxes, classes)[None]
    k_ms = median_ms(lambda: nms_cuda.nms_keep_mask_batched(
        off, scores[None], IOU, presorted=True))
    p_ms = median_ms(lambda: nms_plain.nms_keep_mask(
        off, scores[None], IOU, presorted=True))
    n_valid = int((scores > nms_plain.NEG_INF / 2).sum())
    log(f"one request on the card: forward {fwd_ms:.4f} ms, forward + "
        f"postprocess {post_ms:.4f} ms; NMS on its {scores.numel()} "
        f"candidates ({n_valid} above the gate): kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms")

    # the same candidates through both NMS paths: bit-equal
    fixed_k = nms_cuda.batched_nms_fixed_cuda(boxes, scores, classes, IOU,
                                              scores.numel(), presorted=True)
    fixed_p = nms_plain.batched_nms_fixed(boxes, scores, classes, IOU,
                                          scores.numel(), presorted=True)
    for a, b in zip(fixed_k, fixed_p):
        if not torch.equal(a, b):
            raise AssertionError("kernel and plain NMS differ on a "
                                 "request's candidates")
    plain_pred = Predictor(state, cfg, conf_threshold=CONF, iou_threshold=IOU,
                           device=dev, use_cuda_nms=False)
    for img, dets in zip(requests[:2], results[:2]):
        if plain_pred(img) != dets:
            raise AssertionError("detections differ between the kernel "
                                 "and the plain NMS on the card")
    log("kernel NMS == plain NMS on the card: the request's candidates "
        "bit-equal, 2 requests' detection lists equal")

    # pre-NMS candidates with TF32 off against the port on the CPU
    cpu_pred = Predictor(state, cfg, conf_threshold=CONF, iou_threshold=IOU,
                         device=torch.device("cpu"))
    with tf32_disabled():
        gpu_dec = [t.cpu() for t in predictor.postprocess.decode(*args)]
    cpu_dec = cpu_pred.postprocess.decode(*cpu_pred.stage(requests[1]))
    errs = [(g.double() - c.double()).abs().max().item()
            for g, c in zip(gpu_dec[:3], cpu_dec[:3])]
    if (errs[0] > CORNER_TOL_PX or max(errs[1:]) > PROB_TOL
            or not torch.equal(gpu_dec[3], cpu_dec[3])):
        raise AssertionError(f"TF32-off decode vs CPU: corners {errs[0]} px "
                             f"(tol {CORNER_TOL_PX}), obj {errs[1]}, cls "
                             f"{errs[2]} (tol {PROB_TOL})")
    log(f"TF32 off, card vs CPU on all {gpu_dec[1].numel()} pre-NMS "
        f"predictions: max |corner| err {errs[0]:.3e} px (tol "
        f"{CORNER_TOL_PX}), max |obj| err {errs[1]:.3e}, max |cls| err "
        f"{errs[2]:.3e} (tol {PROB_TOL})")
    return state, cfg, requests, launches, (k_ms, p_ms)


def phase_bf16(state, cfg, requests, dev):
    bf = Predictor(state, cfg.with_(compute_dtype="bfloat16"),
                   conf_threshold=CONF, iou_threshold=IOU, device=dev)
    args = bf.stage(requests[0])
    dec = bf.postprocess.decode(*args)
    dets = bf(requests[0])
    finite = all(torch.isfinite(t.float()).all().item() for t in dec)
    if not finite or not np.isfinite(np.asarray(dets, np.float64)).all():
        raise AssertionError("bfloat16 request gave non-finite values")
    log(f"bfloat16 request: {len(dets)} detections, all finite")


def main():
    # 1. device
    dev = cuda_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    path, nvcc_s = build()
    load_library()
    log(f"build: {path.name}, nvcc {nvcc_s:.2f} s, build+load "
        f"{time.perf_counter() - t0:.2f} s")

    # 3. kernel vs plain version
    max_abs_err = phase_kernel_vs_plain(dev)

    # 4. the slice, 5. bfloat16
    state, cfg, requests, launches, (k_ms, p_ms) = phase_slice(dev)
    phase_bf16(state, cfg, requests, dev)

    print(json.dumps({"kernels": [{
        "name": "nms_pivot_walk",
        "route": "cuda",
        "source": "yolo_from_scratch_tpu_torch/csrc/nms.cu",
        "replaces": "yolo_from_scratch_tpu/ops/nms_pallas.py:46",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
