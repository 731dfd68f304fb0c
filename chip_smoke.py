"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Drives the port's paths on the card: with the 's' model (width 0.50,
depth 0.33) at 640x640, nc=1, anchor head, random weights from a seed,
single-image serving through `Predictor` and training through the CLI;
then the conv-backward prototype entry points (`benchmarks/bwdproto.py`,
`benchmarks/blockbwd.py`) at the training path's 64-channel shapes. It
checks each hand-written CUDA kernel (NMS; the fused 3x3 conv backward
K2; the prototypes K3, K4 and K5) against its plain PyTorch version.
Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the kernels from `csrc/` into `build/torch_kernels/`;
3. kernel vs plain version on the card, bit-equal keep masks over
   clustered, tied, padded, 1- and 4-class boxes at B in {1, 8} and
   N in {300, 4096}, presorted or not, max_keep below N or equal to it;
   kernel and plain times at N=4096;
4. the slice: serves requests, counts the kernel's launches, checks the
   detections, the TF32-off parity of the pre-NMS candidates with the CPU,
   and equality with the plain NMS on the card; prints the p50 latency;
5. one bfloat16 request, which must be finite;
6. the conv backward kernel against its plain version (TF32 off) at the
   training path's shapes and two small ones, bit-equal across two runs;
   kernel, plain and cuDNN backward times;
7. the training slice: the CLI trains one epoch of 2 steps at batch 8 in
   bfloat16 with YOLO_FUSED_CONV_BWD=1 on a synthetic dataset, counts the
   kernel's launches, and serves one request from the checkpoint it wrote;
8. one float32 train step (TF32 off) on the card against the port on the
   CPU: loss and gradients;
9. train img/s at batch 8, bfloat16, with the kernel on and off, the
   device time per step, and 30 steps on one batch that must lower the
   loss;
10. K3 (patch matrix) and K4 (per-tap) against their plain versions (TF32
   off) at phase 6's cases, bit-equal across two runs; device times of
   each, its plain version, cuDNN's dgrad + wgrad and K2 at the two bf16
   shapes;
11. K5 (the bottleneck chain's backward) the same way, and the chain's
   forward + backward with K5 against autograd with cuDNN;
12. the slice: `python -m yolo_from_scratch_tpu_torch.benchmarks.bwdproto
   --iters 1` and `... .blockbwd --iters 1`, each in its own process, must
   exit 0, print their timing and projection lines and launch K3, K4 and
   K5.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from yolo_from_scratch_tpu_torch import INV255, YoloConfig, cli
from yolo_from_scratch_tpu_torch.benchmarks import blockbwd, bwdproto
from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
from yolo_from_scratch_tpu_torch.device import cuda_device, tf32_disabled
from yolo_from_scratch_tpu_torch.infer.predict import Predictor
from yolo_from_scratch_tpu_torch.kernels.build import build, load_library
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import conv_bwd
from yolo_from_scratch_tpu_torch.ops import nms as nms_plain
from yolo_from_scratch_tpu_torch.ops import nms_cuda
from yolo_from_scratch_tpu_torch.train.steps import (
    create_train_state,
    make_loss_fn,
    make_train_step,
)
from yolo_from_scratch_tpu_torch.utils.checkpoint import load_checkpoint
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)
from yolo_from_scratch_tpu_torch.utils.synth import make_dataset
from yolo_from_scratch_tpu_torch.utils.timing import (
    device_ms,
    kernel_ms,
    median_ms,
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
# conv backward kernel vs its plain version, relative to the largest
# reference magnitude: float32 sums in another order; bf16 dx is rounded to
# bf16 once from float32 sums taken in another order (one bf16 ulp is 2^-8
# of a value), dW stays float32
K2_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-3)}
# (B, H, W, dtype): the training path's three shapes, then two small ones
K2_CASES = ((8, 40, 40, torch.bfloat16), (8, 80, 80, torch.bfloat16),
            (8, 40, 40, torch.float32), (2, 16, 16, torch.float32),
            (1, 7, 5, torch.float32))
# K5 (the chain) at K2's cases, B=4 at float32 40x40, as the JAX check
K5_CASES = tuple((4 if (h, dt) == (40, torch.float32) else b, h, w, dt)
                 for b, h, w, dt in K2_CASES)
# K5 vs its plain version, (dx, dw1, dw2) relative to the largest
# reference magnitude: float32 sums in another order (and expf against
# torch's sigmoid); in bf16, dz1 is rounded to bf16 from a float32 sum taken
# in another order, so an element can land one bf16 ulp (2^-8 of it) away:
# dx, rounded once more, stays within 2^-7 of the max; dw1 sums such flips
# over the batch's pixels, far under 1e-3 of its max; dw2 as K2's dW
K5_TOL = {torch.float32: (1e-5, 1e-5, 1e-5),
          torch.bfloat16: (2.0 ** -7, 1e-3, 1e-3)}
GATED_CONVS_BF16 = 8  # 6 bottleneck convs at 40x40 + head_p3's two at 80x80
TRAIN_STEPS = 2       # 16 synthetic images at batch 8
# float32 step on the card (TF32 off) vs the CPU: loss relative, gradients
# against each tensor's largest magnitude
PARITY_LOSS_TOL = 1e-4
PARITY_GRAD_TOL = 1e-3
# conv biases in front of a train-mode BatchNorm: zero gradient in theory,
# rounding noise in practice, so not compared
PRE_BN_BIASES = ("stem0.conv.bias", "stem1.conv.bias", "bb_p3_down.conv.bias",
                 "bb_p4_down.conv.bias", "bb_p5_down.conv.bias",
                 "sppf.conv1.conv.bias", "sppf.conv2.conv.bias")
TIMED_STEPS = 20
# steps before each timed run: with 3, the first timed run was still the
# slowest of the four in every call
WARMUP_STEPS = 10
IMG_SIZE = 640  # phases 7-9
EPOCH_LINE = re.compile(r"Epoch 1: Loss: .* \| LR: .* \| (\S+) img/s")


def log(msg):
    print(msg, flush=True)


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


def _conv_case(b, h, w, dtype, dev, seed):
    """x, dy (B, 64, H, W) channels-last and w (64, 64, 3, 3) on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cl = torch.channels_last
    x = torch.randn((b, 64, h, w), generator=g, device=dev).to(
        dtype, memory_format=cl)
    dy = torch.randn((b, 64, h, w), generator=g, device=dev).to(
        dtype, memory_format=cl)
    wt = (torch.randn((64, 64, 3, 3), generator=g, device=dev) * 0.05).to(
        dtype)
    return x, dy, wt


def phase_conv_bwd(dev):
    """The conv backward kernel against its plain version (TF32 off), two
    runs bit-equal; kernel, plain and cuDNN backward times."""
    max_abs_err = 0.0
    times = {}
    for i, (b, h, w, dtype) in enumerate(K2_CASES):
        x, dy, wt = _conv_case(b, h, w, dtype, dev, SEED + i)
        dx, dw = conv_bwd._launch(x, dy, wt)
        dx2, dw2 = conv_bwd._launch(x, dy, wt)
        with tf32_disabled():
            dx_p, dw_p = conv_bwd.fused_bwd_plain(x, dy, wt)
        torch.cuda.synchronize()
        if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
            raise AssertionError(f"conv backward kernel not deterministic at "
                                 f"B={b} {h}x{w} {dtype}")
        tol_dx, tol_dw = K2_TOL[dtype]
        err_dx = (dx.float() - dx_p.float()).abs().max().item()
        err_dw = (dw - dw_p).abs().max().item()
        rel_dx = err_dx / dx_p.float().abs().max().item()
        rel_dw = err_dw / dw_p.abs().max().item()
        max_abs_err = max(max_abs_err, err_dx, err_dw)
        name = f"B={b} {h}x{w} {str(dtype).split('.')[1]}"
        if (dx.dtype != dtype or not dx.is_contiguous(
                memory_format=torch.channels_last)
                or rel_dx > tol_dx or rel_dw > tol_dw):
            raise AssertionError(f"conv backward kernel vs plain at {name}: "
                                 f"dx {rel_dx:.3e} (tol {tol_dx:.3e}), dW "
                                 f"{rel_dw:.3e} (tol {tol_dw:.3e})")

        def kernel():
            conv_bwd._launch(x, dy, wt)

        def plain():
            with tf32_disabled():
                conv_bwd.fused_bwd_plain(x, dy, wt)

        def cudnn():
            torch.nn.grad.conv2d_input(x.shape, wt, dy, padding=1)
            torch.nn.grad.conv2d_weight(x, wt.shape, dy, padding=1)

        ev = [median_ms(f) for f in (kernel, plain, cudnn)]
        dev_ms = [device_ms(f) for f in (kernel, plain, cudnn)]
        times[(b, h, w, dtype)] = dev_ms
        log(f"  conv bwd {name}: dx err {rel_dx:.3e}, dW err {rel_dw:.3e} "
            f"of max (tol {tol_dx:.1e} / {tol_dw:.1e}), 2 runs bit-equal; "
            f"device ms (profiler, {TIMING_RUNS} calls): kernel "
            f"{dev_ms[0]:.4f}, plain {dev_ms[1]:.4f}, cuDNN {dev_ms[2]:.4f}; "
            f"per call with host launch (CUDA events, median of "
            f"{TIMING_RUNS}): {ev[0]:.4f} / {ev[1]:.4f} / {ev[2]:.4f}")
    (k40, p40, c40), (k80, p80, c80) = (times[K2_CASES[0]],
                                        times[K2_CASES[1]])
    log(f"conv bwd device time per bf16 train step (6 calls at 40x40 + 2 at "
        f"80x80, B=8): kernel {6 * k40 + 2 * k80:.4f} ms, plain "
        f"{6 * p40 + 2 * p80:.4f} ms, cuDNN dgrad+wgrad (TF32 default) "
        f"{6 * c40 + 2 * c80:.4f} ms")
    return max_abs_err, k40, p40


class _Tee(io.TextIOBase):
    """Write to stdout and keep a copy."""

    def __init__(self):
        self.text = io.StringIO()
        self.out = sys.stdout

    def write(self, s):
        self.text.write(s)
        self.out.write(s)
        self.out.flush()
        return len(s)


def phase_train_slice(dev, workdir):
    """The CLI trains one epoch (2 steps of 8) in bf16 with the fused
    backward on; its checkpoint serves one request."""
    t0 = time.perf_counter()
    yaml_path = make_dataset(workdir / "data", n_train=8 * TRAIN_STEPS,
                             n_val=8, img_size=IMG_SIZE, seed=SEED)
    log(f"synthetic dataset: {8 * TRAIN_STEPS} train + 8 val images at "
        f"{IMG_SIZE} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    backend = YoloDataset(str(workdir / "data" / "val" / "images")).backend
    log(f"dataset backend '{backend}' ({time.perf_counter() - t0:.2f} s to "
        f"open, including any build of the native JPEG loader)")

    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    cwd = os.getcwd()
    os.chdir(workdir)
    tee = _Tee()
    try:
        conv_bwd.launches = 0
        with contextlib.redirect_stdout(tee):
            rc = cli.main([str(yaml_path), "--epochs", "1", "--batch-size",
                           "8", "--size", "s", "--img-size", str(IMG_SIZE)])
        torch.cuda.synchronize()
        launches = conv_bwd.launches
    finally:
        os.chdir(cwd)
    out = tee.text.getvalue()
    epoch = EPOCH_LINE.search(out)
    saved = re.search(r"Training complete\. Model saved to (\S+)", out)
    want = GATED_CONVS_BF16 * TRAIN_STEPS * conv_bwd.LAUNCHES_PER_CALL
    if rc != 0 or not epoch or not saved or f"Device: {dev.type}" not in out:
        raise AssertionError(f"training CLI: rc {rc}, output:\n{out}")
    if launches != want:
        raise AssertionError(f"conv backward kernel launched {launches} "
                             f"times, want {want} ({GATED_CONVS_BF16} convs "
                             f"x {TRAIN_STEPS} steps x "
                             f"{conv_bwd.LAUNCHES_PER_CALL})")
    log(f"training slice: conv backward kernel launches {launches} "
        f"(= {GATED_CONVS_BF16} convs x {TRAIN_STEPS} steps x "
        f"{conv_bwd.LAUNCHES_PER_CALL}), epoch img/s {epoch.group(1)} "
        f"(first-step warm-up, PIL decode and eval included)")

    state, cfg, meta = load_checkpoint(workdir / saved.group(1))
    dtype = "bfloat16" if dev.type == "cuda" else "float32"  # --dtype auto
    if cfg.compute_dtype != dtype or meta["extra"] != {"step": TRAIN_STEPS}:
        raise AssertionError(f"checkpoint: {cfg}, {meta}")
    image = sorted((workdir / "data" / "val" / "images").glob("*.jpg"))[0]
    nms_cuda.launches = 0
    dets = Predictor(state, cfg, conf_threshold=CONF, iou_threshold=IOU,
                     device=dev)(str(image))
    if nms_cuda.launches != 1 or not np.isfinite(
            np.asarray(dets, np.float64)).all():
        raise AssertionError(f"checkpoint request: {nms_cuda.launches} NMS "
                             f"launches, {len(dets)} detections")
    log(f"checkpoint {saved.group(1)} read back: {dtype}, step "
        f"{meta['extra']['step']}; one request, 1 NMS launch, {len(dets)} "
        f"detections, all finite")
    return launches, yaml_path


def _batch(yaml_path, split, batch_size, dev):
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    config = load_dataset_yaml(yaml_path)
    loader = DataLoader(YoloDataset(config[split], 1, np.asarray(
        YoloConfig().anchors, np.float32), IMG_SIZE), batch_size=batch_size,
        prefetch=0)
    images, targets = next(iter(loader))
    return (torch.from_numpy(images).to(dev),
            [torch.from_numpy(t).to(dev) for t in targets])


def phase_parity(dev, yaml_path):
    """One float32 train step's loss and gradients, card (TF32 off) vs
    CPU, from the same seeded weights and batch."""
    cfg = YoloConfig.from_size("s", num_classes=1, img_size=IMG_SIZE)
    cpu = torch.device("cpu")
    models = {}
    models[cpu] = YOLO(cfg).reset_parameters(
        torch.Generator().manual_seed(SEED))
    models[dev] = copy.deepcopy(models[cpu]).to(dev)
    totals = {}
    for device, model in models.items():
        images, targets = _batch(yaml_path, "train", 2, device)
        with tf32_disabled():
            total, _ = make_loss_fn(cfg, device=device)(model, images,
                                                        targets)
            total.backward()
        totals[device] = total.item()
    rel_loss = abs(totals[dev] - totals[cpu]) / abs(totals[cpu])
    worst = 0.0, ""
    cpu_params = dict(models[cpu].named_parameters())
    for name, p in models[dev].named_parameters():
        if name in PRE_BN_BIASES:
            continue
        want = cpu_params[name].grad
        err = ((p.grad.cpu() - want).abs().max()
               / want.abs().max().clamp(min=1e-30)).item()
        worst = max(worst, (err, name))
    log(f"float32 step, card (TF32 off, fused conv backward kernel) vs CPU "
        f"(plain version), 's' @{IMG_SIZE} b2: loss {totals[dev]:.6f} vs "
        f"{totals[cpu]:.6f} ({rel_loss:.2e} relative, tol "
        f"{PARITY_LOSS_TOL}); worst gradient {worst[0]:.2e} of its "
        f"tensor's max ({worst[1]}; tol {PARITY_GRAD_TOL})")
    if rel_loss > PARITY_LOSS_TOL or worst[0] > PARITY_GRAD_TOL:
        raise AssertionError("float32 step on the card differs from the CPU")
    return rel_loss, worst


def phase_throughput(dev, yaml_path):
    """Train img/s at batch 8, bf16, the kernel on and off in turns; the
    device time per step; 30 steps on one batch lower the loss."""
    cfg = YoloConfig.from_size("s", num_classes=1, img_size=IMG_SIZE,
                               compute_dtype="bfloat16")
    images, targets = _batch(yaml_path, "train", 8, dev)
    state = create_train_state(cfg, 1e-3, seed=SEED, device=dev)
    step = make_train_step(cfg, device=dev)
    rates = {"1": [], "0": []}
    for flag in ("1", "0", "0", "1"):
        os.environ["YOLO_FUSED_CONV_BWD"] = flag
        for _ in range(WARMUP_STEPS):
            step(state, images, targets)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            step(state, images, targets)
        torch.cuda.synchronize()
        rates[flag].append(8 * TIMED_STEPS / (time.perf_counter() - t0))
    busy_ms = {}
    for flag in ("1", "0"):
        os.environ["YOLO_FUSED_CONV_BWD"] = flag
        per_kernel = kernel_ms(lambda: step(state, images, targets), 3)
        busy_ms[flag] = (sum(per_kernel.values()) / 3,
                         sum(v for k, v in per_kernel.items()
                             if "conv3x3_bwd" in k) / 3)
    for flag, label in (("1", "on"), ("0", "off")):
        busy, k2 = busy_ms[flag]
        wall = 8e3 / statistics.mean(rates[flag])
        log(f"train 's' @{IMG_SIZE} b8 bf16, fused conv backward {label}: "
            f"{rates[flag][0]:.1f} / {rates[flag][1]:.1f} img/s (runs in "
            f"turns, {TIMED_STEPS} steps each after {WARMUP_STEPS} warm-up; "
            f"host clock, synchronized); {wall:.2f} ms a step; device busy "
            f"{busy:.2f} ms "
            f"a step (profiler, 3 steps), of it the kernel {k2:.3f} ms; "
            f"idle {max(0.0, 1 - busy / wall):.0%}")

    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    state = create_train_state(cfg, 1e-3, seed=SEED + 1, device=dev)
    losses = [step(state, images, targets)[1]["loss"] for _ in range(30)]
    losses = torch.stack(losses).tolist()
    log(f"30 steps on one batch (lr 1e-3): loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over 30 steps: {losses}")
    return rates


def _nhwc_case(b, h, w, dtype, dev, seed):
    """x, dy (B, H, W, 64), two HWIO weights (3, 3, 64, 64) and two (64,)
    float32 scales in [0.5, 1.5) on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x, dy = (torch.randn((b, h, w, 64), generator=g, device=dev).to(dtype)
             for _ in range(2))
    w1, w2 = ((torch.randn((3, 3, 64, 64), generator=g, device=dev)
               * 0.05).to(dtype) for _ in range(2))
    s1, s2 = (torch.rand(64, generator=g, device=dev) + 0.5 for _ in range(2))
    return x, dy, w1, w2, s1, s2


def _case_name(b, h, w, dtype):
    return f"B={b} {h}x{w} {str(dtype).split('.')[1]}"


def _held(name, firsts, seconds, wants, tols, dtype):
    """Raise unless two kernel runs are bit-equal and the first is within
    `tols` (relative to the plain version's largest magnitude) of the
    plain version. Returns (relative errors, largest absolute error)."""
    if not all(torch.equal(a, b) for a, b in zip(firsts, seconds)):
        raise AssertionError(f"{name}: two runs differ")
    rel, worst = [], 0.0
    for got, want in zip(firsts, wants):
        diff = (got.float() - want.float()).abs().max().item()
        rel.append(diff / want.float().abs().max().item())
        worst = max(worst, diff)
    if firsts[0].dtype != dtype or any(r > t for r, t in zip(rel, tols)):
        raise AssertionError(f"{name} vs plain: errors {rel}, tolerances "
                             f"{tols}, dx {firsts[0].dtype}")
    return rel, worst


PROTOTYPES = (("conv_bwd_patch", bwdproto.make_fused_bwd,
               bwdproto.fused_bwd_patch_plain),
              ("conv_bwd_tap", bwdproto.make_fused_bwd_v2,
               bwdproto.fused_bwd_tap_plain))


def phase_prototypes(dev):
    """K3 and K4 against their plain versions (TF32 off) at K2's cases and
    tolerances, two runs bit-equal; device times of each kernel, its plain
    version, cuDNN's dgrad + wgrad and K2 at the two bf16 training
    shapes."""
    worst = {name: 0.0 for name, _, _ in PROTOTYPES}
    times = {}
    for i, (b, h, w, dtype) in enumerate(K2_CASES):
        x, dy, wt = _nhwc_case(b, h, w, dtype, dev, SEED + i)[:3]
        case = _case_name(b, h, w, dtype)
        row = {}
        for name, make, plain in PROTOTYPES:
            fused = make(b, h, w, 64, dtype)
            runs = [fused(x, dy, wt) for _ in range(2)]
            with tf32_disabled():
                want = plain(x, dy, wt)
            torch.cuda.synchronize()
            rel, err = _held(f"{name} {case}", *runs, want, K2_TOL[dtype],
                             dtype)
            worst[name] = max(worst[name], err)
            log(f"  {name} {case}: dx err {rel[0]:.3e}, dW err {rel[1]:.3e} "
                f"of max (tol {K2_TOL[dtype][0]:.1e} / "
                f"{K2_TOL[dtype][1]:.1e}), 2 runs bit-equal")
            if dtype == torch.bfloat16:
                row[name] = device_ms(lambda: fused(x, dy, wt))
                with tf32_disabled():
                    row[f"{name} plain"] = device_ms(lambda: plain(x, dy, wt))
        if dtype == torch.bfloat16:
            xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            wo = wt.permute(3, 2, 0, 1).contiguous()

            def cudnn():
                torch.nn.grad.conv2d_input(xn.shape, wo, dyn, padding=1)
                torch.nn.grad.conv2d_weight(xn, wo.shape, dyn, padding=1)

            row["cuDNN dgrad+wgrad"] = device_ms(cudnn)
            row["K2"] = device_ms(lambda: conv_bwd._launch(xn, dyn, wo))
            times[(h, w)] = row
            log(f"  device ms {case} (profiler, {TIMING_RUNS} calls): "
                + ", ".join(f"{k} {v:.4f}" for k, v in row.items()))
    return worst, times


def phase_chain(dev):
    """K5 against its plain version (TF32 off), two runs bit-equal; device
    times of K5, its plain version, and the chain's forward + backward with
    K5 against autograd with cuDNN at the two bf16 training shapes."""
    worst, times = 0.0, {}
    for i, (b, h, w, dtype) in enumerate(K5_CASES):
        x, dy, w1, w2, s1, s2 = _nhwc_case(b, h, w, dtype, dev, SEED + 10 + i)
        with torch.no_grad(), tf32_disabled():
            z1, a1, _ = blockbwd.chain_fwd(x, w1, w2, s1, s2)
        args = (x, z1, a1, dy, w1, w2, s1, s2)
        fused = blockbwd.make_chain_bwd(b, h, w, 64, dtype)
        runs = [fused(*args) for _ in range(2)]
        with tf32_disabled():
            want = blockbwd.chain_bwd_plain(*args)
        torch.cuda.synchronize()
        case = _case_name(b, h, w, dtype)
        rel, err = _held(f"chain_bwd {case}", *runs, want, K5_TOL[dtype],
                         dtype)
        worst = max(worst, err)
        log(f"  chain_bwd {case}: dx err {rel[0]:.3e}, dw1 err {rel[1]:.3e}, "
            f"dw2 err {rel[2]:.3e} of max (tol "
            + " / ".join(f"{t:.1e}" for t in K5_TOL[dtype])
            + "), 2 runs bit-equal")
        if dtype != torch.bfloat16:
            continue
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, w2)]

        def autograd_arm():
            y = blockbwd.chain_fwd(*leaves, s1, s2)[2]
            torch.autograd.grad(y, leaves, dy)

        def k5_arm():
            with torch.no_grad():
                z1_, a1_, _ = blockbwd.chain_fwd(x, w1, w2, s1, s2)
            fused(x, z1_, a1_, dy, w1, w2, s1, s2)

        row = {"chain_bwd": device_ms(lambda: fused(*args))}
        with tf32_disabled():
            row["chain_bwd plain"] = device_ms(
                lambda: blockbwd.chain_bwd_plain(*args))
        row["fwd+bwd with K5"] = device_ms(k5_arm)
        row["fwd+bwd autograd+cuDNN"] = device_ms(autograd_arm)
        times[(h, w)] = row
        log(f"  device ms {case} (profiler, {TIMING_RUNS} calls): "
            + ", ".join(f"{k} {v:.4f}" for k, v in row.items()))
    return worst, times


# each entry point's output must show its timing and projection lines
ENTRY_POINTS = (
    ("bwdproto", (r"bwd 8x80x80x64 bfloat16: cuDNN .* K3-patch .* K4-tap",
                  r"bwd 8x40x40x64 bfloat16: cuDNN .* K3-patch .* K4-tap",
                  r"gated 3x3 64-channel convs in the 's' @640 bf16 step: "
                  r"6 at 40x40, 2 at 80x80",
                  r"projected step saving .*: [-+]\d")),
    ("blockbwd", (r"chain 8x80x80x64 fwd\+bwd bfloat16: autograd\+cuDNN",
                  r"chain 8x40x40x64 fwd\+bwd bfloat16: autograd\+cuDNN",
                  r"64-channel bottleneck chains in the 's' @640 model: "
                  r"3 at 40x40",
                  r"projected step delta .*: [-+]\d")),
)


def phase_entry_points():
    """The slice's path: both prototype entry points run as a user runs
    them, each in its own process; returns each kernel's launch count
    from those runs."""
    counts = {}
    for module, patterns in ENTRY_POINTS:
        cmd = [sys.executable, "-m",
               f"yolo_from_scratch_tpu_torch.benchmarks.{module}", "--iters",
               "1"]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300, cwd=Path(__file__).resolve().parent)
        out = res.stdout + res.stderr
        log(f"{' '.join(cmd[1:])}: exit {res.returncode} in "
            f"{time.perf_counter() - t0:.1f} s")
        for line in out.splitlines():
            log(f"  {line}")
        missing = [p for p in patterns if not re.search(p, out)]
        launched = re.search(r"^launches: (.*)$", out, re.M)
        if res.returncode != 0 or missing or not launched:
            raise AssertionError(f"{module}: exit {res.returncode}, missing "
                                 f"{missing}")
        counts.update((k, int(n)) for k, n in
                      re.findall(r"(\w+) (\d+)", launched.group(1)))
    if sorted(counts) != ["chain_bwd", "conv_bwd_patch", "conv_bwd_tap"] or (
            min(counts.values()) <= 0):
        raise AssertionError(f"entry points' kernel launches: {counts}")
    return counts


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
    ptxas = path.with_suffix(".log")
    for line in (ptxas.read_text().splitlines() if ptxas.exists() else []):
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"  {line.strip()}")

    # 3. kernel vs plain version
    max_abs_err = phase_kernel_vs_plain(dev)

    # 4. the serving slice, 5. bfloat16
    state, cfg, requests, launches, (k_ms, p_ms) = phase_slice(dev)
    phase_bf16(state, cfg, requests, dev)

    # 6. conv backward kernel vs plain version
    k2_err, k2_ms, k2_plain_ms = phase_conv_bwd(dev)

    # 7. the training slice, 8. parity with the CPU, 9. throughput
    with tempfile.TemporaryDirectory() as tmp:
        k2_launches, yaml_path = phase_train_slice(dev, Path(tmp))
        phase_parity(dev, yaml_path)
        phase_throughput(dev, yaml_path)

    # 10. K3 and K4, 11. K5 against their plain versions; 12. the slice:
    # both prototype entry points
    proto_err, proto_ms = phase_prototypes(dev)
    chain_err, chain_ms = phase_chain(dev)
    proto_launches = phase_entry_points()
    log(f"prototype kernel launches through the entry points: "
        f"{proto_launches}")

    print(json.dumps({"kernels": [{
        "name": "nms_pivot_walk",
        "route": "cuda",
        "source": "yolo_from_scratch_tpu_torch/csrc/nms.cu",
        "replaces": "yolo_from_scratch_tpu/ops/nms_pallas.py:46",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "conv_bwd_3x3",
        "route": "cuda",
        "source": "yolo_from_scratch_tpu_torch/csrc/conv_bwd.cu",
        "replaces": "yolo_from_scratch_tpu/ops/conv_bwd.py:89",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
    }, *({
        "name": name,
        "route": "cuda",
        "source": f"yolo_from_scratch_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": proto_launches[name],
        "max_abs_err": err,
        "ms": times[name],
        "plain_ms": times[f"{name} plain"],
    } for name, replaces, err, times in (
        ("conv_bwd_patch", "benchmarks/bwdproto.py:58",
         proto_err["conv_bwd_patch"], proto_ms[(40, 40)]),
        ("conv_bwd_tap", "benchmarks/bwdproto.py:101",
         proto_err["conv_bwd_tap"], proto_ms[(40, 40)]),
        ("chain_bwd", "benchmarks/blockbwd.py:71", chain_err,
         chain_ms[(40, 40)])))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
