"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Drives the port's paths on the card: with the 's' model (width 0.50,
depth 0.33) at 640x640, nc=1, anchor head, random weights from a seed,
single-image and batched serving through `Predictor` and `BatchPredictor`
(host and device letterbox), training, evaluation with mAP and the anchor
k-means through the CLI; the anchor-free head at nc=80; the compact-label
training path of both heads;
then the conv-backward prototype entry points (`benchmarks/bwdproto.py`,
`benchmarks/blockbwd.py`) at the training path's 64-channel shapes. It
checks each hand-written CUDA kernel (NMS; the fused 3x3 conv backward
K2; the prototypes K3, K4 and K5) against its plain PyTorch version.
Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the kernels from `csrc/` into `build/torch_kernels/`,
   prints ptxas's registers and spills (a spill in a conv-backward or NMS
   kernel fails), the launch geometry of the four bf16 conv backwards
   (K2-K5) and the NMS kernel's mask workspace at N=4096 (B=1, 8, 32) and
   N=16,384; the conv backwards' dW workspace at B=8 80x80 must stay
   within 5 MB, K5's (two dW) within 10 MB;
3. kernel vs plain version on the card, bit-equal keep masks over
   clustered, tied, padded, 1- and 4-class boxes at B in {1, 8} and
   N in {300, 4096}, and at N=4097 (a partial last word), N=16,384 (the
   largest the wrapper takes) and B=32 at N=4096; presorted or not,
   max_keep 65 and 100 (inside a chunk of 64 ranks) or N; kernel times
   split into the mask pass and the scan, and plain times, at N=4096 and
   B=1, 8, 32;
4. the slice: serves requests, counts the kernel's launches, checks the
   detections, the TF32-off parity of the pre-NMS candidates with the CPU,
   and equality with the plain NMS on the card; prints the p50 latency and
   the NMS kernel's two passes on a request's candidates beside the bound
   (the walk's IoU tests) and the tests the mask pass does;
5. one bfloat16 request, which must be finite;
6. the conv backward kernel against its plain version (TF32 off) at the
   training path's shapes and two small ones, bit-equal across two runs;
   kernel, plain and library times (one `aten.convolution_backward` call:
   cuDNN's dgrad + wgrad, a yardstick the port never calls; at float32
   also with TF32 off, the accuracy the kernel is held to) beside the
   H100 bound (`utils/roofline.py`); at the bf16 shapes, K2 on this
   phase's inputs and on phase 10's in rounds A B B A;
7. the training slice: the CLI trains one epoch of 2 steps at batch 8 in
   bfloat16 with YOLO_FUSED_CONV_BWD=1 on a synthetic dataset, counts the
   kernel's launches, reads Adam's state back from the checkpoint it wrote
   (the optax layout, counts at 2) and serves one request from it;
8. one float32 train step (TF32 off) on the card against the port on the
   CPU: loss and gradients;
9. train img/s at batch 8, bfloat16, with the kernel on and off, the
   device time per step, and 30 steps on one batch that must lower the
   loss;
10. K3 (patch matrix) and K4 (per-tap) against their plain versions (TF32
   off) at phase 6's cases, bit-equal across two runs; device times of
   each, its plain version, the one-call library backward and K2 at the
   two bf16 shapes, beside the bound, and K2's A B B A rounds again;
11. K5 (the bottleneck chain's backward) the same way, and the chain's
   forward + backward with K5 against autograd with cuDNN;
12. the slice: `python -m yolo_from_scratch_tpu_torch.benchmarks.bwdproto
   --iters 1` and `... .blockbwd --iters 1`, each in its own process, must
   exit 0, print their timing and projection lines and launch K3, K4 and
   K5;
13. batched serving: `BatchPredictor` over B=32 seeded 640x640 uint8
   arrays, one NMS launch a batch; every image's detections finite and
   non-empty; kernel and plain NMS bit-equal on the batch's (32, 4096)
   candidates; image 0's TF32-off predictions within CORNER_TOL_PX /
   PROB_TOL of a B=1 call; `PipelinedPredictor` equal to `Predictor`; the
   batch's p50, img/s, forward and postprocess, busy share and the NMS
   kernel's two passes on the batch's candidates beside the bound;
14. the device letterbox: 480x640, 720x1280 and 1080x1920 in one bucket,
   content within 1.5/255 of the host letterbox, the pad exact;
   `BatchPredictor(device_letterbox=True)` against the host path on each
   image's top 5 detections; one `Predictor(device_letterbox=True)`
   request; the letterbox's device time;
15. the CLI on phase 7's dataset and checkpoint: `--map` evaluation and
   `--compute-anchors` exit 0 and print their lines, the NMS kernel's
   launches rise through `--map` (phase 7's training ran `--val-det`), and
   `python train_torch.py ... --compute-anchors` runs in its own process;
16. the anchor-free head ('s' @640, nc=80, seeded random weights): 20
   requests through `Predictor` at a gate every cell passes, so all 4,096
   candidates reach the NMS kernel (its launches counted, kernel == plain
   bit for bit on a request's candidates and on the same boxes with
   seeded ids of all 80 classes, the TF32-off decode against the CPU, p50
   and the kernel's two passes beside the bound); one
   `BatchPredictor` call at B=32 (one launch, kernel == plain on the
   (32, 4096) candidates, image 0 against a B=1 call); the CLI trains
   `--head anchor_free` one epoch of 2 steps at batch 8 in bf16 with
   YOLO_FUSED_CONV_BWD=1 and `--val-det` on a synthetic nc=80 dataset (the
   conv backward kernel's launches must match the model's gated convs,
   6 at 40x40 and 4 at 80x80), its checkpoint's head_type is read back,
   one request served from it and `--map` run on it (the NMS kernel's
   launches rise); one float32 step on the card (TF32 off) against the CPU
   once both foreground masks agree; train img/s and the device's busy
   share beside phase 9's anchor-head numbers;
17. compact labels, on phase 16's nc=80 data at K=64 and four images of
   label rows that stress the assignment (duplicate slots, centres on and
   off the edges, ids out of range, a full K, an empty image): the anchor
   and anchor-free assignments on the card bit-equal to the host's (to
   the CPU's device function where ids are out of range); the sparse loss
   on the card against the dense one (total and gradients on the head
   outputs within 1e-5); the mosaic and the augmentation on the card
   against the CPU with the same draws (labels, masks, targets equal,
   images within 1e-6); the CLI trains the anchor head with
   `--compact-targets --sparse-loss --device-mosaic --device-augment` and
   the anchor-free head with `--compact-targets --device-mosaic
   --device-augment flip --weight-decay 0.05`, each one epoch of 2 steps
   at b8 bf16 with YOLO_FUSED_CONV_BWD=1 and `--val-det` (the conv
   backward kernel's launches held to the gated convs, 8 and 10 a step,
   the NMS kernel's rising); the anchor-free checkpoint carries the
   optax.adamw chain and runs `--map`, the anchor checkpoint's compact
   evaluation prints the dense evaluation's P/R/F1 lines; train img/s
   through the loader, dense against compact and compact + sparse, in
   turns, with the bytes uploaded a batch and the device's busy share;
18. `--stream` on phase 16's nc=80 data at 64 train and 8 val images and
   its on-disk cache, b8 bf16, K=64, YOLO_FUSED_CONV_BWD=1: (a) a chunk
   of 4 steps replayed as one CUDA graph equals 4 eager steps of the same
   capturable optimizer bit for bit (weights, BatchNorm statistics, Adam's
   moments, metrics; cudnn.deterministic and torch's deterministic mode,
   whose warnings name any op without a deterministic kernel), for the
   anchor head (`--sparse-loss --device-mosaic --device-augment`) and the
   anchor-free head (`--device-mosaic --device-augment flip
   --weight-decay 0.05`); two replays from one state are bit-equal; the
   pool trainer equals the compact trainer on the gathered batches; (b)
   one capturable clip + Adam update within 2.5e-7 + 3 ulps of the
   non-capturable one on the same gradients; (c) img/s and the device's
   busy share of the eager step, the graphed chunk at N=4 and N=16 on a
   resident chunk and `ChunkStream` from the cache; (d) K2's launches in
   one replay, from the profiler (a captured launch is counted by the
   wrapper once, at capture); (e) `train_torch.py`'s command line trains
   `--stream --stream-chunk 4 ... --val-det` two epochs, then with
   `--stream-pool 32`: the NMS kernel's launches rise through --val-det,
   the pool run prints its ingest rate, the checkpoint's step is 16.

The line before the last is the kernels' JSON record (per kernel: launches
on the main path, largest error against the plain version, device ms of
the kernel, its plain version and the one-call library equivalent where
there is one, and the H100 bound with what bounds it, all at the same
inputs; the NMS kernel also its launches, device ms and bound on phase
13's batch, both kernels their launches on phase 16's anchor-free paths,
on phase 17's compact paths and on phase 18's stream paths); the last
line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import collections
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
import warnings
from pathlib import Path

import numpy as np
import torch

from yolo_from_scratch_tpu_torch import INV255, YoloConfig, cli
from yolo_from_scratch_tpu_torch.benchmarks import blockbwd, bwdproto
from yolo_from_scratch_tpu_torch.data import (
    DataLoader,
    YoloDataset,
    assign_device,
)
from yolo_from_scratch_tpu_torch.data.dataset import assign_targets
from yolo_from_scratch_tpu_torch.data.letterbox import (
    letterbox_device_bucketed,
    letterbox_image,
    letterbox_params,
)
from yolo_from_scratch_tpu_torch.device import cuda_device, tf32_disabled
from yolo_from_scratch_tpu_torch.infer.predict import (
    BatchPredictor,
    PipelinedPredictor,
    Predictor,
    _detections_per_image,
    _stage_batch,
    default_topk,
)
from yolo_from_scratch_tpu_torch.kernels.build import build, load_library
from yolo_from_scratch_tpu_torch.models import anchor_free
from yolo_from_scratch_tpu_torch.models.blocks import ConvBNSiLU
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import conv_bwd
from yolo_from_scratch_tpu_torch.ops import nms as nms_plain
from yolo_from_scratch_tpu_torch.ops import nms_cuda
from yolo_from_scratch_tpu_torch.ops.augment import (
    augment_batch,
    augment_compact_batch,
    augment_draws,
    step_generator,
)
from yolo_from_scratch_tpu_torch.ops.losses import yolo_loss_multiscale
from yolo_from_scratch_tpu_torch.ops.losses_sparse import (
    yolo_loss_multiscale_sparse,
)
from yolo_from_scratch_tpu_torch.ops.mosaic_device import (
    mosaic_compact_batch,
    mosaic_draws,
)
from yolo_from_scratch_tpu_torch.train.steps import (
    MOSAIC_SALT,
    create_train_state,
    make_loss_fn,
    make_train_step,
)
from yolo_from_scratch_tpu_torch.utils import roofline
from yolo_from_scratch_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    read_payload,
)
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

# torch's deterministic mode (phase 18) needs cuBLAS's fixed workspace,
# set before the first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
DW_WORKSPACE_LIMIT = 5e6  # bytes of dW partials, bf16 B=8 80x80
# the bf16 conv backward kernels and their dW: one each, two for the chain
CONV_BWD_KERNELS = (("conv3x3_bwd", 1), ("conv_bwd_patch", 1),
                    ("conv_bwd_tap", 1), ("chain_bwd", 2))
SPILL = re.compile(r"(\d+) bytes spill (?:stores|loads)")
ENTRY = re.compile(r"Compiling entry function '(\S+)'")
CONV_BWD_ENTRIES = ("conv3x3_bwd", "patch_bwd", "tap_bwd", "chain_bwd")
# the NMS kernel's two passes (csrc/nms.cu), by their names in ptxas's
# report and in the profiler
NMS_ENTRIES = ("nms_mask_pass", "nms_scan")
# phase 3: (B, N) at which every NMS case runs, and the max_keep values
# below N (65 and 100 fall inside a scan chunk of 64 ranks)
NMS_SHAPES = ((1, 300), (1, 4096), (8, 300), (8, 4096), (1, 4097),
              (1, 16384), (32, 4096))
NMS_CAPS = (65, 100)
NMS_TIMED_BATCHES = (1, 8, 32)  # at N=4096
# mask workspace printed in phase 2: (B, N)
NMS_WORKSPACES = ((1, 4096), (8, 4096), (32, 4096), (1, 16384))
IMG_SIZE = 640  # phases 7-9
EPOCH_LINE = re.compile(r"Epoch 1: Loss: .* \| LR: .* \| (\S+) img/s")
BATCH = 32            # phase 13: images a BatchPredictor call
N_BATCHES = 5         # phase 13: timed calls
MAX_OUTPUTS = 300     # BatchPredictor's default cap
PIPELINE_DEPTH = 4    # phase 13: PipelinedPredictor's requests in flight
# phase 14: (h, w) of three camera frames that share one staging bucket
LETTERBOX_SHAPES = ((480, 640), (720, 1280), (1080, 1920))
LSB = 1.5 / 255.0     # device letterbox vs PIL, as the JAX test holds it
MAP_LINES = (r"  mAP@0\.5: \d+\.\d\d%", r"  mAP@\[\.5:\.95\]: \d+\.\d\d%",
             r"  Detection P/R/F1 @conf0\.5: ")
# phase 16: the anchor-free head at the nc=80 regime. Random weights give
# every class bias U(+-1/8), so a cell's best class sits near sigmoid(0):
# every cell passes this gate and the top 4,096 reach the NMS kernel
AF_NC = 80
AF_CONF = 0.005
AF_GATED = {(40, 40): 6, (80, 80): 4}  # the bf16 AF step's gated convs
AF_TRIES = 4  # batches tried until the card's and the CPU's fg masks agree
AF_CKPT_CONF = 1e-6  # the trained checkpoint's request
# phase 17: the compact-label path on phase 16's nc=80 data
COMPACT_K = 64        # --compact-targets' default capacity
# sparse vs dense loss on the card: the same float32 terms summed in
# another order; total relative, gradients against their largest magnitude
SPARSE_TOL = 1e-5
AUG_IMAGE_TOL = 1e-6  # mosaic / jitter, card vs CPU: sums of 4, multiply-add
COMPACT_EPOCHS = 3    # timed epochs a turn, two turns a path
# phase 18: --stream on phase 16's nc=80 data, enlarged
STREAM_TRAIN, STREAM_VAL = 64, 8
STREAM_N = 4          # steps a graphed chunk in (a), (d), (e)
STREAM_N_LONG = 16    # the longer chunk of (c)
STREAM_POOL = 32      # pool images in (a) and (e)
STREAM_REPEATS = 3    # timed chunks (eager: steps x N) or epochs in (c)
STREAM_FLAGS = {"anchor": ("--sparse-loss", "--device-mosaic",
                           "--device-augment"),
                "anchor_free": ("--device-mosaic", "--device-augment flip",
                                "--weight-decay 0.05")}
# (head, trainer flags, weight decay, gated convs a step)
STREAM_RECIPES = (
    ("anchor", dict(sparse_loss=True, device_mosaic=True,
                    device_augment=True), 0.0, GATED_CONVS_BF16),
    ("anchor_free", dict(device_mosaic=True, device_augment="flip"), 0.05,
     sum(AF_GATED.values())),
)
TRACE_ATTEMPTS = 6


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


def nms_split_ms(fn, runs=TIMING_RUNS):
    """(mask pass ms, scan ms) of one call of fn, profiler device time
    over `runs` calls after 2 warm-up calls."""
    fn()
    fn()
    per = kernel_ms(fn, runs)
    parts = [sum(v for k, v in per.items() if name in k) / runs
             for name in NMS_ENTRIES]
    if min(parts) <= 0.0:
        raise AssertionError(f"the profiler saw no NMS pass: {sorted(per)}")
    return parts


def phase_kernel_vs_plain(dev):
    rng = np.random.default_rng(SEED)
    n_cases = 0
    max_abs_err = 0.0
    for b, n in NMS_SHAPES:
        for ncls in (1, 4):
            boxes, scores, classes = nms_case(rng, b, n, ncls, tied=ncls == 4)
            cpu = [torch.from_numpy(a) for a in (boxes, scores, classes)]
            gpu = [t.to(dev) for t in cpu]
            for presorted in (False, True):
                for max_keep in (*NMS_CAPS, n):
                    args = []
                    for bx, sc, cl in (cpu, gpu):
                        bx = nms_plain._class_offset_boxes(bx, cl)
                        if presorted:
                            sc, order = nms_plain.sort_desc(sc, dim=1)
                            bx = torch.gather(
                                bx, 1, order[..., None].expand(b, n, 4))
                        args.append((bx, sc))
                    kernel = nms_cuda.nms_keep_mask_batched(
                        *args[1], IOU, max_keep=max_keep, presorted=presorted)
                    plain_gpu = nms_plain.nms_keep_mask(
                        *args[1], IOU, max_keep=max_keep, presorted=presorted)
                    plain_cpu = nms_plain.nms_keep_mask(
                        *args[0], IOU, max_keep=max_keep, presorted=presorted)
                    torch.cuda.synchronize()
                    k, pg = kernel.cpu(), plain_gpu.cpu()
                    err = (k.float() - pg.float()).abs().max().item()
                    max_abs_err = max(max_abs_err, err)
                    if not (torch.equal(k, pg) and torch.equal(k, plain_cpu)):
                        raise AssertionError(
                            f"keep masks differ at B={b} N={n} "
                            f"classes={ncls} presorted={presorted} "
                            f"max_keep={max_keep}: kernel kept "
                            f"{int(k.sum())}, plain (card) {int(pg.sum())}, "
                            f"plain (CPU) {int(plain_cpu.sum())}")
                    n_cases += 1
                    log(f"  B={b} N={n} classes={ncls} presorted={presorted} "
                        f"max_keep={max_keep}: bit-equal, kept "
                        f"{int(k.sum())}")
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

    for b in NMS_TIMED_BATCHES:
        boxes, scores, _ = nms_case(rng, b, 4096, 1, tied=False)
        sc, order = nms_plain.sort_desc(torch.from_numpy(scores).to(dev), 1)
        bx = torch.gather(torch.from_numpy(boxes).to(dev), 1,
                          order[..., None].expand(b, 4096, 4))
        valid = sc > nms_plain.NEG_INF / 2
        keep = nms_plain.nms_keep_mask(bx, sc, IOU, presorted=True)

        def kernel():
            nms_cuda.nms_keep_mask_batched(bx, sc, IOU, presorted=True)

        mask_ms, scan_ms = nms_split_ms(kernel)
        k_ms = median_ms(kernel)
        runs = 3 if b > 8 else TIMING_RUNS  # the plain walk syncs each step
        p_ms = median_ms(lambda: nms_plain.nms_keep_mask(
            bx, sc, IOU, presorted=True), runs=runs, warmup=1)
        walk = roofline.nms_iou_count(keep, valid)
        bound = roofline.bound_ms(*roofline.nms_work(sc.numel(), walk),
                                  "float32")
        log(f"NMS keep mask B={b} N=4096 presorted, {int(keep.sum())} kept "
            f"in all: kernel {mask_ms + scan_ms:.4f} ms device (mask pass "
            f"{mask_ms:.4f} + scan {scan_ms:.4f}; profiler, {TIMING_RUNS} "
            f"calls), {k_ms:.4f} ms a call with its launches (CUDA events, "
            f"median of {TIMING_RUNS}); plain {p_ms:.4f} ms (CUDA events, "
            f"median of {runs}); H100 bound {bound[0]:.6f} ms ({bound[1]}, "
            f"the walk's {walk} IoU tests; the mask pass does "
            f"{roofline.nms_mask_pass_tests(valid)})")
    return max_abs_err


def _finite_nonempty(results, what):
    for i, dets in enumerate(results):
        if not dets or not np.isfinite(np.asarray(dets, np.float64)).all():
            raise AssertionError(f"{what} {i}: {len(dets)} detections, not "
                                 f"all finite")


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
    _finite_nonempty(results, "request")
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

    def kernel():
        nms_cuda.nms_keep_mask_batched(off, scores[None], IOU, presorted=True)

    mask_ms, scan_ms = nms_split_ms(kernel)
    ev_ms = median_ms(kernel)
    p_ms = median_ms(lambda: nms_plain.nms_keep_mask(
        off, scores[None], IOU, presorted=True))
    valid = scores > nms_plain.NEG_INF / 2
    n_valid = int(valid.sum())
    keep = nms_cuda.nms_keep_mask_batched(off, scores[None], IOU,
                                          presorted=True)[0]
    n_iou = roofline.nms_iou_count(keep, valid)
    bound = roofline.bound_ms(*roofline.nms_work(scores.numel(), n_iou),
                              "float32")
    k_ms = mask_ms + scan_ms
    log(f"one request on the card: forward {fwd_ms:.4f} ms, forward + "
        f"postprocess {post_ms:.4f} ms (CUDA events); NMS on its "
        f"{scores.numel()} candidates ({n_valid} above the gate, "
        f"{int(keep.sum())} kept): kernel {k_ms:.4f} ms device (mask pass "
        f"{mask_ms:.4f} + scan {scan_ms:.4f}; profiler, {TIMING_RUNS} "
        f"calls), {ev_ms:.4f} ms a call with its launches (CUDA events), "
        f"plain {p_ms:.4f} ms; H100 bound {bound[0]:.6f} ms ({bound[1]}, "
        f"the walk's {n_iou} IoU tests); the mask pass takes "
        f"{roofline.nms_mask_pass_tests(valid)} tests over the whole card, "
        f"the scan one chunk of 64 ranks after another on one SM")

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
    return state, cfg, requests, launches, (k_ms, p_ms, bound)


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


def _bound(b, h, w, dtype):
    return roofline.conv3x3_bwd_bound_ms(b, h, w, str(dtype).split(".")[1])


def _smi(query):
    """One `nvidia-smi --query-gpu` reading of the card, as printed."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _log_k2_rounds(phase, b, h, w, dtype, dev, seed):
    """K2's device ms on phase 6's inputs (A: NCHW tensors made
    channels-last) and on phase 10's (B: NCHW views of NHWC tensors), both
    from `seed`, timed in rounds A B B A, each followed by a reading of the
    SM clock, the temperature and the power draw."""
    a = _conv_case(b, h, w, dtype, dev, seed)
    x, dy, wt = _nhwc_case(b, h, w, dtype, dev, seed)[:3]
    bb = (x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2),
          wt.permute(3, 2, 0, 1).contiguous())
    rounds = []
    for label, t in (("A", a), ("B", bb), ("B", bb), ("A", a)):
        ms = device_ms(lambda t=t: conv_bwd._launch(*t))
        rounds.append(f"{label} {ms:.4f} ms "
                      f"({_smi('clocks.sm,temperature.gpu,power.draw')})")
    log(f"  K2 {_case_name(b, h, w, dtype)} in {phase}, rounds A B B A "
        f"(A phase 6's inputs, B phase 10's; profiler, {TIMING_RUNS} calls "
        f"each; then SM clock, temperature, power): " + "; ".join(rounds))


def phase_conv_bwd(dev):
    """The conv backward kernel against its plain version (TF32 off), two
    runs bit-equal; kernel, plain and one-call library backward times."""
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

        def library():
            bwdproto.library_bwd(x, dy, wt)

        ev = [median_ms(f) for f in (kernel, plain, library)]
        dev_ms = [device_ms(f) for f in (kernel, plain, library)]
        bound = _bound(b, h, w, dtype)
        times[(b, h, w, dtype)] = (*dev_ms, bound)
        fair = ""
        if dtype == torch.float32:
            # cuDNN's default TF32 misses the 1e-5 the float32 kernel is
            # held to; the fair yardstick computes in float32
            with tf32_disabled():
                lib_f32 = device_ms(library)
            fair = (f", with TF32 off {lib_f32:.4f} (kernel "
                    f"{dev_ms[0] / lib_f32:.2f}x it, {dev_ms[0] / dev_ms[2]:.2f}x "
                    f"the TF32 call)")
        log(f"  conv bwd {name}: dx err {rel_dx:.3e}, dW err {rel_dw:.3e} "
            f"of max (tol {tol_dx:.1e} / {tol_dw:.1e}), 2 runs bit-equal; "
            f"device ms (profiler, {TIMING_RUNS} calls): kernel "
            f"{dev_ms[0]:.4f}, plain {dev_ms[1]:.4f}, library "
            f"convolution_backward {dev_ms[2]:.4f}{fair}, H100 bound "
            f"{bound[0]:.4f} ({bound[1]}; kernel at "
            f"{bound[0] / dev_ms[0]:.1%} of it); per call with host launch "
            f"(CUDA events, median of {TIMING_RUNS}): {ev[0]:.4f} / "
            f"{ev[1]:.4f} / {ev[2]:.4f}")
    for i, (b, h, w, dtype) in enumerate(K2_CASES[:2]):
        _log_k2_rounds("phase 6", b, h, w, dtype, dev, SEED + i)
    (k40, p40, c40, _), (k80, p80, c80, _) = (times[K2_CASES[0]],
                                              times[K2_CASES[1]])
    log(f"conv bwd device time per bf16 train step (6 calls at 40x40 + 2 at "
        f"80x80, B=8): kernel {6 * k40 + 2 * k80:.4f} ms, plain "
        f"{6 * p40 + 2 * p80:.4f} ms, library convolution_backward "
        f"(TF32 default) {6 * c40 + 2 * c80:.4f} ms")
    return max_abs_err, times[K2_CASES[0]]


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
        f"open)")

    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    cwd = os.getcwd()
    os.chdir(workdir)
    tee = _Tee()
    try:
        conv_bwd.launches = 0
        nms_cuda.launches = 0
        with contextlib.redirect_stdout(tee):
            rc = cli.main([str(yaml_path), "--epochs", "1", "--batch-size",
                           "8", "--size", "s", "--img-size", str(IMG_SIZE),
                           "--val-det"])
        torch.cuda.synchronize()
        launches = conv_bwd.launches
        val_det_launches = nms_cuda.launches
    finally:
        os.chdir(cwd)
    out = tee.text.getvalue()
    epoch = EPOCH_LINE.search(out)
    saved = re.search(r"Training complete\. Model saved to (\S+)", out)
    want = GATED_CONVS_BF16 * TRAIN_STEPS * conv_bwd.LAUNCHES_PER_CALL
    if (rc != 0 or not epoch or not saved or f"Device: {dev.type}" not in out
            or " | Det: P " not in epoch.group(0)):
        raise AssertionError(f"training CLI: rc {rc}, output:\n{out}")
    if val_det_launches < 1:
        raise AssertionError("--val-det launched the NMS kernel no time")
    if launches != want:
        raise AssertionError(f"conv backward kernel launched {launches} "
                             f"times, want {want} ({GATED_CONVS_BF16} convs "
                             f"x {TRAIN_STEPS} steps x "
                             f"{conv_bwd.LAUNCHES_PER_CALL})")
    log(f"training slice: conv backward kernel launches {launches} "
        f"(= {GATED_CONVS_BF16} convs x {TRAIN_STEPS} steps x "
        f"{conv_bwd.LAUNCHES_PER_CALL}), epoch img/s {epoch.group(1)} "
        f"(first-step warm-up, PIL decode and eval included); --val-det: "
        f"{val_det_launches} NMS kernel launch(es), "
        f"{re.search(r'Det: [^|]*', epoch.group(0)).group(0).strip()}")

    state, cfg, meta = load_checkpoint(workdir / saved.group(1))
    dtype = "bfloat16" if dev.type == "cuda" else "float32"  # --dtype auto
    opt = meta["opt_state"] or {}
    counts = tuple(None if c is None else int(c) for c in (
        opt.get("count"),
        opt.get("inner_state", {}).get("1", {}).get("0", {}).get("count")))
    if (cfg.compute_dtype != dtype or meta["extra"] != {"step": TRAIN_STEPS}
            or counts != (TRAIN_STEPS, TRAIN_STEPS)):
        raise AssertionError(f"checkpoint: {cfg}, {meta['extra']}, optimizer "
                             f"counts {counts}")
    image = sorted((workdir / "data" / "val" / "images").glob("*.jpg"))[0]
    nms_cuda.launches = 0
    dets = Predictor(state, cfg, conf_threshold=CONF, iou_threshold=IOU,
                     device=dev)(str(image))
    if nms_cuda.launches != 1 or not np.isfinite(
            np.asarray(dets, np.float64)).all():
        raise AssertionError(f"checkpoint request: {nms_cuda.launches} NMS "
                             f"launches, {len(dets)} detections")
    log(f"checkpoint {saved.group(1)} read back: {dtype}, step "
        f"{meta['extra']['step']}, Adam's state in the optax layout (counts "
        f"{counts[0]} / {counts[1]}); one request, 1 NMS launch, {len(dets)} "
        f"detections, all finite")
    return launches, yaml_path, workdir / saved.group(1), val_det_launches


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
    return rates, busy_ms


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
    version, the one-call library backward and K2 at the two bf16 training
    shapes, beside the bound."""
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

            row["library"] = device_ms(
                lambda: bwdproto.library_bwd(xn, dyn, wo))
            row["K2"] = device_ms(lambda: conv_bwd._launch(xn, dyn, wo))
            row["bound"] = _bound(b, h, w, dtype)[0]
            times[(h, w)] = row
            log(f"  device ms {case} (profiler, {TIMING_RUNS} calls): "
                + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
                + f" (library = one convolution_backward call; bound = H100 "
                f"data sheet, {_bound(b, h, w, dtype)[1]})")
            _log_k2_rounds("phase 10", b, h, w, dtype, dev, SEED + i)
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
        row["bound"], bound_by = roofline.chain_bwd_bound_ms(
            b, h, w, str(dtype).split(".")[1])
        times[(h, w)] = row
        log(f"  device ms {case} (profiler, {TIMING_RUNS} calls): "
            + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
            + f" (no one library call computes the chain's backward: "
            f"autograd's is ~30 ops; bound = H100 data sheet, {bound_by})")
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


def phase_batch(state, cfg, dev):
    """Batched serving at B=32: one NMS launch a batch, kernel == plain on
    the batch's candidates, image 0 against a B=1 call (TF32 off), the
    pipelined client against Predictor; times."""
    predictor = BatchPredictor(state, cfg, conf_threshold=CONF,
                               iou_threshold=IOU, max_outputs=MAX_OUTPUTS,
                               device=dev)
    rng = np.random.default_rng(SEED + 2)
    images = [rng.integers(0, 256, (IMG_SIZE, IMG_SIZE, 3), dtype=np.uint8)
              for _ in range(BATCH)]
    predictor(images)  # warm-up: cuDNN handles and algorithm choice
    torch.cuda.synchronize()
    nms_cuda.launches = 0
    latencies = []
    for _ in range(N_BATCHES):
        t0 = time.perf_counter()
        results = predictor(images)  # ends in a device -> host copy
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = nms_cuda.launches
    if launches != N_BATCHES:
        raise AssertionError(f"NMS kernel launched {launches} times for "
                             f"{N_BATCHES} batches")
    _finite_nonempty(results, "batch image")
    p50 = statistics.median(latencies)
    log(f"batched serving B={BATCH}: {N_BATCHES} calls, NMS kernel launches "
        f"{launches}, detections per image {[len(d) for d in results]}")
    log(f"batch latency p50 {p50:.3f} ms (min {min(latencies):.3f}, max "
        f"{max(latencies):.3f}; host clock, {BATCH} letterbox-free 640x640 "
        f"uint8 arrays in, detection lists out): {BATCH * 1e3 / p50:.1f} "
        f"img/s")

    args = predictor.stage(images)
    with torch.inference_mode():
        img = args[0].float() * float(INV255)
        fwd_ms = median_ms(lambda: predictor.model(img), runs=5)
        post_ms = median_ms(lambda: predictor.postprocess(*args), runs=5)
        boxes, scores, classes = predictor.postprocess.candidates(*args)
    busy = sum(kernel_ms(lambda: predictor(images), 3).values()) / 3
    # host-clock split of one call: staging (stack + upload), the device
    # work, the copy back and the detection lists
    marks = [time.perf_counter()]
    staged = predictor.stage(images)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    out = predictor.postprocess(*staged)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    cpu_out = [t.cpu() for t in out]
    marks.append(time.perf_counter())
    _detections_per_image(*cpu_out, BATCH)
    marks.append(time.perf_counter())
    split = np.diff(marks) * 1e3
    log(f"one batch on the card: forward {fwd_ms:.4f} ms, forward + "
        f"postprocess {post_ms:.4f} ms (CUDA events, median of 5); device "
        f"busy {busy:.3f} ms a call (profiler, 3 calls), "
        f"{busy / p50:.0%} of the p50; host clock of one call: stage "
        f"(stack + upload) {split[0]:.3f} ms, postprocess to sync "
        f"{split[1]:.3f} ms, copy back {split[2]:.3f} ms, detection lists "
        f"{split[3]:.3f} ms")

    off = nms_plain._class_offset_boxes(boxes, classes)

    def kernel():
        nms_cuda.nms_keep_mask_batched(off, scores, IOU, max_keep=MAX_OUTPUTS,
                                       presorted=True)

    mask_ms, scan_ms = nms_split_ms(kernel)
    ev_ms = median_ms(kernel)
    p_ms = median_ms(lambda: nms_plain.nms_keep_mask(
        off, scores, IOU, max_keep=MAX_OUTPUTS, presorted=True), runs=3,
        warmup=1)
    keep = nms_cuda.nms_keep_mask_batched(off, scores, IOU,
                                          max_keep=MAX_OUTPUTS, presorted=True)
    valid = scores > nms_plain.NEG_INF / 2
    n_iou = roofline.nms_iou_count(keep, valid)
    bound = roofline.bound_ms(*roofline.nms_work(scores.numel(), n_iou),
                              "float32")
    k_ms = mask_ms + scan_ms
    log(f"NMS on the batch's {tuple(scores.shape)} candidates "
        f"({int(valid.sum())} above the gate, {int(keep.sum())} kept, "
        f"max_keep {MAX_OUTPUTS}): kernel {k_ms:.4f} ms device (mask pass "
        f"{mask_ms:.4f} + scan {scan_ms:.4f}; profiler, {TIMING_RUNS} "
        f"calls), {ev_ms:.4f} ms a call with its launches (CUDA events); "
        f"plain {p_ms:.4f} ms (median of 3); H100 bound {bound[0]:.6f} ms "
        f"({bound[1]}, the walks' {n_iou} IoU tests summed over the images); "
        f"the mask pass takes {roofline.nms_mask_pass_tests(valid)} tests")

    fixed_k = nms_cuda.batched_nms_fixed_cuda_images(
        boxes, scores, classes, IOU, MAX_OUTPUTS, presorted=True)
    fixed_p = nms_plain.batched_nms_fixed(boxes, scores, classes, IOU,
                                          MAX_OUTPUTS, presorted=True)
    if not all(torch.equal(a, b) for a, b in zip(fixed_k, fixed_p)):
        raise AssertionError("kernel and plain NMS differ on the batch's "
                             "candidates")
    plain_pred = BatchPredictor(state, cfg, conf_threshold=CONF,
                                iou_threshold=IOU, max_outputs=MAX_OUTPUTS,
                                device=dev, use_cuda_nms=False)
    if plain_pred(images) != results:
        raise AssertionError("batch detections differ between the kernel "
                             "and the plain NMS on the card")
    log(f"kernel NMS == plain NMS on the card: the batch's "
        f"{tuple(scores.shape)} candidates bit-equal, the {BATCH} detection "
        f"lists equal")

    # image 0 at B=32 against a B=1 call, TF32 off: cuDNN may pick other
    # algorithms at B=32, so within the tolerances, not bit for bit
    single = Predictor(state, cfg, conf_threshold=CONF, iou_threshold=IOU,
                       device=dev)
    one = single.stage(images[0])
    with tf32_disabled():
        batch_dec = [t[0].cpu() for t in predictor.postprocess.decode(*args)]
        batch_top = predictor.postprocess.candidates(*args)[1][0].cpu()
        one_dec = [t.cpu() for t in single.postprocess.decode(*one)]
        one_top = single.postprocess.candidates(*one)[1].cpu()
    errs = [(a.double() - b.double()).abs().max().item()
            for a, b in zip(batch_dec[:3], one_dec[:3])]
    top_err = (batch_top.double() - one_top.double()).abs().max().item()
    if (errs[0] > CORNER_TOL_PX or max(errs[1], errs[2], top_err) > PROB_TOL
            or not torch.equal(batch_dec[3], one_dec[3])):
        raise AssertionError(f"TF32 off, image 0 of the batch vs B=1: "
                             f"corners {errs[0]} px, obj {errs[1]}, cls "
                             f"{errs[2]}, sorted scores {top_err}")
    log(f"TF32 off, image 0 of B={BATCH} vs a B=1 call on all "
        f"{batch_dec[1].numel()} predictions: max |corner| err {errs[0]:.3e} "
        f"px (tol {CORNER_TOL_PX}), max |obj| err {errs[1]:.3e}, max |cls| "
        f"err {errs[2]:.3e}, sorted candidate scores {top_err:.3e} (tol "
        f"{PROB_TOL})")

    pipelined = PipelinedPredictor(state, cfg, depth=PIPELINE_DEPTH,
                                   conf_threshold=CONF, iou_threshold=IOU,
                                   device=dev)
    requests = images[:2 * PIPELINE_DEPTH]
    want = [single(img) for img in requests]
    t0 = time.perf_counter()
    got = pipelined(requests)
    pipe_s = time.perf_counter() - t0
    if got != want:
        raise AssertionError("PipelinedPredictor differs from Predictor")
    log(f"PipelinedPredictor depth {PIPELINE_DEPTH}: {len(requests)} requests "
        f"equal to Predictor's, {len(requests) / pipe_s:.1f} img/s (host "
        f"clock, one pass)")
    return launches, (k_ms, bound)


def _host_letterbox(arrays):
    from PIL import Image

    return [letterbox_image(Image.fromarray(a), IMG_SIZE) for a in arrays]


def _top_match(a, b, n=5):
    """Each of a's first n detections has a counterpart among the rows of
    b within rtol 0.05, atol 1 (the JAX test's tolerances), class equal,
    one to one."""
    ga = np.asarray(a[:n], np.float64)
    gb = np.asarray(b, np.float64)
    free = np.ones(len(gb), bool)
    for d in ga:
        close = ((np.abs(gb[:, :5] - d[:5]) <= 1.0 + 0.05 * np.abs(d[:5]))
                 .all(1) & (gb[:, 5] == d[5]) & free)
        if not close.any():
            return False
        free[np.flatnonzero(close)[0]] = False
    return len(ga) == n


def phase_device_letterbox(state, cfg, dev):
    """Three camera geometries in one bucket: the device letterbox against
    PIL, BatchPredictor(device_letterbox=True) against the host path, one
    Predictor(device_letterbox=True) request."""
    rng = np.random.default_rng(SEED + 3)
    arrays = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
              for hw in LETTERBOX_SHAPES]
    bufs, geoms, scales = (torch.from_numpy(a).to(dev)
                           for a in _stage_batch(arrays, IMG_SIZE))
    out = letterbox_device_bucketed(bufs, geoms, IMG_SIZE).cpu().numpy()
    worst = 0.0
    for i, (arr, (host, _, pad_top, pad_left)) in enumerate(
            zip(arrays, _host_letterbox(arrays))):
        hostf = host.astype(np.float32) / 255.0
        _, _, _, new_w, new_h = letterbox_params(arr.shape[1], arr.shape[0],
                                                 IMG_SIZE)
        pad = np.ones((IMG_SIZE, IMG_SIZE), bool)
        pad[pad_top:pad_top + new_h, pad_left:pad_left + new_w] = False
        content = np.abs(out[i][~pad] - hostf[~pad]).max()
        worst = max(worst, content)
        if content >= LSB or not np.array_equal(out[i][pad], hostf[pad]):
            raise AssertionError(f"device letterbox {arr.shape[:2]}: content "
                                 f"{content * 255:.3f} LSB from PIL, pad "
                                 f"exact {np.array_equal(out[i][pad], hostf[pad])}")
    lb_ms = device_ms(lambda: letterbox_device_bucketed(bufs, geoms,
                                                        IMG_SIZE))
    t0 = time.perf_counter()
    _host_letterbox(arrays)
    host_ms = (time.perf_counter() - t0) * 1e3
    log(f"device letterbox of {', '.join(f'{h}x{w}' for h, w in LETTERBOX_SHAPES)} "
        f"in one {tuple(bufs.shape[1:3])} bucket: content within "
        f"{worst * 255:.3f} LSB of PIL (limit 1.5), pad exact; "
        f"{lb_ms:.4f} ms device (profiler, {TIMING_RUNS} calls) for the "
        f"three; PIL on the host {host_ms:.1f} ms for the three (host clock)")

    kw = dict(conf_threshold=CONF, iou_threshold=IOU, device=dev)
    host_pred = BatchPredictor(state, cfg, **kw)
    dev_pred = BatchPredictor(state, cfg, device_letterbox=True, **kw)
    host_dets = host_pred(arrays)
    nms_cuda.launches = 0
    dev_dets = dev_pred(arrays)
    if nms_cuda.launches != 1:
        raise AssertionError(f"device-letterbox batch: {nms_cuda.launches} "
                             f"NMS launches")
    _finite_nonempty(dev_dets, "device-letterbox image")
    # each path's top 5 against the other's NMS input (its candidates):
    # random weights give rows of boxes whose scores tie to ~1e-7 where
    # the receptive field sees the pad, an LSB of input reorders them, and
    # the greedy walk then keeps another box of the row
    imgs = letterbox_device_bucketed(bufs, geoms, IMG_SIZE)
    cands = [
        torch.cat([c[0], c[1][..., None], c[2][..., None].float()], -1)
        .cpu().numpy()
        for c in (host_pred.postprocess.candidates(*host_pred.stage(arrays)),
                  dev_pred.postprocess.candidates(imgs, scales, geoms[:, 4],
                                                  geoms[:, 5]))]
    for i, (a, b) in enumerate(zip(host_dets, dev_dets)):
        top_a = np.asarray([d[4] for d in a[:5]])
        top_b = np.asarray([d[4] for d in b[:5]])
        if not (np.allclose(top_b, top_a, rtol=0.05, atol=0)
                and _top_match(b, cands[0][i]) and _top_match(a, cands[1][i])):
            raise AssertionError(f"image {i}: device-letterbox top 5 {b[:5]} "
                                 f"vs host {a[:5]}")
    nms_cuda.launches = 0
    one = Predictor(state, cfg, device_letterbox=True, **kw)(arrays[2])
    _finite_nonempty([one], "device-letterbox request")
    if nms_cuda.launches != 1:
        raise AssertionError(f"device-letterbox request: {nms_cuda.launches} "
                             f"NMS launches")
    log(f"BatchPredictor(device_letterbox=True) B=3: 1 NMS launch, each "
        f"image's top 5 scores within rtol 0.05 of the host path's, and "
        f"each path's top 5 boxes within rtol 0.05 / 1 px of the other's "
        f"NMS candidates "
        f"(detections {[len(d) for d in dev_dets]} vs "
        f"{[len(d) for d in host_dets]}); Predictor(device_letterbox=True) "
        f"on the 1080x1920 frame: 1 NMS launch, {len(one)} detections")
    return lb_ms


def _cli(args):
    """cli.main(args) with its stdout kept; returns (rc, stdout)."""
    tee = _Tee()
    with contextlib.redirect_stdout(tee):
        rc = cli.main(args)
    torch.cuda.synchronize()
    return rc, tee.text.getvalue()


def phase_cli(yaml_path, ckpt_path):
    """--map and --compute-anchors through the CLI on phase 7's dataset
    and checkpoint; train_torch.py in its own process."""
    nms_cuda.launches = 0
    t0 = time.perf_counter()
    rc, out = _cli([str(yaml_path), str(ckpt_path), "--map", "--batch-size",
                    "8"])
    map_launches = nms_cuda.launches
    missing = [p for p in MAP_LINES if len(re.findall(p, out)) != 2]
    if rc != 0 or missing or map_launches < 2:
        raise AssertionError(f"--map: rc {rc}, missing {missing}, "
                             f"{map_launches} NMS launches, output:\n{out}")
    log(f"--map: exit 0 in {time.perf_counter() - t0:.1f} s, "
        f"{map_launches} NMS kernel launches (a batch of up to 16 a split)")

    rc, out = _cli([str(yaml_path), "--compute-anchors"])
    if rc != 0 or "Recommended anchor configuration:" not in out:
        raise AssertionError(f"--compute-anchors: rc {rc}, output:\n{out}")
    log(f"--compute-anchors: exit 0, "
        f"{re.search(r'anchors = .*', out).group(0)}")

    cmd = [sys.executable, "train_torch.py", str(yaml_path),
           "--compute-anchors"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=Path(__file__).resolve().parent)
    if res.returncode != 0 or "P5 (large objects):" not in res.stdout:
        raise AssertionError(f"train_torch.py: exit {res.returncode}\n"
                             f"{res.stdout}\n{res.stderr}")
    log(f"python train_torch.py data.yaml --compute-anchors: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    return map_launches


def _af_cfg(**kw):
    return YoloConfig.from_size("s", num_classes=AF_NC, img_size=IMG_SIZE,
                                head_type="anchor_free", **kw)


def _gated_convs(cfg):
    """{(H, W): number of convs} that `ConvBNSiLU`'s gate sends to the
    fused backward in one train step of cfg's model at batch 1, from a
    forward on the meta device (shapes only)."""
    model = YOLO(cfg, device="meta")
    counts = collections.Counter()

    def pre_hook(mod, args):
        x, conv = args[0], mod.conv
        if conv.bias is None and conv_bwd.fused_bwd_fits(
                conv.kernel_size[0], conv.stride[0], x.shape[1],
                conv.out_channels, x.shape[2], x.shape[3], mod.dtype):
            counts[(x.shape[2], x.shape[3])] += 1

    for module in model.modules():
        if isinstance(module, ConvBNSiLU):
            module.register_forward_pre_hook(pre_hook)
    with torch.no_grad():
        model(torch.empty((1, cfg.img_size, cfg.img_size, 3), device="meta"),
              train=True)
    return dict(counts)


def _af_decode_check(what, got, want, gap):
    """Hold an anchor-free decode (corners, obj, cls_prob, cls_id) against
    another's: corners within CORNER_TOL_PX, probabilities within
    PROB_TOL, class ids equal except where the reference's two best class
    probabilities lie within 2 PROB_TOL (a near tie at nc=80 that either
    side may break). Returns (errors, ids that differ)."""
    errs = [(g.double() - w.double()).abs().max().item()
            for g, w in zip(got[:3], want[:3])]
    differ = got[3] != want[3]
    tied = gap <= 2 * PROB_TOL
    untied = int((differ & ~tied).sum())
    if errs[0] > CORNER_TOL_PX or max(errs[1:]) > PROB_TOL or untied:
        raise AssertionError(f"{what}: corners {errs[0]} px, obj {errs[1]}, "
                             f"cls {errs[2]}, class ids differing "
                             f"{int(differ.sum())} ({untied} not at a near "
                             f"tie)")
    return errs, int(differ.sum())


def _top2_gap(model, imgs_u8):
    """(B, M) gap between each cell's two best class probabilities."""
    with torch.inference_mode():
        preds = model(imgs_u8.float() * float(INV255))
        cls = torch.cat([p[..., 4 * anchor_free.REG_MAX:].reshape(
            p.shape[0], -1, AF_NC) for p in preds], dim=1).sigmoid()
        top = cls.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def _hold_nms(what, boxes, scores, classes, max_keep):
    """Raise unless the kernel's keep mask and class-aware outputs equal
    the plain version's on the card, bit for bit, for (B, N) candidates.
    Returns (kept, largest class-offset coordinate)."""
    off = nms_plain._class_offset_boxes(boxes, classes)
    keep_k = nms_cuda.nms_keep_mask_batched(off, scores, IOU,
                                            max_keep=max_keep, presorted=True)
    keep_p = nms_plain.nms_keep_mask(off, scores, IOU, max_keep=max_keep,
                                     presorted=True)
    fixed_k = nms_cuda.batched_nms_fixed_cuda_images(
        boxes, scores, classes, IOU, max_keep, presorted=True)
    fixed_p = nms_plain.batched_nms_fixed(boxes, scores, classes, IOU,
                                          max_keep, presorted=True)
    if not (torch.equal(keep_k, keep_p)
            and all(torch.equal(a, b) for a, b in zip(fixed_k, fixed_p))):
        raise AssertionError(f"anchor-free: kernel and plain NMS differ on "
                             f"{what}")
    return int(keep_k.sum()), float(off.max())


def _spread_classes(shape, dev):
    """Seeded class ids over all AF_NC classes: random weights give every
    cell the same best class (the largest class bias wins), so the
    offsets of an nc=80 model's candidates, up to 79 (max coord + 1), are
    reached only with ids drawn afresh."""
    ids = np.random.default_rng(SEED + 7).integers(0, AF_NC, shape)
    return torch.from_numpy(ids.astype(np.int32)).to(dev)


def phase_af_serving(dev):
    """Single-image and B=32 serving with the anchor-free head at nc=80:
    launches, kernel == plain NMS on the card, the card against the CPU
    and a B=1 call (TF32 off), times."""
    cfg = _af_cfg()
    meta = YOLO(cfg, device="meta")
    state = from_flax_variables(random_variables(meta, SEED), meta)
    predictor = Predictor(state, cfg, conf_threshold=AF_CONF,
                          iou_threshold=IOU, device=dev)
    rng = np.random.default_rng(SEED + 5)
    requests = [rng.integers(0, 256, (IMG_SIZE, IMG_SIZE, 3), dtype=np.uint8)
                for _ in range(N_REQUESTS)]
    k = default_topk(IMG_SIZE, 1)
    log(f"anchor-free: 's' @{IMG_SIZE} nc={AF_NC} float32, conf_threshold="
        f"{AF_CONF}, iou_threshold={IOU}, {k} NMS candidates, "
        f"{sum(p.numel() for p in predictor.model.parameters()):,} params")

    predictor(requests[0])  # warm-up
    torch.cuda.synchronize()
    nms_cuda.launches = 0
    latencies, results = [], []
    for img in requests:
        t0 = time.perf_counter()
        results.append(predictor(img))
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = nms_cuda.launches
    if launches != N_REQUESTS:
        raise AssertionError(f"anchor-free: NMS kernel launched {launches} "
                             f"times for {N_REQUESTS} requests")
    _finite_nonempty(results, "anchor-free request")
    p50 = statistics.median(latencies)

    args = predictor.stage(requests[1])
    dec = predictor.postprocess.decode(*args)
    passed = int((dec[2] > AF_CONF).sum())
    boxes, scores, classes = predictor.postprocess.candidates(*args)
    n_valid = int((scores > nms_plain.NEG_INF / 2).sum())
    if n_valid != k:
        raise AssertionError(f"anchor-free: {n_valid} of {k} candidates "
                             f"passed the gate")
    log(f"served {N_REQUESTS} anchor-free requests, NMS kernel launches "
        f"{launches}; {passed} of {dec[2].numel()} cells pass the gate, "
        f"the top {k} reach the kernel; detections per request "
        f"{[len(d) for d in results]}; p50 {p50:.3f} ms (min "
        f"{min(latencies):.3f}, max {max(latencies):.3f}; host clock)")

    kept, top = _hold_nms("a request's candidates", boxes[None],
                          scores[None], classes[None], k)
    spread = _spread_classes((1, k), dev)
    kept80, top80 = _hold_nms("a request's boxes with 80 classes' ids",
                              boxes[None], scores[None], spread, k)
    off = nms_plain._class_offset_boxes(boxes, classes)[None]

    def kernel():
        nms_cuda.nms_keep_mask_batched(off, scores[None], IOU, presorted=True)

    mask_ms, scan_ms = nms_split_ms(kernel)
    p_ms = median_ms(lambda: nms_plain.nms_keep_mask(
        off, scores[None], IOU, presorted=True), runs=3, warmup=1)
    keep = nms_cuda.nms_keep_mask_batched(off, scores[None], IOU,
                                          presorted=True)[0]
    n_iou = roofline.nms_iou_count(keep, scores > nms_plain.NEG_INF / 2)
    bound = roofline.bound_ms(*roofline.nms_work(k, n_iou), "float32")
    k_ms = mask_ms + scan_ms
    log(f"anchor-free request's NMS: kernel == plain bit for bit on its {k} "
        f"candidates ({int(classes.unique().numel())} class(es), offsets up "
        f"to {top:.0f} px, {kept} kept) and on the same boxes with seeded "
        f"ids of all {int(spread.unique().numel())} classes (offsets up to "
        f"{top80:.0f} px, {kept80} kept); kernel {k_ms:.4f} ms device (mask "
        f"pass {mask_ms:.4f} + scan {scan_ms:.4f}; profiler, {TIMING_RUNS} "
        f"calls), plain {p_ms:.4f} ms (CUDA events, median of 3); H100 bound "
        f"{bound[0]:.6f} ms ({bound[1]}, the walk's {n_iou} IoU tests)")

    cpu_pred = Predictor(state, cfg, conf_threshold=AF_CONF,
                         iou_threshold=IOU, device=torch.device("cpu"))
    cpu_args = cpu_pred.stage(requests[1])
    with tf32_disabled():
        gpu_dec = [t.cpu() for t in predictor.postprocess.decode(*args)]
    cpu_dec = cpu_pred.postprocess.decode(*cpu_args)
    gap = _top2_gap(cpu_pred.model, cpu_args[0])[0]
    errs, n_diff = _af_decode_check("anchor-free TF32-off decode vs CPU",
                                    gpu_dec, cpu_dec, gap)
    log(f"anchor-free, TF32 off, card vs CPU on all {gpu_dec[2].numel()} "
        f"cells: max |corner| err {errs[0]:.3e} px (tol {CORNER_TOL_PX}), "
        f"max |cls| err {errs[2]:.3e} (tol {PROB_TOL}); class ids equal but "
        f"{n_diff} near ties (best two within {2 * PROB_TOL})")
    return state, cfg, launches, (k_ms, p_ms, bound), p50


def phase_af_batch(state, cfg, dev):
    """One BatchPredictor call at B=32 with the anchor-free head: one NMS
    launch, kernel == plain on the (32, 4096) candidates, image 0 against a
    B=1 call (TF32 off)."""
    predictor = BatchPredictor(state, cfg, conf_threshold=AF_CONF,
                               iou_threshold=IOU, max_outputs=MAX_OUTPUTS,
                               device=dev)
    rng = np.random.default_rng(SEED + 6)
    images = [rng.integers(0, 256, (IMG_SIZE, IMG_SIZE, 3), dtype=np.uint8)
              for _ in range(BATCH)]
    predictor(images)  # warm-up
    torch.cuda.synchronize()
    nms_cuda.launches = 0
    t0 = time.perf_counter()
    results = predictor(images)
    batch_s = time.perf_counter() - t0
    launches = nms_cuda.launches
    if launches != 1:
        raise AssertionError(f"anchor-free batch: {launches} NMS launches")
    _finite_nonempty(results, "anchor-free batch image")

    args = predictor.stage(images)
    boxes, scores, classes = predictor.postprocess.candidates(*args)
    kept, _ = _hold_nms("the batch's candidates", boxes, scores, classes,
                        MAX_OUTPUTS)
    kept80, top80 = _hold_nms("the batch's boxes with 80 classes' ids",
                              boxes, scores,
                              _spread_classes(tuple(scores.shape), dev),
                              MAX_OUTPUTS)
    off = nms_plain._class_offset_boxes(boxes, classes)
    keep_k = nms_cuda.nms_keep_mask_batched(off, scores, IOU,
                                            max_keep=MAX_OUTPUTS,
                                            presorted=True)

    def kernel():
        nms_cuda.nms_keep_mask_batched(off, scores, IOU, max_keep=MAX_OUTPUTS,
                                       presorted=True)

    mask_ms, scan_ms = nms_split_ms(kernel)
    valid = scores > nms_plain.NEG_INF / 2
    bound = roofline.bound_ms(*roofline.nms_work(
        scores.numel(), roofline.nms_iou_count(keep_k, valid)), "float32")
    log(f"anchor-free BatchPredictor B={BATCH}: 1 NMS launch, "
        f"{BATCH / batch_s:.1f} img/s (host clock, one call), detections "
        f"per image {[len(d) for d in results]}; kernel == plain bit for bit "
        f"on the batch's {tuple(scores.shape)} candidates "
        f"({int(valid.sum())} above the gate, {kept} kept) and with seeded "
        f"ids of {AF_NC} classes (offsets up to {top80:.0f} px, {kept80} "
        f"kept); "
        f"kernel {mask_ms + scan_ms:.4f} ms device (mask pass {mask_ms:.4f} "
        f"+ scan {scan_ms:.4f}), H100 bound {bound[0]:.6f} ms ({bound[1]})")

    single = Predictor(state, cfg, conf_threshold=AF_CONF, iou_threshold=IOU,
                       device=dev)
    one = single.stage(images[0])
    with tf32_disabled():
        batch_dec = [t[0].cpu() for t in predictor.postprocess.decode(*args)]
        batch_top = predictor.postprocess.candidates(*args)[1][0].cpu()
        one_dec = [t.cpu() for t in single.postprocess.decode(*one)]
        one_top = single.postprocess.candidates(*one)[1].cpu()
        gap = _top2_gap(single.model, one[0])[0].cpu()
    errs, n_diff = _af_decode_check("anchor-free image 0 of the batch vs B=1",
                                    batch_dec, one_dec, gap)
    top_err = (batch_top.double() - one_top.double()).abs().max().item()
    if top_err > PROB_TOL:
        raise AssertionError(f"anchor-free image 0 vs B=1: sorted candidate "
                             f"scores {top_err}")
    log(f"anchor-free, TF32 off, image 0 of B={BATCH} vs a B=1 call: max "
        f"|corner| err {errs[0]:.3e} px, max |cls| err {errs[2]:.3e}, sorted "
        f"candidate scores {top_err:.3e} (tol {PROB_TOL}), {n_diff} class "
        f"ids at near ties")
    return launches, (mask_ms + scan_ms, bound)


def phase_af_train(dev, workdir):
    """The CLI trains --head anchor_free one epoch (2 steps of 8, bf16,
    fused backward on, --val-det) on a synthetic nc=80 dataset; its
    checkpoint serves one request and runs --map."""
    t0 = time.perf_counter()
    yaml_path = make_dataset(workdir / "af", n_train=8 * TRAIN_STEPS, n_val=8,
                             img_size=IMG_SIZE, seed=SEED, num_classes=AF_NC)
    log(f"synthetic nc={AF_NC} dataset: {8 * TRAIN_STEPS} train + 8 val "
        f"images at {IMG_SIZE} in {time.perf_counter() - t0:.2f} s")
    gated = _gated_convs(_af_cfg(compute_dtype="bfloat16"))
    want = sum(gated.values()) * TRAIN_STEPS * conv_bwd.LAUNCHES_PER_CALL
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        conv_bwd.launches = 0
        nms_cuda.launches = 0
        rc, out = _cli([str(yaml_path), "--head", "anchor_free", "--epochs",
                        "1", "--batch-size", "8", "--size", "s", "--img-size",
                        str(IMG_SIZE), "--val-det"])
        k2_launches = conv_bwd.launches
        val_det_launches = nms_cuda.launches
    finally:
        os.chdir(cwd)
    epoch = EPOCH_LINE.search(out)
    saved = re.search(r"Training complete\. Model saved to (\S+)", out)
    if (rc != 0 or not epoch or not saved or "obj: 0.0000" not in out
            or " | Det: P " not in epoch.group(0)):
        raise AssertionError(f"anchor-free training CLI: rc {rc}, output:\n"
                             f"{out}")
    if gated != AF_GATED or k2_launches != want:
        raise AssertionError(f"anchor-free step: gated convs {gated} (want "
                             f"{AF_GATED}), conv backward kernel launches "
                             f"{k2_launches} (want {want})")
    if val_det_launches < 1:
        raise AssertionError("anchor-free --val-det launched the NMS kernel "
                             "no time")
    log(f"anchor-free training slice: gated convs "
        + ", ".join(f"{n} at {h}x{w}" for (h, w), n in sorted(gated.items()))
        + f" a step; conv backward kernel launches {k2_launches} (= "
        f"{sum(gated.values())} x {TRAIN_STEPS} steps x "
        f"{conv_bwd.LAUNCHES_PER_CALL}); epoch img/s {epoch.group(1)}; "
        f"--val-det: {val_det_launches} NMS kernel launch(es)")

    ckpt = workdir / saved.group(1)
    head = read_payload(ckpt)["head_type"]
    state, cfg, _ = load_checkpoint(ckpt)
    image = sorted((workdir / "af" / "val" / "images").glob("*.jpg"))[0]
    nms_cuda.launches = 0
    # two steps barely move the class scores off the v8 prior (~1e-5 at
    # P3): a gate below it serves detections
    dets = Predictor(state, cfg, conf_threshold=AF_CKPT_CONF,
                     iou_threshold=IOU, device=dev)(str(image))
    if (head != "anchor_free" or cfg.head_type != "anchor_free"
            or nms_cuda.launches != 1
            or not np.isfinite(np.asarray(dets, np.float64)).all()):
        raise AssertionError(f"anchor-free checkpoint: head_type {head}, "
                             f"{nms_cuda.launches} NMS launches, {len(dets)} "
                             f"detections")
    nms_cuda.launches = 0
    rc, out = _cli([str(yaml_path), str(ckpt), "--map", "--batch-size", "8"])
    map_launches = nms_cuda.launches
    missing = [p for p in MAP_LINES if len(re.findall(p, out)) != 2]
    if rc != 0 or missing or map_launches < 2:
        raise AssertionError(f"anchor-free --map: rc {rc}, missing {missing}, "
                             f"{map_launches} NMS launches, output:\n{out}")
    log(f"anchor-free checkpoint {saved.group(1)}: head_type {head}; one "
        f"request, 1 NMS launch, {len(dets)} detections; --map: exit 0, "
        f"{map_launches} NMS kernel launches")
    return k2_launches, val_det_launches, map_launches, yaml_path


def _af_batch(yaml_path, split, start, batch_size, dev):
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    ds = YoloDataset(load_dataset_yaml(yaml_path)[split], AF_NC,
                     img_size=IMG_SIZE, head_type="anchor_free")
    images, targets = ds.load_batch(range(start, start + batch_size))
    return (torch.from_numpy(images).to(dev),
            [torch.from_numpy(t).to(dev) for t in targets])


def _af_fg(model, cfg, images, targets):
    """TAL's foreground mask of a train-mode forward (on a copy: the
    running statistics stay)."""
    with torch.no_grad(), tf32_disabled():
        preds = copy.deepcopy(model)(images, train=True)
        _, cls, _, xyxy, pts, _ = anchor_free._flatten_af_preds(
            preds, cfg.num_classes, cfg.img_size)
        gt = anchor_free._gather_gt(targets, cfg.num_classes)
        return anchor_free.tal_assign(torch.sigmoid(cls), xyxy, pts,
                                      *gt)["fg"].cpu()


def phase_af_parity(dev, yaml_path):
    """One float32 anchor-free train step's loss and gradients, card (TF32
    off) vs CPU, on a batch whose foreground masks agree."""
    cfg = _af_cfg()
    cpu = torch.device("cpu")
    models = {cpu: YOLO(cfg).reset_parameters(
        torch.Generator().manual_seed(SEED))}
    models[dev] = copy.deepcopy(models[cpu]).to(dev)
    for start in range(0, 2 * AF_TRIES, 2):
        batches = {d: _af_batch(yaml_path, "train", start, 2, d)
                   for d in models}
        fgs = {d: _af_fg(models[d], cfg, *batches[d]) for d in models}
        n_diff = int((fgs[dev] != fgs[cpu]).sum())
        log(f"anchor-free fg masks, card vs CPU, images {start}-{start + 1}: "
            f"{int(fgs[cpu].sum())} fg cells, {n_diff} differ")
        if n_diff == 0:
            break
    else:
        raise AssertionError(f"anchor-free fg masks differ on all "
                             f"{AF_TRIES} batches")
    totals = {}
    for device, model in models.items():
        with tf32_disabled():
            total, _ = make_loss_fn(cfg, device=device)(model,
                                                        *batches[device])
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
    log(f"anchor-free float32 step, card (TF32 off, fused conv backward "
        f"kernel) vs CPU, 's' @{IMG_SIZE} nc={AF_NC} b2: loss "
        f"{totals[dev]:.6f} vs {totals[cpu]:.6f} ({rel_loss:.2e} relative, "
        f"tol {PARITY_LOSS_TOL}); worst gradient {worst[0]:.2e} of its "
        f"tensor's max ({worst[1]}; tol {PARITY_GRAD_TOL})")
    if rel_loss > PARITY_LOSS_TOL or worst[0] > PARITY_GRAD_TOL:
        raise AssertionError("anchor-free float32 step on the card differs "
                             "from the CPU")


def phase_af_throughput(dev, yaml_path, anchor):
    """Anchor-free train img/s at batch 8, bf16, the fused backward on, and
    the device's busy share, beside phase 9's anchor-head numbers."""
    cfg = _af_cfg(compute_dtype="bfloat16")
    images, targets = _af_batch(yaml_path, "train", 0, 8, dev)
    state = create_train_state(cfg, 1e-3, seed=SEED, device=dev)
    step = make_train_step(cfg, device=dev)
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    rates = []
    for _ in range(2):
        for _ in range(WARMUP_STEPS):
            step(state, images, targets)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            step(state, images, targets)
        torch.cuda.synchronize()
        rates.append(8 * TIMED_STEPS / (time.perf_counter() - t0))
    per_kernel = kernel_ms(lambda: step(state, images, targets), 3)
    busy = sum(per_kernel.values()) / 3
    k2 = sum(v for k, v in per_kernel.items() if "conv3x3_bwd" in k) / 3
    wall = 8e3 / statistics.mean(rates)
    (a_rates, (a_busy, a_k2)) = anchor
    a_wall = 8e3 / statistics.mean(a_rates)
    log(f"train 's' @{IMG_SIZE} b8 bf16, fused conv backward on: anchor-free "
        f"nc={AF_NC} {rates[0]:.1f} / {rates[1]:.1f} img/s ({TIMED_STEPS} "
        f"steps each after {WARMUP_STEPS} warm-up; host clock, synchronized), "
        f"{wall:.2f} ms a step, device busy {busy:.2f} ms a step (profiler, 3 "
        f"steps; the kernel {k2:.3f} ms), idle {max(0.0, 1 - busy / wall):.0%}"
        f"; phase 9's anchor head nc=1 {a_rates[0]:.1f} / {a_rates[1]:.1f} "
        f"img/s, {a_wall:.2f} ms a step, busy {a_busy:.2f} ms (the kernel "
        f"{a_k2:.3f} ms), idle {max(0.0, 1 - a_busy / a_wall):.0%}")
    return rates, busy


def _compact_labels(yaml_path):
    """Phase 16's nc=80 train split at K=COMPACT_K (uint8 images, labels,
    counts), and four more label rows that stress the assignment: a full
    K with duplicated boxes (the same box twice, the same box with another
    class), centres on 0, 1, a cell edge and off the image, ids out of
    range, and an empty image with garbage padding. Returns (images,
    labels, counts, in_range): in_range[i] whether image i's ids are all in
    [0, nc), the images a host assignment can take."""
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    ds = YoloDataset(load_dataset_yaml(yaml_path)["train"], AF_NC,
                     img_size=IMG_SIZE)
    images, labels, counts = ds.load_batch_compact(range(len(ds)), COMPACT_K)
    rng = np.random.default_rng(SEED + 9)
    k = COMPACT_K
    extra = rng.uniform(-2.0, 2.0, (4, k, 5)).astype(np.float32)
    extra[:3, :, 0] = rng.integers(0, AF_NC, (3, k))
    extra[:3, :, 1:3] = rng.uniform(0.0, 1.0, (3, k, 2))
    extra[:3, :, 3:5] = rng.uniform(0.01, 0.6, (3, k, 2))
    extra[0, 1::4] = extra[0, 0::4]                       # the same box
    extra[0, 2::4, 1:] = extra[0, 0::4, 1:]               # other class
    extra[1, :8, 1:3] = [(0, 0), (1, 1), (0, 1), (0.5, 0.25), (0.125, 0.75),
                         (-0.1, 0.5), (1.2, -3.0), (0.999, 1e-4)]
    extra[2, ::3, 0] = rng.choice([-1.0, -7.0, AF_NC, 200.0], (k + 2) // 3)
    extra_counts = np.asarray([k, 16, k, 0], np.int32)
    labels = np.concatenate([labels, extra])
    counts = np.concatenate([counts, extra_counts])
    in_range = [True] * len(images) + [True, True, False, True]
    return images, labels, counts, in_range


def phase_compact_assign(dev, labels, counts, in_range):
    """The anchor and anchor-free assignments on the card, bit-equal to the
    host's (the CPU's device function where ids are out of range)."""
    cfg = YoloConfig.from_size("s", num_classes=AF_NC, img_size=IMG_SIZE)
    anchors = torch.as_tensor(cfg.anchors_array, device=dev)
    lab, cnt = torch.from_numpy(labels).to(dev), torch.from_numpy(counts).to(
        dev)
    cpu_args = (torch.from_numpy(labels), torch.from_numpy(counts),
                cfg.anchors_array)

    def anchor_device(lab, cnt, anc):
        return assign_device.assign_targets_device_batch(lab, cnt, anc,
                                                         IMG_SIZE, AF_NC)

    def af_device(lab, cnt, _):
        return anchor_free.assign_targets_anchor_free_device_batch(
            lab, cnt, IMG_SIZE, AF_NC)

    cases = (("anchor", anchor_device, lambda boxes, ids: assign_targets(
                 boxes, ids, cfg.anchors_array, IMG_SIZE, AF_NC)),
             ("anchor-free", af_device, lambda boxes, ids: anchor_free.
              assign_targets_anchor_free(boxes, ids, IMG_SIZE, AF_NC)))
    for name, device_fn, host_fn in cases:
        card = [t.cpu() for t in device_fn(lab, cnt, anchors)]
        cpu = device_fn(*cpu_args)
        for i, n in enumerate(counts):
            want = ([torch.from_numpy(t) for t in host_fn(
                labels[i, :n, 1:5], labels[i, :n, 0].astype(np.int64))]
                if in_range[i] else [t[i] for t in cpu])
            for s, (c, w) in enumerate(zip(card, want)):
                if not torch.equal(c[i], w):
                    raise AssertionError(f"{name} assignment on the card "
                                         f"differs, image {i}, scale {s}")
        written = [int(c[..., 4].sum()) for c in card]
        card_ms = median_ms(lambda: device_fn(lab, cnt, anchors), runs=5)
        log(f"{name} assignment on the card, {len(counts)} images at K="
            f"{COMPACT_K} ({int(counts.sum())} boxes): bit-equal to the host "
            f"on {sum(in_range)} images and to the CPU on the one with ids "
            f"out of range; "
            f"cells written per scale {written}; {card_ms:.3f} ms (CUDA "
            f"events, median of 5)")


def phase_sparse_loss(dev, labels, counts):
    """The sparse loss against the dense loss on the card, on the same
    labels and seeded head outputs: total and gradients."""
    cfg = YoloConfig.from_size("s", num_classes=AF_NC, img_size=IMG_SIZE)
    anchors = torch.as_tensor(cfg.anchors_array, device=dev)
    pick = list(range(4)) + list(range(len(counts) - 4, len(counts)))
    lab = torch.from_numpy(labels[pick]).to(dev)
    valid = assign_device.prefix_valid(torch.from_numpy(counts[pick]).to(dev),
                                       COMPACT_K)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    preds = [torch.randn((8, g, g, 3, 5 + AF_NC), generator=gen, device=dev)
             for g in cfg.grid_sizes]

    def dense(p):
        targets = assign_device.assign_targets_device_masked_batch(
            lab, valid, anchors, IMG_SIZE, AF_NC)
        return yolo_loss_multiscale(p, targets, anchors, AF_NC, IMG_SIZE)

    def sparse(p):
        return yolo_loss_multiscale_sparse(p, lab, valid, anchors, AF_NC,
                                           IMG_SIZE)

    out = {}
    for name, fn in (("dense", dense), ("sparse", sparse)):
        leaves = [p.clone().requires_grad_(True) for p in preds]
        total = fn(leaves)[0]
        out[name] = (total.item(), torch.autograd.grad(total, leaves))
        out[name] += (median_ms(lambda: torch.autograd.grad(
            fn(leaves)[0], leaves), runs=5),)
    rel = abs(out["sparse"][0] - out["dense"][0]) / abs(out["dense"][0])
    grad_err = max(((gs - gd).abs().max() / gd.abs().max()).item()
                   for gs, gd in zip(out["sparse"][1], out["dense"][1]))
    log(f"sparse vs dense loss on the card, 's' @{IMG_SIZE} nc={AF_NC} b8, "
        f"K={COMPACT_K}: total {out['sparse'][0]:.7f} vs "
        f"{out['dense'][0]:.7f} ({rel:.2e} relative, tol {SPARSE_TOL}); "
        f"gradients on the head outputs within {grad_err:.2e} of their "
        f"largest magnitude (tol {SPARSE_TOL}); loss + backward "
        f"{out['sparse'][2]:.3f} ms sparse vs {out['dense'][2]:.3f} ms dense "
        f"(CUDA events, median of 5)")
    if rel > SPARSE_TOL or grad_err > SPARSE_TOL:
        raise AssertionError("sparse loss on the card differs from the dense")


def phase_augment_parity(dev, images, labels, counts):
    """The mosaic and the augmentation on the card against the same
    functions on the CPU with the same explicit draws."""
    b = 8
    imgs = torch.from_numpy(images[:b]).float() * float(INV255)
    lab, cnt = torch.from_numpy(labels[:b]), torch.from_numpy(counts[:b])
    m_draws = mosaic_draws(step_generator(SEED ^ MOSAIC_SALT, 0), b)
    a_draws = augment_draws(step_generator(SEED, 0), b)
    anchors = YoloConfig().anchors_array
    outs = []
    for device in (dev, torch.device("cpu")):
        def on(*ts):
            return [None if t is None else t.to(device) for t in ts]

        m_img, m_lab, m_valid = mosaic_compact_batch(
            *on(imgs, lab, cnt), 2.0 / IMG_SIZE, *on(*m_draws))
        c_img, c_lab = augment_compact_batch(m_img, m_lab, m_valid,
                                             *on(*a_draws))
        dense = assign_device.assign_targets_device_masked_batch(
            m_lab, m_valid, anchors, IMG_SIZE, AF_NC)
        d_img, d_targets = augment_batch(m_img, dense, *on(*a_draws))
        outs.append(([t.cpu() for t in (m_img, c_img, d_img)],
                     [t.cpu() for t in (m_lab, m_valid, c_lab, *d_targets)]))
    (card_images, card_exact), (cpu_images, cpu_exact) = outs
    image_err = max((g - w).abs().max().item()
                    for g, w in zip(card_images, cpu_images))
    exact = all(torch.equal(g, w) for g, w in zip(card_exact, cpu_exact))
    log(f"mosaic ({int(m_draws[0].sum())} of {b} images) and augment "
        f"({int(a_draws[0].sum())} flipped, jitter on), card vs CPU with the "
        f"same draws: labels, masks and dense targets "
        f"{'equal' if exact else 'DIFFER'}, images within {image_err:.2e} "
        f"(tol {AUG_IMAGE_TOL})")
    if not exact or image_err > AUG_IMAGE_TOL:
        raise AssertionError("device mosaic / augment on the card differs "
                             "from the CPU")


def _eval_lines(out):
    return [line for line in out.splitlines()
            if re.match(r"  (Precision|Recall|F1 Score): ", line)]


def phase_compact_train(dev, workdir, yaml_path):
    """The CLI trains the anchor head (--sparse-loss) and the anchor-free
    head (the weight-decay recipe) on the compact path with the mosaic and
    augmentation, K2 and --val-det; compact evaluation equals dense
    evaluation; --map on the anchor-free checkpoint. Returns K1's and K2's
    launches."""
    gated = _gated_convs(YoloConfig.from_size(
        "s", num_classes=AF_NC, img_size=IMG_SIZE, compute_dtype="bfloat16"))
    per_step = conv_bwd.LAUNCHES_PER_CALL * TRAIN_STEPS
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    base = [str(yaml_path), "--epochs", "1", "--batch-size", "8", "--size",
            "s", "--img-size", str(IMG_SIZE), "--compact-targets",
            "--device-mosaic", "--val-det"]
    runs = (("anchor", ["--sparse-loss", "--device-augment"],
             sum(gated.values()), GATED_CONVS_BF16),
            ("anchor_free", ["--head", "anchor_free", "--device-augment",
                             "flip", "--weight-decay", "0.05"],
             sum(AF_GATED.values()), sum(AF_GATED.values())))
    k1 = k2 = 0
    ckpts = {}
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for head, extra, n_gated, want_gated in runs:
            conv_bwd.launches = 0
            nms_cuda.launches = 0
            t0 = time.perf_counter()
            rc, out = _cli(base + extra)
            wall = time.perf_counter() - t0
            launches = (conv_bwd.launches, nms_cuda.launches)
            epoch = EPOCH_LINE.search(out)
            saved = re.search(r"Training complete\. Model saved to (\S+)", out)
            if (rc != 0 or not epoch or not saved
                    or " | Det: P " not in epoch.group(0)):
                raise AssertionError(f"compact {head} training CLI: rc {rc}, "
                                     f"output:\n{out}")
            if n_gated != want_gated or launches[0] != n_gated * per_step:
                raise AssertionError(f"compact {head} step: {n_gated} gated "
                                     f"convs (want {want_gated}), conv "
                                     f"backward kernel launches {launches[0]}"
                                     f" (want {n_gated * per_step})")
            if launches[1] < 1:
                raise AssertionError(f"compact {head} --val-det launched the "
                                     f"NMS kernel no time")
            k2 += launches[0]
            k1 += launches[1]
            ckpts[head] = workdir / saved.group(1)
            log(f"compact {head} training through the CLI ({' '.join(extra)}"
                f"): {wall:.1f} s wall for 1 epoch of {TRAIN_STEPS} steps + "
                f"eval + --val-det; conv backward kernel launches "
                f"{launches[0]} (= {n_gated} x {TRAIN_STEPS} steps x "
                f"{conv_bwd.LAUNCHES_PER_CALL}); epoch img/s {epoch.group(1)}"
                f"; --val-det: {launches[1]} NMS kernel launch(es)")
    finally:
        os.chdir(cwd)

    meta = load_checkpoint(ckpts["anchor_free"])[2]
    chain = (meta["opt_state"] or {}).get("inner_state", {}).get("1", {})
    if sorted(chain) != ["0", "1", "2"] or int(chain["0"]["count"]) != \
            TRAIN_STEPS:
        raise AssertionError(f"anchor-free checkpoint: optimizer chain "
                             f"{sorted(chain)}, not optax.adamw's")
    t0 = time.perf_counter()
    compact = _cli([str(yaml_path), str(ckpts["anchor"]), "--batch-size", "8",
                    "--compact-targets"])
    compact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = _cli([str(yaml_path), str(ckpts["anchor"]), "--batch-size", "8"])
    dense_s = time.perf_counter() - t0
    if compact[0] or dense[0] or not _eval_lines(compact[1]) or \
            _eval_lines(compact[1]) != _eval_lines(dense[1]):
        raise AssertionError(f"compact evaluation:\n{compact[1]}\ndense:\n"
                             f"{dense[1]}")
    nms_cuda.launches = 0
    rc, out = _cli([str(yaml_path), str(ckpts["anchor_free"]), "--map",
                    "--batch-size", "8"])
    map_launches = nms_cuda.launches
    missing = [p for p in MAP_LINES if len(re.findall(p, out)) != 2]
    if rc != 0 or missing or map_launches < 2:
        raise AssertionError(f"--map on the compact anchor-free checkpoint: "
                             f"rc {rc}, missing {missing}, {map_launches} NMS "
                             f"launches, output:\n{out}")
    k1 += map_launches
    log(f"anchor-free checkpoint: optax.adamw chain (counts {TRAIN_STEPS}); "
        f"eval of the anchor checkpoint with --compact-targets "
        f"({compact_s:.1f} s) prints the dense eval's ({dense_s:.1f} s) "
        f"P/R/F1 lines {_eval_lines(dense[1])}; --map on the anchor-free "
        f"checkpoint: {map_launches} NMS kernel launches")
    return k1, k2


def phase_compact_throughput(dev, yaml_path):
    """Train img/s at b8 bf16 through the loader and the DeviceQueue,
    dense against compact and compact + sparse (the anchor head, nc=80,
    K2 on), in turns; bytes uploaded a batch; the device's busy share."""
    from yolo_from_scratch_tpu_torch.train.loop import train_epoch
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    cfg = YoloConfig.from_size("s", num_classes=AF_NC, img_size=IMG_SIZE,
                               compute_dtype="bfloat16")
    config = load_dataset_yaml(yaml_path)
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    modes = {"dense": (0, False), "compact": (COMPACT_K, False),
             "compact+sparse": (COMPACT_K, True)}
    runs = {}
    for name, (k, sparse) in modes.items():
        loader = cli._loader(config, "train", cfg, 8, shuffle=True, seed=SEED,
                             compact=k)
        images, targets = next(iter(loader))
        nbytes = images.nbytes + sum(t.nbytes for t in targets)
        state = create_train_state(cfg, 1e-3, seed=SEED, device=dev)
        step = make_train_step(cfg, device=dev, compact_targets=bool(k),
                               sparse_loss=sparse)
        train_epoch(step, state, loader, dev)  # warm-up
        runs[name] = [loader, state, step, nbytes, 0, 0.0]
    for name in list(modes) + list(modes)[::-1]:
        loader, state, step, *_ = runs[name]
        for _ in range(COMPACT_EPOCHS):
            state, *_, n, dt = train_epoch(step, state, loader, dev)
            runs[name][4] += n
            runs[name][5] += dt
    rates = {}
    for name, (loader, state, step, nbytes, n, dt) in runs.items():
        busy = sum(kernel_ms(lambda: train_epoch(step, state, loader, dev),
                             1).values())
        wall = dt / (2 * COMPACT_EPOCHS) * 1e3
        rates[name] = n / dt
        log(f"train through the loader, {name}: {rates[name]:.1f} img/s "
            f"({n} images in {2 * COMPACT_EPOCHS} epochs of {len(loader)} "
            f"steps, in turns; host clock), {nbytes:,} bytes uploaded a "
            f"batch, device busy {busy:.1f} ms of a {wall:.1f} ms epoch "
            f"({busy / wall:.0%}; profiler, 1 epoch)")
    return rates


def _stream_cfg(head):
    return YoloConfig.from_size("s", num_classes=AF_NC, img_size=IMG_SIZE,
                                compute_dtype="bfloat16", head_type=head)


def _state_tensors(state):
    """Clones of the weights, BatchNorm statistics and Adam's state."""
    out = {f"model.{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        for k, v in state.optimizer.state[p].items():
            out[f"adam.{name}.{k}"] = v.detach().clone()
    return out


def _differ(what, got, want):
    """{name: max |difference|} of the tensors that are not bit-equal."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: different state keys")
    return {k: (got[k].double() - want[k].double()).abs().max().item()
            for k in want if not torch.equal(got[k], want[k])}


def _chunk(cache, n, start, dev):
    """N steps x 8 images of the cache from row `start`, wrapping, on the
    card."""
    rows = np.arange(start, start + 8 * n) % len(cache)
    return [torch.from_numpy(np.ascontiguousarray(a[rows])).reshape(
        n, 8, *a.shape[1:]).to(dev) for a in (cache.images, cache.labels,
                                               cache.counts)]


def _launch_counts(fn):
    """{kernel name: (launches, device ms)} in one call of fn, from the
    profiler; a trace without device events is taken again (as
    utils/timing.py's kernel_ms does)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TRACE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts = {e.key: (e.count, getattr(
            e, "self_device_time_total",
            getattr(e, "self_cuda_time_total", 0.0)) / 1e3)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
        if counts:
            return counts
        time.sleep(0.5)
    raise RuntimeError("the profiler saw no kernel in a replay")


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms, torch's deterministic mode (warn
    only: the warnings name the ops without a deterministic kernel) and
    no autotuning, restored on exit."""
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            prev[:2]
        torch.use_deterministic_algorithms(prev[2], warn_only=prev[3])


def phase_stream_setup(workdir):
    """Phase 16's nc=80 synthetic data at 64 train and 8 val images, and
    its training cache."""
    from yolo_from_scratch_tpu_torch.data.cache import ensure_cache
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    t0 = time.perf_counter()
    yaml_path = make_dataset(workdir / "stream", n_train=STREAM_TRAIN,
                             n_val=STREAM_VAL, img_size=IMG_SIZE, seed=SEED,
                             num_classes=AF_NC)
    t1 = time.perf_counter()
    ds = YoloDataset(load_dataset_yaml(yaml_path)["train"], AF_NC,
                     img_size=IMG_SIZE)
    cache = ensure_cache(ds, capacity=COMPACT_K, log=None)
    log(f"phase 18 data: {STREAM_TRAIN} train + {STREAM_VAL} val nc={AF_NC} "
        f"images at {IMG_SIZE} in {t1 - t0:.2f} s; cache of {len(cache)} "
        f"images ({len(cache) * cache.image_nbytes / 1e6:.1f} MB) built in "
        f"{time.perf_counter() - t1:.2f} s")
    return yaml_path, cache


def phase_stream_graph(dev, cache):
    """(a) a graphed chunk of N against N eager steps of the same
    capturable optimizer, for both recipes; two replays from one state;
    the pool trainer against the compact trainer on the gathered batches;
    (d) K2's launches in one replay, from the profiler. Returns {head: K2
    launches in a replay}."""
    from yolo_from_scratch_tpu_torch.train import graphs
    from yolo_from_scratch_tpu_torch.train.steps import (
        make_train_step_multi_compact,
        make_train_step_multi_pool,
    )

    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    chunk = _chunk(cache, STREAM_N, 0, dev)
    replay_k2 = {}
    for head, flags, wd, n_gated in STREAM_RECIPES:
        cfg = _stream_cfg(head)
        t0 = time.perf_counter()
        with _deterministic() as caught:
            eager = create_train_state(cfg, 1e-3, seed=SEED, device=dev,
                                       weight_decay=wd)
            step = make_train_step(cfg, device=dev, compact_targets=True,
                                   augment_seed=SEED, **flags)
            per = []
            for i in range(STREAM_N):
                eager, m = step(eager, chunk[0][i], (chunk[1][i],
                                                     chunk[2][i]))
                per.append(torch.stack([m[k] for k in sorted(m)]))
            want = _state_tensors(eager)
            want_m = torch.stack(per).mean(0)
            del eager, step
            state = create_train_state(cfg, 1e-3, seed=SEED, device=dev,
                                       weight_decay=wd)
            snap = graphs.Snapshot(state.model, state.optimizer)
            trainer = make_train_step_multi_compact(
                cfg, device=dev, augment_seed=SEED, **flags)
            state, m = trainer(state, *chunk)
            got = _state_tensors(state)
            got_m = torch.stack([m[k] for k in sorted(m)])
            snap.restore()
            state.step = 0
            state, m2 = trainer(state, *chunk)
            again = _state_tensors(state)
            again_m = torch.stack([m2[k] for k in sorted(m2)])
        torch.cuda.synchronize()
        ops = sorted({str(w.message).split(" does not have")[0]
                      for w in caught if "deterministic" in str(w.message)})
        vs_eager = _differ(f"{head} graph vs eager", got, want)
        replays = _differ(f"{head} replay vs replay", again, got)
        worst = max(vs_eager.items(), key=lambda kv: kv[1],
                    default=("", 0.0))
        log(f"phase 18 {head} ({' '.join(STREAM_FLAGS[head])}): a graphed "
            f"chunk of {STREAM_N} vs {STREAM_N} eager steps of the same "
            f"capturable {'AdamW' if wd else 'Adam'} (cudnn.deterministic, "
            f"torch deterministic mode): {len(got) - len(vs_eager)} / "
            f"{len(got)} state tensors bit-equal, worst {worst[1]:.3e} "
            f"({worst[0] or '-'}); metrics {got_m.tolist()} vs "
            f"{want_m.tolist()}; two replays from one state: "
            f"{len(got) - len(replays)} / {len(got)} bit-equal, metrics "
            f"equal {torch.equal(got_m, again_m)}; ops without a "
            f"deterministic kernel: {ops or 'none'}; "
            f"{time.perf_counter() - t0:.1f} s")
        if vs_eager or not torch.equal(got_m, want_m):
            raise AssertionError(f"{head}: graphed chunk differs from the "
                                 f"eager steps: "
                                 f"{sorted(vs_eager.items())[:8]}")
        if replays or not torch.equal(got_m, again_m):
            raise AssertionError(f"{head}: two replays differ: "
                                 f"{sorted(replays.items())[:8]}")

        # (d) K2 in one replay
        snap.restore()
        state.step = 0
        counts = _launch_counts(lambda: trainer(state, *chunk))
        k2 = sum(n for k, (n, _) in counts.items() if "conv3x3_bwd" in k)
        k2_ms = sum(ms for k, (_, ms) in counts.items() if "conv3x3_bwd" in k)
        busy = sum(ms for _, ms in counts.values())
        want_k2 = n_gated * STREAM_N * conv_bwd.LAUNCHES_PER_CALL
        log(f"phase 18 {head}: one replay launches "
            f"{sum(n for n, _ in counts.values())} kernels in {busy:.2f} ms "
            f"of device time, K2 {k2} of them (= {n_gated} gated convs x "
            f"{STREAM_N} steps x {conv_bwd.LAUNCHES_PER_CALL}) in "
            f"{k2_ms:.3f} ms; profiler")
        if k2 != want_k2:
            raise AssertionError(f"{head}: {k2} K2 launches in a replay, "
                                 f"want {want_k2}")
        replay_k2[head] = k2

        if head == "anchor":
            # the pool trainer == the compact trainer on the gathered batches
            rng = np.random.default_rng(SEED)
            pool = _chunk(cache, STREAM_POOL // 8, 0, dev)
            pool = [t.reshape(STREAM_POOL, *t.shape[2:]) for t in pool]
            idx = torch.from_numpy(rng.integers(
                0, STREAM_POOL, (STREAM_N, 8), np.int32)).to(dev)
            with _deterministic():
                snap.restore()
                state.step = 0
                state, m = trainer(state, *(t[idx.long()] for t in pool))
                gathered = _state_tensors(state)
                del trainer, state, snap
                pstate = create_train_state(cfg, 1e-3, seed=SEED, device=dev,
                                            weight_decay=wd)
                pstate, pm = make_train_step_multi_pool(
                    cfg, device=dev, augment_seed=SEED, **flags)(
                    pstate, *pool, idx)
                pooled = _state_tensors(pstate)
            diff = _differ("pool vs gathered", pooled, gathered)
            log(f"phase 18 pool trainer (P={STREAM_POOL}) vs the compact "
                f"trainer on the gathered batches: {len(pooled) - len(diff)}"
                f" / {len(pooled)} state tensors bit-equal, loss "
                f"{pm['loss'].item():.6f} vs {m['loss'].item():.6f}")
            if diff or not torch.equal(pm["loss"], m["loss"]):
                raise AssertionError(f"pool trainer differs: "
                                     f"{sorted(diff.items())[:8]}")
            del pstate
        else:
            del trainer, state, snap
        torch.cuda.empty_cache()
    return replay_k2


def phase_stream_capturable(dev, cache):
    """(b) one clip + capturable Adam update against the non-capturable
    one on the same gradients: within 2.5e-7 + 3 ulps of the parameter
    (tests/test_torch_train.py's bound for clip + Adam against optax)."""
    from yolo_from_scratch_tpu_torch.train.steps import (
        TrainState,
        _make_expand,
        clip_by_global_norm_,
        make_optimizer,
    )

    cfg = _stream_cfg("anchor")
    chunk = _chunk(cache, 1, 0, dev)
    states = [create_train_state(cfg, 1e-3, seed=SEED, device=dev)]
    model = copy.deepcopy(states[0].model)
    states.append(TrainState(model, make_optimizer(model.parameters(), 1e-3,
                                                   capturable=False)))
    images, targets = _make_expand(cfg, True, dev)(
        0, chunk[0][0], (chunk[1][0], chunk[2][0]))
    total, _ = make_loss_fn(cfg, device=dev)(states[0].model, images, targets)
    total.backward()
    for p, q in zip(states[0].model.parameters(), model.parameters()):
        q.grad = p.grad.clone()
    for s in states:
        clip_by_global_norm_([p.grad for p in s.model.parameters()])
        s.optimizer.step()
    worst = (0.0, "")
    for (name, p), q in zip(states[0].model.named_parameters(),
                            model.parameters()):
        w = q.detach().double()
        err = (p.detach().double() - w).abs()
        tol = 2.5e-7 + 3 * torch.from_numpy(np.spacing(
            np.abs(q.detach().float().cpu().numpy()))).to(dev).double()
        worst = max(worst, ((err / tol).max().item(), name))
    log(f"phase 18 (b): one clip + Adam update, capturable vs not, on the "
        f"same gradients: worst error {worst[0]:.3f} of 2.5e-7 + 3 ulps "
        f"({worst[1]})")
    if worst[0] > 1.0:
        raise AssertionError("capturable Adam differs from Adam")


def _busy_ms(fn):
    return sum(kernel_ms(fn, 1).values())


def phase_stream_throughput(dev, cache):
    """(c) img/s and the card's busy share at b8 bf16 (the anchor recipe):
    the eager step, the graphed chunk at N=4 and N=16 on a resident
    chunk, and ChunkStream from the cache at N=4."""
    from yolo_from_scratch_tpu_torch.data.stream import ChunkStream
    from yolo_from_scratch_tpu_torch.train.steps import (
        make_train_step_multi_compact,
    )

    head, flags, _, _ = STREAM_RECIPES[0]
    cfg = _stream_cfg(head)
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    state = create_train_state(cfg, 1e-3, seed=SEED, device=dev)
    rows = {}

    step = make_train_step(cfg, device=dev, compact_targets=True,
                           augment_seed=SEED, **flags)
    chunk = _chunk(cache, STREAM_N, 0, dev)

    def eager():
        for i in range(STREAM_N):
            step(state, chunk[0][i], (chunk[1][i], chunk[2][i]))

    eager()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STREAM_REPEATS):
        eager()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / (STREAM_REPEATS * STREAM_N)
    rows["eager step"] = (wall, _busy_ms(eager) / STREAM_N)

    for n in (STREAM_N, STREAM_N_LONG):
        trainer = make_train_step_multi_compact(cfg, device=dev,
                                                augment_seed=SEED, **flags)
        chunk = _chunk(cache, n, 0, dev)
        t0 = time.perf_counter()
        trainer(state, *chunk)  # capture + one replay
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(STREAM_REPEATS):
            trainer(state, *chunk)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / (STREAM_REPEATS * n)
        rows[f"graph N={n}"] = (wall, _busy_ms(lambda: trainer(
            state, *chunk)) / n)
        log(f"phase 18 graph N={n}: capture + first replay "
            f"{capture_s:.2f} s")
        if n == STREAM_N:
            stream = ChunkStream(cache, batch_size=8, steps_per_chunk=n,
                                 seed=SEED, device=dev)
            stream.run_epoch(trainer, state)
            dt = 0.0
            for _ in range(STREAM_REPEATS):
                dt += stream.run_epoch(trainer, state)[3]
            steps = STREAM_REPEATS * stream.steps_per_epoch
            busy = _busy_ms(lambda: stream.run_epoch(trainer, state))
            rows[f"ChunkStream N={n}"] = (dt / steps,
                                          busy / stream.steps_per_epoch)
        del trainer, chunk
        torch.cuda.empty_cache()
    smi = _smi("name,power.limit")
    for name, (wall, busy) in rows.items():
        log(f"phase 18 (c) {name}: {8 / wall:.1f} img/s, {wall * 1e3:.2f} ms "
            f"a step (host clock, {STREAM_REPEATS} repeats), device busy "
            f"{busy:.2f} ms a step ({busy / (wall * 1e3):.0%}; profiler); "
            f"{smi}")
    return {k: 8 / v[0] for k, v in rows.items()}


def phase_stream_cli(workdir, yaml_path):
    """(e) the CLI trains --stream and --stream --stream-pool 32 two epochs
    with K2 and --val-det; K1's launches rise through --val-det, the pool
    run prints its ingest rate, the checkpoints' step is the steps taken.
    Returns (K1 launches, K2 launches counted by the wrapper)."""
    base = [str(yaml_path), "--epochs", "2", "--batch-size", "8", "--size",
            "s", "--img-size", str(IMG_SIZE), "--stream", "--stream-chunk",
            str(STREAM_N), "--compact-targets", "--device-mosaic",
            "--device-augment", "--sparse-loss", "--val-det"]
    steps = 2 * -(-STREAM_TRAIN // (8 * STREAM_N)) * STREAM_N
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    k1 = k2 = 0
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for extra, banner in (([], "double-buffered chunks of "
                                   f"{STREAM_N} steps"),
                              (["--stream-pool", str(STREAM_POOL)],
                               f"via a {STREAM_POOL}-image HBM pool")):
            conv_bwd.launches = 0
            nms_cuda.launches = 0
            t0 = time.perf_counter()
            rc, out = _cli(base + extra)
            wall = time.perf_counter() - t0
            launches = (nms_cuda.launches, conv_bwd.launches)
            epochs = re.findall(r"^Epoch \d: .*$", out, re.M)
            saved = re.search(r"Training complete\. Model saved to (\S+)", out)
            pool = bool(extra)
            if (rc != 0 or len(epochs) != 2 or not saved or banner not in out
                    or any(" | Det: P " not in e
                           or (" | ingest " in e) != pool for e in epochs)):
                raise AssertionError(f"--stream {' '.join(extra)} CLI: rc "
                                     f"{rc}, output:\n{out}")
            step = read_payload(workdir / saved.group(1))["extra"]["step"]
            if step != steps or launches[0] < 2 or launches[1] < 1:
                raise AssertionError(f"--stream {' '.join(extra)}: step "
                                     f"{step} (want {steps}), K1 launches "
                                     f"{launches[0]}, K2 {launches[1]}")
            k1 += launches[0]
            k2 += launches[1]
            log(f"phase 18 (e) CLI --stream {' '.join(extra)}: {wall:.1f} s "
                f"for 2 epochs + eval + --val-det, checkpoint step {step}; "
                f"K1 launches {launches[0]} (--val-det), K2 wrapper calls "
                f"{launches[1]} (counted at warm-up and capture, not at "
                f"replays); {epochs[-1].split(' | LR: ')[-1]}")
    finally:
        os.chdir(cwd)
    return k1, k2


def main():
    t_main = time.perf_counter()

    def done(phases):
        log(f"[{time.perf_counter() - t_main:.1f} s] phase {phases} done")

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
    spills, entry = {}, ""
    for line in (ptxas.read_text().splitlines() if ptxas.exists() else []):
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"  {line.strip()}")
        entry = (ENTRY.search(line) or [None, entry])[1]
        n = sum(int(k) for k in SPILL.findall(line))
        if n:
            spills[entry] = n
    checked = [e for e in spills
               if any(k in e for k in CONV_BWD_ENTRIES + NMS_ENTRIES)]
    log(f"ptxas: spill bytes (stores + loads) {spills or 'none'}")
    if checked:
        raise AssertionError(f"ptxas spilled in conv backward or NMS kernels "
                             f"{checked} (log above)")
    log("ptxas: no spills in the conv backward kernels (K2-K5) or the NMS "
        "kernel's two passes (K1)")
    lib = load_library()
    for b, n in NMS_WORKSPACES:
        geom = nms_cuda.geometry(lib, b, n)
        log(f"NMS B={b} N={n}: {geom.words} words a row, mask workspace "
            f"{geom.workspace_bytes / 2 ** 20:.2f} MiB, {geom.mask_blocks} "
            f"mask-pass blocks, scan chunks of {64 * geom.words * 8 // 1024} "
            f"KiB, {geom.stages} in flight ({geom.scan_smem_bytes} bytes of "
            f"shared memory)")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kernel, n_dw in CONV_BWD_KERNELS:
        geom = conv_bwd.geometry(lib, kernel, 1)
        grid, floats = conv_bwd.launch_plan(lib, kernel, 8, 80, 80, 1, sms)
        limit = n_dw * DW_WORKSPACE_LIMIT
        log(f"{kernel} bf16: {geom.tile[0]}x{geom.tile[1]} tiles, clusters "
            f"of {geom.cluster}, {geom.max_clusters} resident on {sms} SMs; "
            f"B=8 80x80: {grid} blocks, dW workspace {floats * 4 / 1e6:.2f} "
            f"MB (limit {limit / 1e6:.0f})")
        if floats * 4 > limit:
            raise AssertionError(f"{kernel}: dW workspace over the limit")

    done("1-2")

    # 3. kernel vs plain version
    max_abs_err = phase_kernel_vs_plain(dev)
    done(3)

    # 4. the serving slice, 5. bfloat16
    state, cfg, requests, launches, (k_ms, p_ms, k1_bound) = phase_slice(dev)
    phase_bf16(state, cfg, requests, dev)
    done("4-5")

    # 6. conv backward kernel vs plain version
    k2_err, (k2_ms, k2_plain_ms, k2_lib_ms, k2_bound) = phase_conv_bwd(dev)
    done(6)

    with tempfile.TemporaryDirectory() as tmp:
        # 7. the training slice (with --val-det), 8. parity with the CPU,
        # 9. throughput
        k2_launches, yaml_path, ckpt_path, val_det_launches = \
            phase_train_slice(dev, Path(tmp))
        phase_parity(dev, yaml_path)
        rates, busy_ms = phase_throughput(dev, yaml_path)
        done("7-9")

        # 10. K3 and K4, 11. K5 against their plain versions; 12. the
        # slice: both prototype entry points
        proto_err, proto_ms = phase_prototypes(dev)
        chain_err, chain_ms = phase_chain(dev)
        proto_launches = phase_entry_points()
        log(f"prototype kernel launches through the entry points: "
            f"{proto_launches}")
        done("10-12")

        # 13. batched serving, 14. the device letterbox, 15. the CLI's
        # --map and --compute-anchors
        batch_launches, (batch_ms, batch_bound) = phase_batch(state, cfg, dev)
        phase_device_letterbox(state, cfg, dev)
        map_launches = phase_cli(yaml_path, ckpt_path)
        log(f"NMS kernel launches through the entry points: --val-det "
            f"{val_det_launches}, --map {map_launches}")
        done("13-15")

        # 16. the anchor-free head: serving, B=32, the CLI's training,
        # checkpoint and --map, parity with the CPU, throughput
        af_state, af_cfg, af_launches, (af_k_ms, af_p_ms, af_bound), _ = \
            phase_af_serving(dev)
        af_batch_launches, (af_batch_ms, af_batch_bound) = phase_af_batch(
            af_state, af_cfg, dev)
        af_k2_launches, af_val_det, af_map, af_yaml = phase_af_train(
            dev, Path(tmp))
        phase_af_parity(dev, af_yaml)
        phase_af_throughput(dev, af_yaml, (rates["1"], busy_ms["1"]))
        log(f"anchor-free path's kernel launches: NMS {af_launches} "
            f"(requests) + {af_batch_launches} (B={BATCH}) + {af_val_det} "
            f"(--val-det) + {af_map} (--map); conv backward {af_k2_launches}")
        done(16)

        # 17. compact labels: the device assignment, the sparse loss, the
        # mosaic and augmentation against their references, both heads'
        # compact training through the CLI, throughput through the loader
        images, labels, counts, in_range = _compact_labels(af_yaml)
        phase_compact_assign(dev, labels, counts, in_range)
        phase_sparse_loss(dev, labels, counts)
        phase_augment_parity(dev, images, labels, counts)
        compact_k1, compact_k2 = phase_compact_train(dev, Path(tmp), af_yaml)
        phase_compact_throughput(dev, af_yaml)
        log(f"compact path's kernel launches: NMS {compact_k1} (--val-det "
            f"both heads + --map), conv backward {compact_k2}")
        done(17)

        # 18. --stream: the cache, graphed chunks against eager steps,
        # capturable Adam, throughput, K2 in a replay, the CLI
        stream_yaml, cache = phase_stream_setup(Path(tmp))
        stream_k2 = phase_stream_graph(dev, cache)
        phase_stream_capturable(dev, cache)
        phase_stream_throughput(dev, cache)
        stream_k1, stream_k2_calls = phase_stream_cli(Path(tmp), stream_yaml)
        log(f"stream path's kernel launches: NMS {stream_k1} (--val-det, "
            f"both CLI runs); conv backward in one replay of {STREAM_N} "
            f"steps {stream_k2} (profiler), {stream_k2_calls} wrapper calls "
            f"at the CLI's warm-ups and captures")
        done(18)

    print(json.dumps({"kernels": [{
        "name": "nms_bitmask",
        "route": "cuda",
        "source": "yolo_from_scratch_tpu_torch/csrc/nms.cu",
        "replaces": "yolo_from_scratch_tpu/ops/nms_pallas.py:46",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None,
        "batch_launches": batch_launches,
        "batch_ms": batch_ms,
        "batch_bound_ms": batch_bound[0],
        "af_launches": af_launches,
        "af_ms": af_k_ms,
        "af_plain_ms": af_p_ms,
        "af_bound_ms": af_bound[0],
        "af_batch_launches": af_batch_launches,
        "af_batch_ms": af_batch_ms,
        "af_batch_bound_ms": af_batch_bound[0],
        "af_val_det_launches": af_val_det,
        "af_map_launches": af_map,
        "compact_launches": compact_k1,
        "stream_launches": stream_k1,
    }, {
        "name": "conv_bwd_3x3",
        "route": "cuda",
        "source": "yolo_from_scratch_tpu_torch/csrc/conv_bwd.cu",
        "replaces": "yolo_from_scratch_tpu/ops/conv_bwd.py:89",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": k2_lib_ms,
        "af_launches": af_k2_launches,
        "compact_launches": compact_k2,
        "stream_launches": stream_k2["anchor"],
        "stream_af_launches": stream_k2["anchor_free"],
    }, *({
        "name": name,
        "route": "cuda",
        "source": f"yolo_from_scratch_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": proto_launches[name],
        "max_abs_err": err,
        "ms": times[name],
        "plain_ms": times[f"{name} plain"],
        "bound_ms": times["bound"],
        "bound_by": bound_by,
        "library_ms": times.get("library"),
    } for name, replaces, err, times, bound_by in (
        ("conv_bwd_patch", "benchmarks/bwdproto.py:58",
         proto_err["conv_bwd_patch"], proto_ms[(40, 40)],
         _bound(8, 40, 40, torch.bfloat16)[1]),
        ("conv_bwd_tap", "benchmarks/bwdproto.py:101",
         proto_err["conv_bwd_tap"], proto_ms[(40, 40)],
         _bound(8, 40, 40, torch.bfloat16)[1]),
        ("chain_bwd", "benchmarks/blockbwd.py:71", chain_err,
         chain_ms[(40, 40)],
         roofline.chain_bwd_bound_ms(8, 40, 40, "bfloat16")[1])))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
