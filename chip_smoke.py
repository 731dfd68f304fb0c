"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Drives the port's paths on the card: with the 's' model (width 0.50,
depth 0.33) at 640x640, nc=1, anchor head, random weights from a seed,
single-image and batched serving through `Predictor` and `BatchPredictor`
(host and device letterbox), training, evaluation with mAP and the anchor
k-means through the CLI; the anchor-free head at nc=80; the compact-label
training path of both heads; int8 serving and the frozen serving
artifacts of both heads;
then the conv-backward prototype entry points (`benchmarks/bwdproto.py`,
`benchmarks/blockbwd.py`) at the training path's 64-channel shapes. It
checks each hand-written CUDA kernel (NMS; the fused 3x3 conv backward
K2; the prototypes K3, K4 and K5; the int8 kernels Q1 and Q2) against its
plain PyTorch version.
Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the kernels from `csrc/` into `build/torch_kernels/`,
   prints ptxas's registers and spills (a spill in a conv-backward, NMS
   or int8 kernel fails), the launch geometry of the four bf16 conv backwards
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
   the pool run prints its ingest rate, the checkpoint's step is 16;
19. the trainer's recipe on phase 16's nc=80 data, 's' @640 b8 bf16,
   YOLO_FUSED_CONV_BWD=1: (a) the CLI trains `--ema --val-det` 2 epochs and
   then `--resume` from its checkpoint with `--ema` to epoch 3 (the JAX
   CLI's resume line, the checkpoint's step 3 epochs of steps, its model
   the EMA and apart from extra.raw_params, K2 launched for every step's
   gated convs, the NMS kernel through --val-det and one request served
   from the checkpoint); (b) 2 epochs straight equal 1 epoch +
   `restore_train_state` + 1 epoch bit for bit with an EMA (weights,
   BatchNorm statistics, Adam's moments and steps, the EMA, the
   checkpoints), deterministic as in phase 18; (c) the anchor-free recipe
   with `af_hp`, a `make_step_lr` schedule and `ema_decay` through
   `make_train_step_multi_compact`: a graphed chunk of 4 equals 4 eager
   steps bit for bit (the EMA and the learning rate each step saw
   included), two replays bit-equal, K2's launches in one replay from the
   profiler; (d) `--multi-scale` trains 3 epochs, one in each bucket (480,
   640, 800), K2's launches in each held to the gated convs at that size,
   and K2 against its plain version at the buckets' new bf16 shapes; (e)
   `--augment` trains an epoch; one float32 step of
   `make_train_step_accum(n_accum=2)` (TF32 off) against the CPU within
   phase 8's tolerances, K2 once a micro-batch for each gated conv; (f)
   informative img/s and busy shares: the eager step with and without
   EMA, the graphed recipe chunk with and without `ema_decay` +
   `step_lr`, each multi-scale bucket's eager step;
20. int8 serving and the frozen serving artifacts, 's' @640 nc=80 bf16,
   both heads, on phase 17's checkpoints: (a) Q1 (quantize) and Q2 (the
   int8 conv, `csrc/int8_conv.cu`) against their plain versions at each
   of the 24 distinct quantized convs (k, s, cin, cout at its first
   grid), B=1 and B=32, and five shapes off the model's grid at B=2: Q1's
   int8 and Q2's int32 accumulator, bf16 and float32 outputs bit-equal;
   Q2's launch geometry (`int8_conv_geometry`)
   held to N >= cout, at most 227 KB of shared memory and tiles that
   cover the output; device ms (profiler) beside the H100 bound, summed
   at each batch, and, at B=32, the yardsticks `torch._int_mm` on the
   im2col and the bf16 `F.conv2d`; at the 1x1 stride-1 shapes `torch.
   _int_mm` on xq viewed (M, Cp), Q2's exact int32 accumulator in one call
   (checked equal), against Q2 with its epilogue; (b) the main path with the counts at 0: the CLI's
   `--int8` request and one B=32 int8 `BatchPredictor` call (Q1 and Q2
   once a quantized conv a forward, K1 once a call); the candidates
   against the same path with plain Q1/Q2 on the card, K1's keep masks
   against the plain NMS's where they are equal, the probabilities
   within 2e-3 of the bf16 float path; request p50, B=32 img/s and the
   busy share, int8 and bf16; (c) `--export` at batch 8, float and
   `--int8`, for each head (of the checkpoints with their gate biases
   raised, so that the CLI's gate of 0.5 keeps detections), each
   artifact served in a fresh interpreter that loads no model module,
   K1's, Q1's and Q2's launches in one call counted there by the
   profiler, its detections equal to the live `BatchPredictor`'s on the
   same staged batch (rtol 1e-5, atol 1e-4);
21. data parallelism, 's' @640 nc=80 on phase 16's data: (b) the CLI's
   `--distributed --num-processes 1` (NCCL) with `--val-det`, K2 on,
   against the same command line without it, deterministic as in phase
   18: the checkpoints bit-equal, K1's and K2's launches counted; (c) two
   ranks on the one card (`gloo` on CUDA tensors, float32, TF32 off, 4
   images each, one process each) against one process on the global
   batch of 8: one step's loss and gradients within phase 8's
   tolerances, the BatchNorm statistics within the CPU tests' tolerance
   and equal on both ranks, K2's launches on each rank the gated convs x
   2, and the sharded `--val-det` counts on a split of 7 images equal to
   one process's. (a), the native loader against PIL, is not here: the
   card's machine has no libjpeg or libpng headers (nor their shared
   libraries), so the library does not build there, and the dataset's
   `auto` backend falls back to PIL as the JAX package's does; the CPU
   tests hold the loader (`tests/test_torch_native.py`);
22. spatial partitioning (`--spatial`), 's' @640 nc=80 on phase 16's
   data: (a) two ranks on the one card (`gloo` on CUDA tensors, one
   process each), each holding half the rows of a global batch of 4,
   float32 TF32 off, against one process on the batch, for the anchor
   head (dense targets) and the anchor-free head (compact labels, on the
   first batch whose foreground masks agree): one step's loss (the
   ranks' parts summed) within 1e-6 relative (the anchor-free loss 1e-5:
   SP_LOSS_RTOL says why), gradients within phase 8's
   tolerance, BatchNorm statistics within 1e-5 of the largest magnitude,
   the ranks' weights bit-equal; (b) the same step in bf16 with
   YOLO_FUSED_CONV_BWD=1, K2's launches a rank held to the gated convs
   (8 and 10), and K2 at the haloed tiles of --spatial 2 (B=4 42x80 and
   22x40) against its plain version, two runs bit-equal, with its device
   ms, its plain version's, the one-call library backward's and the H100
   bound; (c) the CLI's `--data-parallel --distributed --spatial 2` with
   `--val-det`, one epoch of 2 steps, each head in two processes and the
   anchor head in four (2 x 2): the same epoch line on every rank, K1's
   launches on every rank, K2's held to the gated convs, rank 0's
   checkpoint served (the 2 x 2 run one step of the 16 images, the three
   runs at once).
23. model parallelism on phase 16's data, 's' @640 nc=80: (a) two ranks on
   the one card (`gloo` on CUDA tensors), 1 x 2 data x model, each holding
   its channel slices of the model and the whole global batch of 4,
   YOLO_FUSED_CONV_BWD=1, float32 TF32 off, against one process with K2,
   both heads: one step's loss within phase 8's 1e-4 relative, the
   gathered gradients within its 1e-3 of each tensor's max, the gathered
   weights equal on both ranks (the anchor-free head on the first batch
   whose foreground masks agree), K2 launched 12 times a rank (the 40x40
   convs the float32 gate takes); then bf16: K2 launched at the global
   64->64 shapes, 16 / 20 times a rank (anchor / anchor-free), K2 at those shapes
   (B=4 80x80 and 40x40) against its plain version with its device ms, its
   plain version's, the library backward's and the H100 bound, the loss
   within 1e-2 relative of one process with K2, the gathered weights equal
   on both ranks (the worst gradient is logged); (b) the parameters and
   Adam moments a rank holds, at most 0.55x one process's; (c) the CLI's
   `--data-parallel --distributed --model-parallel 2` with `--val-det`,
   one bf16 epoch of 2 steps at b8, each head in two processes and the
   anchor head in four (2 x 2), the three runs at once: JAX's banners and
   the same epoch line on
   every rank, K2's launches held to the gated convs, rank 0's checkpoint
   at full size served through K1 by a one-process `Predictor`.
24. the compositions of a world larger than one, on phase 16's data, 's'
   @640 nc=80: (a) `--compact-targets --device-mosaic` in two ranks on the
   one card (`gloo` on CUDA tensors), one global batch of 4, on the 1-D
   mesh (partners from the batch gathered over the ranks), 1 x 2 data x
   space (whole images composed, their rows cut after the mosaic) and
   1 x 2 data x model, the three launches at once: the anchor head in
   float32 TF32 off against one process on the global batch with the
   same draws at phases 21 (c), 22 (a) and 23 (a)'s tolerances, both heads
   in bf16 with K2 against one process with K2 (the loss at phase 23's
   1e-2), K2's launches a rank held to the gated convs, the ranks'
   gathered states bit-equal; (b) the chunk with collectives in it:
   (1) a bare `all_reduce` captured in a CUDA graph on an NCCL world of
   one and replayed twice, then the scanned trainer on that group, its
   collectives in the graph, K2's launches in one replay from the
   profiler; (2) the CLI's `--distributed --stream` at a world of one over
   NCCL against the flagless `--stream`, deterministic, checkpoints
   bit-equal; (3) two `gloo` ranks' eager chunk of 4 steps (two images a
   rank, float32 TF32 off, the mosaic's partners gathered) against one
   process's graphed chunk on the batch of 4, the mean loss and the
   BatchNorm statistics at phase 21 (c)'s tolerances; (c) the CLI's
   `--multi-scale --val-det` one-epoch runs in two processes each, the
   three at once: 1-D at 640, `--spatial 2 --img-size 768` and
   `--model-parallel 2`: the bucket banner, the same epoch line on both
   ranks, K1's launches on every rank, K2's held to the first bucket's
   gated convs, rank 0's checkpoint at full size served through K1; once
   they are done, K2 at the haloed tiles that `--spatial 2`'s first
   bucket, 576, gives it (B=8, 38x72 and 20x36, bf16) against its plain
   version with the device ms as in phase 22 (b). Two ranks of NCCL
   cannot share one card, so the NCCL chunk graph at a world larger than
   one is not run here.
25. `--spatial N` on P5 grids that N does not divide (the block plan of
   `parallel/mesh.py::row_split`), on phase 16's data, 's' nc=80 compact
   labels: (a) ranks on the one card (`gloo`), a global batch of 4, the
   three meshes at once: 1 x 2 @608 (P5 rows 10 / 9), 1 x 3 @640
   (7 / 7 / 6) and 1 x 4 @96 (1 / 1 / 1 / 0), float32 TF32 off against
   one process at phase 22 (a)'s gradient and BatchNorm tolerances (the
   loss at phase 21 (c)'s 1e-4, phase 22's 1e-6 logged), both heads, every rank's
   state bit-equal; at 608 and 640 also bf16 with K2 on against one
   process with K2 (loss 5e-3 relative), K2's launches a rank held to the
   gated convs and the tiles it ran at logged; (c) the CLI's
   `--distributed --spatial 2` in two processes a run, the four at once:
   both heads `--compact-targets --img-size 608 --val-det` (the same
   epoch line on both ranks, K1 on every rank, K2 held to the gated
   convs, rank 0's checkpoint served through K1), `--compact-targets
   --multi-scale` at 640 (buckets 480 / 640 / 800, one step each) and a
   dense `--img-size 608` run, which exits 1 on both ranks with the line
   that says JAX refuses it too; (b) once they are done, K2 at those
   blocks' haloed tiles (B=8 bf16: 42x76, 38x76, 22x38, 20x38 at 608;
   30x80, 26x80, 16x40, 14x40 at 640) against its plain version, with
   the device ms of the kernel, the plain version and the library call
   beside the bound; (d) `utils/roofline.py::summarize` for 's' @640 b8
   bf16 (nc=1 and nc=80): forward GFLOP, the step floor, the roofline
   img/s and the MFU of phases 9 and 18's rates in this run; then
   `utils/metrics_log.py::profiler_trace` around two training steps with
   K2 on: the trace file, its CUDA kernel events and K2's 32 among them.
26. the space-to-depth packed layouts (`--packed stem|interior|p3`,
   `models/packed.py`), 's' @640: (a) seeded random weights carried into
   the packed and the unpacked model, both heads, each layout: float32
   TF32 off, eval and train-mode outputs within 1e-4 of their max,
   BatchNorm statistics within 1e-5, gradients within 1e-3 of each
   tensor's max; bf16 with K2 on, the mean train-mode loss over phase
   18's 64 images (8 batches of 8) within 5e-3 relative of the unpacked
   model's, beside the noise floor (the unpacked model on NCHW-contiguous
   images, whose bf16 loss parts from itself by 1-4% a batch), and K2's
   launches in a train step from the profiler (16 / 20 unpacked and under
   stem, 20 / 24 under interior and p3, anchor / anchor-free); a graphed
   chunk of 4 packed p3 steps (phase 18's anchor
   recipe, the packed mosaic and flip) bit-equal to 4 eager steps; (b) K2
   at the packed C3a conv (B=8, 64 x 80 x 80 bf16) against its plain
   version, its device ms beside the library call's; (c) the CLI:
   `--packed p3` training 2 steps with `--val-det`, both heads (K2 held to
   the gated convs, K1 launched), a request from each checkpoint;
   `--packed p3 --stream` one epoch from a packed cache; `--packed stem
   --data-parallel` at a world of one; (d)
   packed against unpacked on the card: the stem's and the whole
   forward's device ms at b8 bf16, an eager step's device and host-clock
   ms, the graphed chunk's img/s at N=4, a B=32 `BatchPredictor` call's
   p50, each beside the card's name and power limit.
27. The packed layouts' compositions, 's' @640 nc=80 bf16 on phase 17's
   checkpoints and phase 16's data: (a) Q2 at the packed 2x2 convs padded
   (1, 0) of each layout (4 shapes), B=1 and 32, bit-equal to its plain
   version, two runs bit-equal, its device ms beside the bound, the bf16
   F.conv2d and torch._int_mm on the im2col; (b) `--packed p3 --int8`,
   both heads: the CLI's request and a B=32 `BatchPredictor` call (Q1,
   Q2, K1 counted, and from the profiler), probabilities within 2e-3 of
   the unpacked int8 and the packed float paths, request p50 and card
   time beside the unpacked int8 path's; (c) packed p3 artifacts, float
   and int8, exported at B=8 and served in fresh interpreters, equal to
   the live packed predictor, K1 and Q2 in the profiler; (d) the packed
   p3 step on row blocks, 2 and 3 gloo ranks at 640 (P5 rows 10 / 10 and
   7 / 7 / 6), float32 against one process at phase 22's and 25's
   tolerances, bf16 with K2 on the packed C3a convs' haloed tiles, K2 at
   those tiles against its plain version and the library call; (e) the
   packed p3 step on a 1 x 2 model mesh against one process at phase
   23's tolerances, K2's launches at the global shapes, the share of
   parameters and moments a rank holds; (f) the CLI's `--packed-stem
   --export` (its artifact serving a request) and `--packed-interior
   --model-parallel 2` and `--packed stem --spatial 2` in two processes
   each, exit 0 (`--packed p3 --int8` ran in (b)).
28. L1, the letterbox on the card (`csrc/letterbox.cu`): bit for bit
   against PIL's `letterbox_image` and its plain version on the card at
   ten frame sizes in one batch (scale 1, shrink, enlarge, odd, the 1-px
   clamp), pixel and packed layouts, one launch a batch with its
   resampled images counted; at B=32 on the serving cells' 640x480 /
   480x640 frames and on 1920x1080 frames, its device ms beside its bound
   (bytes), the plain version's, the host's staging and upload and the
   host PIL path it replaced.

The line before the last is the kernels' JSON record (per kernel: launches
on the main path, largest error against the plain version, device ms of
the kernel, its plain version and the one-call library equivalent where
there is one, and the H100 bound with what bounds it, all at the same
inputs; the NMS kernel also its launches, device ms and bound on phase
13's batch, both kernels their launches on phase 16's anchor-free paths,
on phase 17's compact paths, on phase 18's stream paths, on phase
19's recipe paths, on phase 20's int8 and artifact paths, on phase
21's data-parallel paths, on phase 22's spatial paths, on phase 23's
model-parallel paths, on phase 24's world compositions (K2's
`mosaic_launches`, `stream_world_launches` and
`multiscale_world_launches`, K1's `multiscale_world_launches`) and on
phase 25's unequal blocks (`uneven_launches`), on phase 26's packed
paths (`packed_launches`) and on phase 27's packed compositions
(`packed_int8_launches`, `packed_artifact_launches`,
`packed_mesh_launches`), L1 its times at phase 28's two batches
(`timed`), K2 also
its times and bounds at phase 26 (b)'s packed C3a conv (`packed_c3a`),
phase 22's
haloed tiles, phase 23's global shapes, phase 24 (c)'s tiles
(`multiscale_world_tiles`) and phase 25 (b)'s (`uneven_tiles`); Q1 and Q2
their launches on phase 20's main path and in the artifacts, with their
times, bounds and yardsticks summed over the 24 shapes at B=32, and on
phase 27's packed paths; Q2 its times at phase 27 (a)'s packed 2x2
shapes (`packed_2x2`) and K2 at phase 27 (d)'s packed haloed tiles
(`packed_spatial_tiles`)); the last
line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import copy
import io
import json
import os
import re
import socket
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
from yolo_from_scratch_tpu_torch.data.cache import cache_dir_for
from yolo_from_scratch_tpu_torch.data.dataset import assign_targets
from yolo_from_scratch_tpu_torch.data.letterbox import (
    letterbox_device_bucketed,
    letterbox_image,
    letterbox_params,
    pack_s2d_host,
)
from yolo_from_scratch_tpu_torch.device import cuda_device, tf32_disabled
from yolo_from_scratch_tpu_torch.infer.detections import detections_per_image
from yolo_from_scratch_tpu_torch.infer.predict import (
    BatchPredictor,
    PipelinedPredictor,
    Predictor,
    _stage_batch,
    default_topk,
    letterbox_input,
)
from yolo_from_scratch_tpu_torch.kernels.build import build, load_library
from yolo_from_scratch_tpu_torch.models import anchor_free
from yolo_from_scratch_tpu_torch.models.blocks import ConvBNSiLU
from yolo_from_scratch_tpu_torch.models.packed import pack_s2d
from yolo_from_scratch_tpu_torch.models.yolo import YOLO, cast_convs_
from yolo_from_scratch_tpu_torch.ops import conv_bwd, letterbox_cuda
from yolo_from_scratch_tpu_torch.ops import nms as nms_plain
from yolo_from_scratch_tpu_torch.ops import nms_cuda
from yolo_from_scratch_tpu_torch.ops import quant
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
from yolo_from_scratch_tpu_torch.utils import metrics_log, roofline
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
    kernel_trace,
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
# the kernels of csrc/int8_conv.cu: Q2 (the int8 conv) and Q1 (quantize)
INT8_ENTRIES = ("int8_conv_tma_kernel", "quant_input_kernel")
# L1, the letterbox of csrc/letterbox.cu
LETTERBOX_ENTRIES = ("letterbox_u8_kernel",)
# phase 28: L1 against PIL at these (w, h): scale 1, square, shrink,
# enlarge, odd, the 1-px clamp; timed at B=32 on the serving cells' frames
# (half 640x480, half 480x640) and on 1920x1080 camera frames
L1_GRID = ((640, 480), (480, 640), (640, 640), (1920, 1080), (1280, 720),
           (320, 240), (100, 37), (333, 517), (641, 479), (1, 4000))
L1_TIMED = (("640x480", ((640, 480), (480, 640))),
            ("1920x1080", ((1920, 1080),)))
L1_BATCH = 32
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
# phase 19: the trainer's recipe on phase 16's nc=80 data
RECIPE_N = 4          # steps of the graphed recipe chunk in (c) and (f)
RECIPE_LR = dict(total_steps=64, warmup_steps=8, initial_lr=1e-3,
                 min_lr=1e-5)  # (c)'s make_step_lr schedule
RECIPE_AF_HP = {"topk": 13, "alpha": 1.0, "cls_weight": 1.0}
RECIPE_EMA_DECAY = 0.999
ACCUM, ACCUM_B = 2, 2  # (e): micro-batches of an update, images in each
# (e): the images' perturbation that shows which gradients are discontinuous
# at this input (the card's float32 forward differs from the CPU's by
# about as much)
ACCUM_NOISE = 1e-6
# phase 20
INT8_SHAPES = 24      # distinct (k, s, cin, cout) of the quantized convs
INT8_BATCH = 32       # the B=32 int8 call, and the kernels' larger batch
# (k, s, cin, cout, h, w) off the model's grid, at B=2: Cp padded, cout
# not a wgmma width or past 256 (two N tiles), ragged tiles
INT8_ODD_SHAPES = ((3, 1, 24, 17, 9, 13), (1, 1, 48, 40, 7, 11),
                   (3, 2, 32, 300, 12, 10), (1, 1, 16, 8, 5, 5),
                   (3, 2, 3, 24, 17, 23))
INT8_PROB_TOL = 2e-3  # int8 vs float probabilities (test_quantize.py's)
EXPORT_BATCH = 8      # --export-batch's default
ARTIFACT_RTOL, ARTIFACT_ATOL = 1e-5, 1e-4  # tests/test_export.py's

# phase 21: data parallelism
DP_WORLD = 2          # (c): ranks on the one card
DP_BATCH = 4          # (c): images a rank
DP_VAL = 7            # (c): the odd val split of --val-det
DP_LR = 1e-3
DP_BN_RTOL = 1e-3     # (c): BatchNorm statistics, the CPU tests' tolerance
DP_BN_ATOL = 1e-4     # ... of each tensor's largest magnitude
DP_JOIN_S = 600       # (c): the ranks' time limit, then they are killed
# phase 22: spatial partitioning
SP_SPACE = 2          # ranks a space group (--spatial 2)
SP_BATCH = 4          # (a), (b): the global batch, held by both ranks
# (a): the ranks' loss parts summed vs one process, relative: the anchor
# head's; the anchor-free loss weighs its terms by TAL's targets, powers of
# the predicted scores and IoUs (IoU^6) renormalized by their maxima, which
# magnify rounding-level differences of the head outputs: 1.86e-6 in a
# float32 CPU rehearsal of this step at 128 px
SP_LOSS_RTOL = {"anchor": 1e-6, "anchor_free": 1e-5}
SP_BN_TOL = 1e-5      # (a): BatchNorm statistics, of the largest magnitude
# (b): K2 on the haloed tiles of --spatial 2 at 640, B=4 a rank: the 80x80
# and 40x40 grids' blocks of 40 and 20 rows, one halo row on each side
SP_K2_CASES = ((4, 42, 80, torch.bfloat16), (4, 22, 40, torch.bfloat16))
SP_JOIN_S = 600       # the ranks' time limit, then they are killed
# phase 23: model parallelism
TP_MODEL = 2          # ranks a model group (--model-parallel 2)
# (a) bf16 with K2 against one process with K2 (both bf16): the loss
# relative. The gradients are logged, not bounded: a sharded conv's dx is
# the sum of the ranks' partial dx, each rounded to bf16 before the sum
# (one process rounds the whole sum once), and the backward carries that
# rounding on; the float32 step holds the gradients
TP_BF16_LOSS_RTOL = 1e-2
# (b) parameters + Adam moments a rank holds against one process's at
# N = 2: the rule shards 95-99% of the 's' parameters, 0.51-0.52x
TP_MEMORY_SHARE = 0.55
# (a) K2 at the gated convs' global shapes, B=4: the P3 bottlenecks'
# 80x80 and the P4 / head grid's 40x40
TP_K2_CASES = ((4, 80, 80, torch.bfloat16), (4, 40, 40, torch.bfloat16))
# phase 24: the compositions of a world larger than one
WC_BATCH = 4          # (a), (b3): the global batch, two images a rank
WC_N = 4              # (b3): steps of the ranks' chunk
WC_CLI_CHUNK = 2      # (b1), (b2): --stream-chunk at b8 (16 train images)
# (b3): 4 steps from one start; a small rate keeps Adam's +-lr steps on
# rounding-level gradients from moving the BatchNorm statistics
WC_STREAM_LR = 1e-5
WC_STREAM_FLAGS = dict(device_mosaic=True, device_augment=True,
                       augment_seed=SEED, sparse_loss=True)
WC_SPATIAL_IMG = 768  # (c): buckets 576 / 768 / 960, P5 rows 18 / 24 / 30
# (c): K2 on the haloed tiles of --spatial 2 in the first bucket, 576, B=8
# a rank: the 72x72 and 36x36 grids' blocks of 36 and 18 rows, one halo
# row on each side
WC_K2_CASES = ((8, 38, 72, torch.bfloat16), (8, 20, 36, torch.bfloat16))
# phase 25: --spatial N on P5 grids that N does not divide
# (a): (N, image size), P5 rows a rank 10 / 9, 7 / 7 / 6, 1 / 1 / 1 / 0
UN_MESHES = ((2, 608), (3, 640), (4, 96))
UN_K2_MESHES = ((2, 608), (3, 640))  # (a) also bf16 with K2 on
# (a) float32 ranks vs one process, the loss relative: phases 8, 21 (c)
# and 24 (a)'s bound for ranks whose tiles have shapes of their own, so
# that cuDNN picks float32 algorithms of their own (on an NVIDIA H100
# 80GB HBM3 at 700 W: 3.59e-06 at 608 / 2, where one process's own loss
# moves 1.02e-06 with its convs off cuDNN); phase 22's 1e-6 is logged
# beside it
UN_LOSS_RTOL = PARITY_LOSS_TOL
UN_BF16_LOSS_RTOL = 5e-3  # (a) bf16 + K2 ranks vs one process, relative
UN_AF_TRIES = 2       # (a) candidate batches of the anchor-free head
# (b): K2 at the haloed tiles of those blocks, B=8: @608 / 2 the P3 grid's
# 76-wide blocks of 40 and 36 rows and the P4 grid's 38-wide ones of 20
# and 18, @640 / 3 the 80-wide blocks of 28 and 24 rows and the 40-wide
# ones of 14 and 12, one halo row on each side
UN_K2_CASES = tuple((8, h, w, torch.bfloat16) for h, w in (
    (42, 76), (38, 76), (22, 38), (20, 38), (30, 80), (26, 80), (16, 40),
    (14, 40)))
UN_CLI_IMG = 608      # (c): P5 rows 10 / 9
# (a), (c): 17 processes share the host's 8 cores: two CPU threads each
UN_ENV = dict(os.environ, OMP_NUM_THREADS="2")
UN_MS_IMG = 640       # (c): buckets 480 / 640 / 800, P5 rows 15 / 20 / 25
# phase 26: the packed layouts (models/packed.py)
PK_LAYOUTS = {"stem": dict(packed_stem=True),
              "interior": dict(packed_stem=True, packed_interior=True),
              "p3": dict(packed_stem=True, packed_interior=True,
                         packed_p3=True)}
PK_BATCH = 2          # (a) float32 parity batch
# (a) packed vs unpacked, float32 TF32 off, relative to the reference's
# largest magnitude: outputs (eval and train mode) 1e-4, BatchNorm
# statistics 1e-5, each gradient 1e-3 (phase 8's bound; the conv biases
# in front of a BatchNorm, whose gradient is rounding noise, left out as
# there)
PK_OUT_TOL, PK_BN_TOL, PK_GRAD_TOL = 1e-4, 1e-5, PARITY_GRAD_TOL
# (a) bf16: the mean train-mode loss over the 64 images of phase 18's data
# (8 batches of 8), packed vs unpacked, relative. One batch's bf16 loss is
# not held: rounding flips from another accumulation order spread through
# the random-init net, and the unpacked model fed NCHW-contiguous images
# (other cuDNN kernels, the same math) parts from itself by 1-4% a batch
# on the H100 (`PERF.md` §6), logged beside as the noise floor
PK_BF16_LOSS_RTOL = 5e-3
# (a) K2 launches in one bf16 step (profiler): unpacked / stem, and
# interior / p3, which add the two packed C3a bottleneck convs (x 2
# launches a call)
PK_K2 = {"anchor": (16, 20), "anchor_free": (20, 24)}
PK_K2_CASE = (8, 80, 80, torch.bfloat16)  # (b) the packed C3a conv at 640
PK_TIMED = 10         # (d) host-clock steps and graphed replays, each turn
PK_CALLS = 5          # (d) timed B=32 BatchPredictor calls
# phase 27: the packed layouts' compositions
# (a) the packed 2x2 (1, 0) int8 convs at 640: stem1 under stem (64 -> 32
# @160), bb_p3_down under interior (128 -> 128 @80), bb_p4_down and
# downsample_p3_to_p4 under p3 (512 -> 256 and 512 -> 128 @40)
PC_Q2_SHAPES = 4
PC_REQUESTS = 10      # (b) timed requests a path
# (d) --spatial: (ranks, image size), P5 rows 10 / 10 and 7 / 7 / 6
PC_SPACE = ((2, 640), (3, 640))
# (d) K2 at the packed C3a conv's haloed tiles (64 channels @80 wide), B=4
# a rank: blocks of 40 rows (640 / 2), of 28 and 24 (640 / 3), one halo
# row on each side
PC_K2_CASES = tuple((4, h, 80, torch.bfloat16) for h in (42, 30, 26))
# (f) the CLI's mesh compositions, two processes each
PC_CLI_MESH = {"model": ("--packed-interior", "--model-parallel", "2"),
               "space": ("--packed", "stem", "--spatial", "2")}


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
    # the plain walk syncs each step (~1.5 s a call): three calls, as
    # phases 13 and 16 time it
    p_ms = median_ms(lambda: nms_plain.nms_keep_mask(
        off, scores[None], IOU, presorted=True), runs=3, warmup=1)
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
        f"plain {p_ms:.4f} ms (median of 3); H100 bound {bound[0]:.6f} ms "
        f"({bound[1]}, "
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


def _k2_held(b, h, w, dtype, dev, seed):
    """K2 against its plain version (TF32 off) at one shape, two runs
    bit-equal, within K2_TOL. Returns (inputs, largest absolute error,
    dx and dW errors relative to the plain version's largest magnitude)."""
    x, dy, wt = _conv_case(b, h, w, dtype, dev, seed)
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
    if (dx.dtype != dtype or not dx.is_contiguous(
            memory_format=torch.channels_last)
            or rel_dx > tol_dx or rel_dw > tol_dw):
        raise AssertionError(f"conv backward kernel vs plain at "
                             f"{_case_name(b, h, w, dtype)}: dx {rel_dx:.3e} "
                             f"(tol {tol_dx:.3e}), dW {rel_dw:.3e} (tol "
                             f"{tol_dw:.3e})")
    return (x, dy, wt), max(err_dx, err_dw), rel_dx, rel_dw


def phase_conv_bwd(dev):
    """The conv backward kernel against its plain version (TF32 off), two
    runs bit-equal; kernel, plain and one-call library backward times."""
    max_abs_err = 0.0
    times = {}
    for i, (b, h, w, dtype) in enumerate(K2_CASES):
        (x, dy, wt), err, rel_dx, rel_dw = _k2_held(b, h, w, dtype, dev,
                                                   SEED + i)
        tol_dx, tol_dw = K2_TOL[dtype]
        max_abs_err = max(max_abs_err, err)
        name = f"B={b} {h}x{w} {str(dtype).split('.')[1]}"

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
    nms_cuda.launches = letterbox_cuda.launches = 0
    latencies = []
    for _ in range(N_BATCHES):
        t0 = time.perf_counter()
        results = predictor(images)  # ends in a device -> host copy
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches, l1_launches = nms_cuda.launches, letterbox_cuda.launches
    if launches != N_BATCHES or l1_launches != N_BATCHES:
        raise AssertionError(f"NMS kernel launched {launches} times, L1 "
                             f"{l1_launches}, for {N_BATCHES} batches")
    _finite_nonempty(results, "batch image")
    p50 = statistics.median(latencies)
    log(f"batched serving B={BATCH}: {N_BATCHES} calls, NMS kernel launches "
        f"{launches}, L1 launches {l1_launches}, detections per image "
        f"{[len(d) for d in results]}")
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
    detections_per_image(*cpu_out, BATCH)
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
    return launches, l1_launches, (k_ms, bound)


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
        x = args[0]
        shape = mod.gate_shape(x)  # a packed conv's: its packed kernel's
        if shape is not None and conv_bwd.fused_bwd_fits(*shape):
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
    return k1, k2, ckpts


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


class _EpochTee(_Tee):
    """A _Tee that reads K2's launch count each time an "Epoch N:" line is
    printed (the launches of the epoch's training, its evaluation runs no
    backward)."""

    def __init__(self):
        super().__init__()
        self.at_epochs = []

    def write(self, s):
        if s.startswith("Epoch "):
            self.at_epochs.append(conv_bwd.launches)
        return super().write(s)


def _cfg_s(size=None, head="anchor", dtype="bfloat16"):
    return YoloConfig.from_size("s", num_classes=AF_NC,
                                img_size=size or IMG_SIZE,
                                compute_dtype=dtype, head_type=head)


def _k2_per_step(cfg):
    """K2 launches in one train step of cfg's model: its gated convs (a
    forward on the meta device) x LAUNCHES_PER_CALL."""
    return sum(_gated_convs(cfg).values()) * conv_bwd.LAUNCHES_PER_CALL


def _saved(out, what):
    saved = re.search(r"Training complete\. Model saved to (\S+)", out)
    if not saved:
        raise AssertionError(f"{what}: no checkpoint, output:\n{out}")
    return saved.group(1)


def phase_ema_resume_cli(dev, workdir, yaml_path):
    """(a) the CLI trains --ema --val-det 2 epochs, then --resume from its
    checkpoint to epoch 3: JAX's resume line, the checkpoint's step 3
    epochs of steps, its model (the EMA) apart from extra.raw_params, K2
    launched for every step's gated convs, K1 through --val-det; one
    request served from the final checkpoint. Returns (K2, K1 launches)."""
    per_step = _k2_per_step(_cfg_s())
    steps = -(-8 * TRAIN_STEPS // 8)  # phase 16's train split at batch 8
    base = [str(yaml_path), "--batch-size", "8", "--size", "s",
            "--img-size", str(IMG_SIZE), "--ema", "--val-det"]
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    cwd = os.getcwd()
    os.chdir(workdir)
    k1 = k2 = 0
    try:
        conv_bwd.launches = nms_cuda.launches = 0
        t0 = time.perf_counter()
        rc, out = _cli(base + ["--epochs", "2"])
        ckpt = workdir / _saved(out, "--ema")
        if (rc != 0 or len(re.findall(r"^Epoch \d: ", out, re.M)) != 2
                or conv_bwd.launches != 2 * steps * per_step
                or nms_cuda.launches < 2):
            raise AssertionError(f"--ema: rc {rc}, K2 {conv_bwd.launches} "
                                 f"(want {2 * steps * per_step}), K1 "
                                 f"{nms_cuda.launches}, output:\n{out}")
        k1, k2 = nms_cuda.launches, conv_bwd.launches
        wall = time.perf_counter() - t0
        conv_bwd.launches = nms_cuda.launches = 0
        rc, out = _cli(base + ["--epochs", "3", "--resume", str(ckpt)])
        resumed = workdir / _saved(out, "--resume")
        line = f"Resuming from {ckpt} at epoch 3"
        epochs = re.findall(r"^Epoch (\d): ", out, re.M)
        if (rc != 0 or line not in out.splitlines() or epochs != ["3"]
                or resumed != ckpt
                or conv_bwd.launches != steps * per_step
                or nms_cuda.launches < 1):
            raise AssertionError(f"--resume --ema: rc {rc}, epochs {epochs},"
                                 f" K2 {conv_bwd.launches}, K1 "
                                 f"{nms_cuda.launches}, output:\n{out}")
        k1 += nms_cuda.launches
        k2 += conv_bwd.launches
    finally:
        os.chdir(cwd)
    payload = read_payload(ckpt)
    extra = payload["extra"]
    moved = [k for k, v in _flat_tree(payload["model"]["params"]).items()
             if not np.array_equal(v, _flat_tree(extra["raw_params"])[k])]
    if extra["step"] != 3 * steps or not moved or payload["epoch"] != 2:
        raise AssertionError(f"resumed checkpoint: step {extra['step']} "
                             f"(want {3 * steps}), epoch {payload['epoch']}, "
                             f"{len(moved)} EMA leaves apart from the raw")
    state, cfg, _ = load_checkpoint(ckpt)
    image = sorted(Path(yaml_path).parent.glob("val/images/*.jpg"))[0]
    nms_cuda.launches = 0
    dets = Predictor(state, cfg, conf_threshold=CONF, iou_threshold=IOU,
                     device=dev)(str(image))
    if nms_cuda.launches != 1 or not np.isfinite(
            np.asarray(dets, np.float64)).all():
        raise AssertionError(f"EMA checkpoint request: {nms_cuda.launches} "
                             f"NMS launches, {len(dets)} detections")
    k1 += 1
    log(f"phase 19 (a) CLI --ema --val-det 2 epochs ({wall:.1f} s), then "
        f"'{line}' to epoch 3: checkpoint step {extra['step']} (= 3 x "
        f"{steps}), {len(moved)} of "
        f"{len(_flat_tree(extra['raw_params']))} model leaves (the EMA) "
        f"apart from extra.raw_params; K2 {k2} launches (= {3 * steps} steps"
        f" x {per_step}); K1 {k1 - 1} through --val-det + 1 request from "
        f"the resumed checkpoint ({len(dets)} detections, all finite)")
    return k2, k1


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_tree(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def _dense_loaders(yaml_path, size=None, shuffle=False):
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    config = load_dataset_yaml(yaml_path)
    anchors = np.asarray(YoloConfig().anchors, np.float32)
    return [DataLoader(YoloDataset(config[split], AF_NC, anchors,
                                   size or IMG_SIZE),
                       batch_size=8, shuffle=shuffle and split == "train",
                       seed=SEED, prefetch=0) for split in ("train", "val")]


def phase_resume_bitwise(dev, workdir, yaml_path):
    """(b) with an EMA, 2 epochs straight equal 1 epoch + restore_train_state
    + 1 epoch bit for bit (cudnn.deterministic, torch's deterministic mode):
    the live weights, BatchNorm statistics, Adam's moments and steps, and
    the checkpoints (EMA, raw weights, optax state, step)."""
    from yolo_from_scratch_tpu_torch.train.loop import (
        fit,
        restore_train_state,
    )
    from yolo_from_scratch_tpu_torch.train.steps import make_eval_step

    cfg = _cfg_s()
    train, val = _dense_loaders(yaml_path)
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    kw = dict(device=dev, epochs=2, initial_lr=1e-3, warmup_epochs=0,
              log=lambda *_: None, use_ema=True)
    step, evaluate = make_train_step(cfg, device=dev), make_eval_step(
        cfg, device=dev)
    t0 = time.perf_counter()
    with _deterministic() as caught:
        straight, _ = fit(create_train_state(cfg, 1e-3, seed=SEED,
                                             device=dev),
                          step, evaluate, train, val, cfg,
                          save_path=workdir / "straight.ckpt", **kw)
        first, _ = fit(create_train_state(cfg, 1e-3, seed=SEED, device=dev),
                       step, evaluate, train, val, cfg,
                       save_path=workdir / "first.ckpt",
                       **{**kw, "epochs": 1})
        del first
        state, rcfg, start, ema_sd = restore_train_state(
            workdir / "first.ckpt", 1e-3, device=dev,
            compute_dtype="bfloat16")
        resumed, _ = fit(state, step, evaluate, train, val, rcfg,
                         save_path=workdir / "resumed.ckpt",
                         start_epoch=start, initial_ema=ema_sd, **kw)
    torch.cuda.synchronize()
    live = _differ("resumed vs straight", _state_tensors(resumed),
                   _state_tensors(straight))
    a = _flat_tree(read_payload(workdir / "resumed.ckpt"))
    b = _flat_tree(read_payload(workdir / "straight.ckpt"))
    files = sorted(k for k in b if k not in a or not np.array_equal(a[k],
                                                                     b[k]))
    ops = sorted({str(w.message).split(" does not have")[0]
                  for w in caught if "deterministic" in str(w.message)})
    log(f"phase 19 (b) 2 epochs straight vs 1 + restore_train_state + 1, "
        f"EMA on (cudnn.deterministic, torch deterministic mode): "
        f"{len(_state_tensors(resumed)) - len(live)} / "
        f"{len(_state_tensors(resumed))} live state tensors bit-equal, "
        f"checkpoints {len(b) - len(files)} / {len(b)} leaves bit-equal "
        f"(EMA model, raw weights and statistics, optax moments and counts, "
        f"step {int(a['extra/step'])}); restored at epoch {start + 1}; ops "
        f"without a deterministic kernel: {ops or 'none'}; "
        f"{time.perf_counter() - t0:.1f} s")
    if live or files or start != 1:
        raise AssertionError(f"resumed run differs from the straight run: "
                             f"{sorted(live.items())[:8]} {files[:8]}")


def _recipe_chunk(yaml_path, dev, n=RECIPE_N):
    """N steps x 8 of phase 16's train split as compact labels (wrapping),
    on the card."""
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    ds = YoloDataset(load_dataset_yaml(yaml_path)["train"], AF_NC,
                     img_size=IMG_SIZE)
    arrays = ds.load_batch_compact(np.arange(8 * n) % len(ds), COMPACT_K)
    return [torch.from_numpy(a).reshape(n, 8, *a.shape[1:]).to(dev)
            for a in arrays]


def phase_recipe_graph(dev, yaml_path):
    """(c) the anchor-free recipe (--compact-targets --device-mosaic
    --device-augment flip --weight-decay 0.05) with af_hp, a make_step_lr
    schedule and ema_decay through make_train_step_multi_compact: a graphed
    chunk equals its eager steps bit for bit (weights, statistics, AdamW's
    state, the EMA, the learning rate left, metrics); two replays from one
    state bit-equal; K2's launches in one replay (profiler). Returns K2's
    launches in a replay."""
    from yolo_from_scratch_tpu_torch.train import graphs
    from yolo_from_scratch_tpu_torch.train.ema import ema_init, ema_update
    from yolo_from_scratch_tpu_torch.train.schedule import make_step_lr
    from yolo_from_scratch_tpu_torch.train.steps import (
        make_train_step_multi_compact,
        set_learning_rate,
    )

    cfg = _cfg_s(head="anchor_free")
    chunk = _recipe_chunk(yaml_path, dev)
    lr_fn = make_step_lr(**RECIPE_LR)
    flags = dict(device_mosaic=True, device_augment="flip",
                 augment_seed=SEED, af_hp=RECIPE_AF_HP)
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"

    def tensors(state, ema):
        out = _state_tensors(state)
        out.update({f"ema.{k}": v.detach().clone()
                    for k, v in ema.state_dict().items()})
        out["lr"] = torch.as_tensor(
            state.optimizer.param_groups[0]["lr"]).clone()
        return out

    t0 = time.perf_counter()
    with _deterministic() as caught:
        eager = create_train_state(cfg, 1e-3, seed=SEED, device=dev,
                                   weight_decay=0.05)
        ema = ema_init(eager.model)
        single = make_train_step(cfg, device=dev, compact_targets=True,
                                 **flags)
        per, lrs = [], []
        for i in range(RECIPE_N):
            set_learning_rate(eager, lr_fn(torch.tensor(
                eager.step, dtype=torch.int32, device=dev)))
            lrs.append(float(eager.optimizer.param_groups[0]["lr"]))
            eager, m = single(eager, chunk[0][i], (chunk[1][i],
                                                   chunk[2][i]))
            ema_update(ema, eager.model, eager.step, RECIPE_EMA_DECAY)
            per.append(torch.stack([m[k] for k in sorted(m)]))
        want, want_m = tensors(eager, ema), torch.stack(per).mean(0)
        del eager, ema, single
        state = create_train_state(cfg, 1e-3, seed=SEED, device=dev,
                                   weight_decay=0.05)
        ema = ema_init(state.model)
        snap = graphs.Snapshot(state.model, state.optimizer, ema)
        trainer = make_train_step_multi_compact(
            cfg, device=dev, step_lr=lr_fn, ema_decay=RECIPE_EMA_DECAY,
            **flags)
        (state, ema), m = trainer((state, ema), *chunk)
        got = tensors(state, ema)
        got_m = torch.stack([m[k] for k in sorted(m)])
        snap.restore()
        state.step = 0
        (state, ema), m2 = trainer((state, ema), *chunk)
        again = tensors(state, ema)
        again_m = torch.stack([m2[k] for k in sorted(m2)])
    torch.cuda.synchronize()
    ops = sorted({str(w.message).split(" does not have")[0]
                  for w in caught if "deterministic" in str(w.message)})
    vs_eager = _differ("recipe graph vs eager", got, want)
    replays = _differ("recipe replay vs replay", again, got)
    log(f"phase 19 (c) anchor-free recipe + af_hp {RECIPE_AF_HP} + step_lr "
        f"{RECIPE_LR} (lr of steps 0-{RECIPE_N - 1}: "
        f"{', '.join(f'{v:.4e}' for v in lrs)}) + ema_decay "
        f"{RECIPE_EMA_DECAY}: a graphed chunk of {RECIPE_N} vs {RECIPE_N} "
        f"eager steps (capturable AdamW, deterministic): "
        f"{len(got) - len(vs_eager)} / {len(got)} tensors bit-equal (state, "
        f"EMA, lr); metrics {got_m.tolist()} vs {want_m.tolist()}; two "
        f"replays {len(got) - len(replays)} / {len(got)} bit-equal; ops "
        f"without a deterministic kernel: {ops or 'none'}; "
        f"{time.perf_counter() - t0:.1f} s")
    if vs_eager or not torch.equal(got_m, want_m):
        raise AssertionError(f"recipe graph differs from the eager steps: "
                             f"{sorted(vs_eager.items())[:8]}")
    if replays or not torch.equal(got_m, again_m):
        raise AssertionError(f"two recipe replays differ: "
                             f"{sorted(replays.items())[:8]}")
    snap.restore()
    state.step = 0
    counts = _launch_counts(lambda: trainer((state, ema), *chunk))
    k2 = sum(n for k, (n, _) in counts.items() if "conv3x3_bwd" in k)
    want_k2 = _k2_per_step(cfg) * RECIPE_N
    log(f"phase 19 (c): one replay launches "
        f"{sum(n for n, _ in counts.values())} kernels in "
        f"{sum(ms for _, ms in counts.values()):.2f} ms of device time, K2 "
        f"{k2} (= {want_k2 // RECIPE_N} a step x {RECIPE_N}); profiler")
    if k2 != want_k2:
        raise AssertionError(f"recipe replay: {k2} K2 launches, want "
                             f"{want_k2}")
    del trainer, state, ema, snap
    torch.cuda.empty_cache()
    return k2


def phase_multiscale(dev, workdir, yaml_path):
    """(d) --multi-scale trains 3 epochs through the CLI, one a bucket; K2's
    launches in each held to the gated convs at that size; K2 against its
    plain version at the buckets' new bf16 shapes. Returns ({size: K2
    launches}, largest K2 error, sizes)."""
    sizes = cli.multi_scale_sizes(IMG_SIZE)
    steps = -(-8 * TRAIN_STEPS // 8)
    want = {s: _k2_per_step(_cfg_s(s)) * steps for s in sizes}
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    cwd = os.getcwd()
    os.chdir(workdir)
    tee = _EpochTee()
    try:
        conv_bwd.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rc = cli.main([str(yaml_path), "--batch-size", "8", "--size", "s",
                           "--img-size", str(IMG_SIZE), "--epochs", "3",
                           "--multi-scale"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    out = tee.text.getvalue()
    marks = [0] + tee.at_epochs
    got = {s: marks[i + 1] - marks[i] for i, s in enumerate(sizes)}
    ckpt = read_payload(workdir / _saved(out, "--multi-scale"))
    if (rc != 0 or f"Multi-scale buckets: {sizes} (epoch-rotated)" not in out
            or len(tee.at_epochs) != 3 or got != want
            or ckpt["img_size"] != IMG_SIZE):
        raise AssertionError(f"--multi-scale: rc {rc}, K2 a bucket {got} "
                             f"(want {want}), checkpoint img_size "
                             f"{ckpt['img_size']}, output:\n{out}")
    log(f"phase 19 (d) CLI --multi-scale, 3 epochs in {wall:.1f} s: buckets "
        f"{sizes}, K2 launches a bucket {got} (= gated convs "
        + ", ".join(f"{s}: {_gated_convs(_cfg_s(s))}" for s in sizes)
        + f" x {steps} steps x {conv_bwd.LAUNCHES_PER_CALL}); checkpoint "
        f"img_size {ckpt['img_size']}")
    err = 0.0
    shapes = sorted({hw for s in sizes if s != IMG_SIZE
                     for hw in _gated_convs(_cfg_s(s))})
    for i, (h, w) in enumerate(shapes):
        _, e, rel_dx, rel_dw = _k2_held(8, h, w, torch.bfloat16, dev,
                                        SEED + 40 + i)
        err = max(err, e)
        ms = device_ms(lambda: conv_bwd._launch(*_conv_case(
            8, h, w, torch.bfloat16, dev, SEED)))
        log(f"  K2 {_case_name(8, h, w, torch.bfloat16)} (a multi-scale "
            f"bucket's shape): dx err {rel_dx:.3e}, dW err {rel_dw:.3e} of "
            f"max (tol {K2_TOL[torch.bfloat16][0]:.1e} / "
            f"{K2_TOL[torch.bfloat16][1]:.1e}), 2 runs bit-equal; "
            f"{ms:.4f} ms (profiler, with the inputs' generation)")
    return got, err, sizes


def phase_other_paths(dev, workdir, yaml_path):
    """(e) --augment trains an epoch through the CLI; one float32 step of
    make_train_step_accum(n_accum=2) on the card (TF32 off) against the
    port on the CPU. Returns K2's launches in the accumulating step."""
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        t0 = time.perf_counter()
        rc, out = _cli([str(yaml_path), "--batch-size", "8", "--size", "s",
                        "--img-size", str(IMG_SIZE), "--epochs", "1",
                        "--augment"])
    finally:
        os.chdir(cwd)
    if rc != 0 or not EPOCH_LINE.search(out):
        raise AssertionError(f"--augment: rc {rc}, output:\n{out}")
    _saved(out, "--augment")
    log(f"phase 19 (e) CLI --augment: 1 epoch, exit 0 in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{EPOCH_LINE.search(out).group(1)} img/s (host mosaic + jitter)")

    from yolo_from_scratch_tpu_torch.train.steps import make_train_step_accum

    cfg = _cfg_s(dtype="float32")
    cpu = torch.device("cpu")
    train, _ = _dense_loaders(yaml_path)
    images, targets = train.dataset.load_batch(range(2 * ACCUM_B))
    images = torch.from_numpy(images).reshape(ACCUM, ACCUM_B,
                                              *images.shape[1:])
    targets = [torch.from_numpy(t).reshape(ACCUM, ACCUM_B, *t.shape[1:])
               for t in targets]
    noise = torch.randn(images.shape, generator=torch.Generator().manual_seed(
        SEED)) * ACCUM_NOISE
    results = []
    for device, inputs in ((dev, images), (cpu, images),
                           (cpu, images + noise)):
        state = create_train_state(cfg, 1e-3, seed=SEED, device=device)
        step = make_train_step_accum(cfg, ACCUM, device=device)
        conv_bwd.launches = 0
        with tf32_disabled():
            state, m = step(state, inputs.to(device),
                            *(t.to(device) for t in targets))
        results.append((m["loss"].item(), {
            n: p.grad.cpu() for n, p in state.model.named_parameters()},
            conv_bwd.launches))
    (loss, grads, k2), (cpu_loss, cpu_grads, _), (_, nudged, _) = results

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()

    # a max-pool's argmax in SPPF flips between near-equal inputs when the
    # forward moves by rounding, and the gradient of every layer before it
    # jumps: a tensor that the CPU itself moves past the tolerance when the
    # images move by ACCUM_NOISE is held to that move instead
    spread = {n: rel(nudged[n], g) for n, g in cpu_grads.items()}
    held = [(rel(grads[n], g) / max(PARITY_GRAD_TOL, spread[n]), n)
            for n, g in cpu_grads.items() if n not in PRE_BN_BIASES]
    sensitive = [n for _, n in held if spread[n] > PARITY_GRAD_TOL]
    worst = max(held)
    rel_loss = abs(loss - cpu_loss) / abs(cpu_loss)
    want_k2 = ACCUM * _k2_per_step(cfg)
    log(f"phase 19 (e) make_train_step_accum(n_accum={ACCUM}), B={ACCUM_B} "
        f"a micro-batch, float32, card (TF32 off, K2) vs CPU (plain "
        f"version): loss {loss:.6f} vs {cpu_loss:.6f} ({rel_loss:.2e} "
        f"relative, tol {PARITY_LOSS_TOL}); the clipped mean gradients: "
        f"{len(held) - len(sensitive)} tensors within {PARITY_GRAD_TOL} of "
        f"their max, {len(sensitive)} ({', '.join(sensitive[:2])} ... "
        f"{sensitive[-1] if sensitive else '-'}) within the CPU's own move "
        f"when the images move by {ACCUM_NOISE:g}; worst "
        f"{worst[0]:.3f} of its bound ({worst[1]}: card "
        f"{rel(grads[worst[1]], cpu_grads[worst[1]]):.2e}, CPU's move "
        f"{spread[worst[1]]:.2e}); K2 {k2} launches (= {ACCUM} "
        f"micro-batches x {want_k2 // ACCUM})")
    if rel_loss > PARITY_LOSS_TOL or worst[0] > 1.0 or k2 != want_k2:
        raise AssertionError("accumulating step on the card differs from "
                             "the CPU")
    return k2


def _timed_steps(fn, n):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def phase_recipe_throughput(dev, yaml_path):
    """(f) informative img/s and busy shares, in turns within this call:
    the eager step with and without EMA, the graphed anchor-free recipe
    chunk with and without ema_decay + step_lr, and each multi-scale
    bucket's eager step."""
    from yolo_from_scratch_tpu_torch.train.ema import (
        ema_init,
        wrap_train_step_with_ema,
    )
    from yolo_from_scratch_tpu_torch.train.schedule import make_step_lr
    from yolo_from_scratch_tpu_torch.train.steps import (
        make_train_step_multi_compact,
    )

    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    smi = _smi("name,power.limit")
    cfg = _cfg_s()
    train, _ = _dense_loaders(yaml_path)
    images, targets = train.dataset.load_batch(range(8))
    images = torch.from_numpy(images).to(dev)
    targets = [torch.from_numpy(t).to(dev) for t in targets]
    state = create_train_state(cfg, 1e-3, seed=SEED, device=dev)
    plain = make_train_step(cfg, device=dev)
    with_ema = wrap_train_step_with_ema(plain, decay=0.9999)
    ema = ema_init(state.model)
    runs = {"eager": lambda: plain(state, images, targets),
            "eager + EMA": lambda: with_ema((state, ema), images, targets)}
    walls = collections.defaultdict(list)
    for name in ("eager", "eager + EMA", "eager + EMA", "eager"):
        walls[name].append(_timed_steps(runs[name], TIMED_STEPS // 2))
    for name, fn in runs.items():
        wall = statistics.mean(walls[name])
        busy = _busy_ms(fn)
        log(f"phase 19 (f) {name} step, 's' @{IMG_SIZE} b8 bf16 nc={AF_NC}: "
            f"{' / '.join(f'{8 / w:.1f}' for w in walls[name])} img/s "
            f"(turns, {TIMED_STEPS // 2} steps each; host clock), device busy "
            f"{busy:.2f} ms a step ({busy / (wall * 1e3):.0%}; profiler); "
            f"{smi}")
    del state, ema, runs
    torch.cuda.empty_cache()

    af = _cfg_s(head="anchor_free")
    chunk = _recipe_chunk(yaml_path, dev)
    flags = dict(device_mosaic=True, device_augment="flip",
                 augment_seed=SEED, af_hp=RECIPE_AF_HP)
    graphs_ = {}
    for name, knobs in (("graph N=4", {}),
                        ("graph N=4 + ema_decay + step_lr",
                         dict(ema_decay=RECIPE_EMA_DECAY,
                              step_lr=make_step_lr(**RECIPE_LR)))):
        st = create_train_state(af, 1e-3, seed=SEED, device=dev,
                                weight_decay=0.05)
        trainer = make_train_step_multi_compact(af, device=dev, **flags,
                                                **knobs)
        carry = (st, ema_init(st.model)) if knobs else st
        trainer(carry, *chunk)  # capture + one replay
        graphs_[name] = (trainer, carry)
    walls = collections.defaultdict(list)
    order = list(graphs_) + list(graphs_)[::-1]
    for name in order:
        trainer, carry = graphs_[name]
        walls[name].append(_timed_steps(lambda: trainer(carry, *chunk),
                                        STREAM_REPEATS) / RECIPE_N)
    for name, (trainer, carry) in graphs_.items():
        wall = statistics.mean(walls[name])
        busy = _busy_ms(lambda: trainer(carry, *chunk)) / RECIPE_N
        log(f"phase 19 (f) anchor-free recipe {name}: "
            f"{' / '.join(f'{8 / w:.1f}' for w in walls[name])} img/s "
            f"(turns, {STREAM_REPEATS} chunks each; host clock), "
            f"{wall * 1e3:.2f} ms a step, device busy {busy:.2f} ms a step "
            f"({busy / (wall * 1e3):.0%}; profiler); {smi}")
    del graphs_, chunk
    torch.cuda.empty_cache()

    for size in cli.multi_scale_sizes(IMG_SIZE):
        cfg = _cfg_s(size)
        train, _ = _dense_loaders(yaml_path, size)
        imgs, tgts = train.dataset.load_batch(range(8))
        imgs = torch.from_numpy(imgs).to(dev)
        tgts = [torch.from_numpy(t).to(dev) for t in tgts]
        state = create_train_state(cfg, 1e-3, seed=SEED, device=dev)
        step = make_train_step(cfg, device=dev)

        def fn():
            step(state, imgs, tgts)

        wall = _timed_steps(fn, TIMED_STEPS // 2)
        busy = _busy_ms(fn)
        log(f"phase 19 (f) multi-scale bucket {size}: eager step "
            f"{8 / wall:.1f} img/s, {wall * 1e3:.2f} ms (host clock, "
            f"{TIMED_STEPS // 2} steps), device busy {busy:.2f} ms "
            f"({busy / (wall * 1e3):.0%}; profiler); {smi}")
        del state, step, imgs, tgts
        torch.cuda.empty_cache()


# ------------------------------------------------------------- phase 20


def _ulps_bf16(a, b):
    """Largest distance in bf16 ulps between two bf16 tensors (their bit
    patterns mapped to a monotone integer line)."""
    def line(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((line(a) - line(b)).abs().max())


def _int8_shapes(cfg):
    """([(k, s, cin, cout, h, w)] of each distinct quantized conv, all
    ConvBNSiLU but stem0, at its first grid in forward order; the number
    of quantized convs), from a forward on the meta device."""
    model = YOLO(cfg, device="meta")
    seen, count = {}, [0]

    def pre_hook(mod, args):
        count[0] += 1
        c = mod.conv
        seen.setdefault((c.kernel_size[0], c.stride[0], c.in_channels,
                         c.out_channels), tuple(args[0].shape[2:]))

    for name, module in model.named_modules():
        if isinstance(module, ConvBNSiLU) and name != "stem0":
            module.register_forward_pre_hook(pre_hook)
    with torch.no_grad():
        model(torch.empty((1, cfg.img_size, cfg.img_size, 3), device="meta"))
    return [(*key, *hw) for key, hw in seen.items()], count[0]


def _q_case(b, k, s, cin, cout, h, w, dev, seed):
    """A bf16 NCHW (channels-last) activation and a seeded int8 layer of
    the shape: (x, q) with q's a_scale 0.8 of |x|'s max / 127, so the clip
    is exercised."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((b, h, w, cin), generator=g, device=dev) * 2).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    rng = np.random.default_rng(seed)
    q = {"w_int8": rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8),
         "w_scale": rng.uniform(1e-3, 1e-2, cout).astype(np.float32),
         "bias": rng.normal(0, 0.5, cout).astype(np.float32),
         "a_scale": np.float32(0.8 * x.abs().max().item() / 127)}
    return x, q


def _q_check(x, q, k, s, dev):
    """Q1 and Q2 against their plain versions on the card: Q1's int8,
    Q2's int32 accumulator and its bf16 and float32 outputs bit-equal.
    Returns (xq, packed w, bf16 scale, bf16 bias, bf16 max |err|, bf16
    ulps, f32 rel err), the last three 0 when the check passes."""
    inv = quant.input_inverse(q["a_scale"], torch.bfloat16)
    xq = quant._launch_quant_input(x, inv)
    q1_err = (xq.int() - quant.quant_input_plain(x, inv).int()).abs().max()
    if q1_err.item() != 0:
        raise AssertionError(f"Q1 differs from its plain version by "
                             f"{q1_err.item()}")
    w = quant.pack_weights(q["w_int8"]).to(dev)
    if not torch.equal(quant.int8_conv_acc(xq, w, k, s),
                       quant.int8_conv_acc_plain(xq, w, k, s)):
        raise AssertionError("Q2's int32 accumulator differs from its "
                             "plain version")
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        sc, bi = (t.to(dev) for t in quant.dequant_vectors(
            q["a_scale"], q["w_scale"], q["bias"], dt))
        bf16 = dt == torch.bfloat16
        got = torch.ops.yolo_torch.int8_conv(xq, w, sc, bi, k, s, bf16)
        want = quant.int8_conv_plain(xq, w, sc, bi, k, s, bf16)
        out[dt] = (sc, bi, got, want)
    sc, bi, got, want = out[torch.bfloat16]
    ulps = _ulps_bf16(got, want)
    err = (got.float() - want.float()).abs().max().item()
    _, _, g32, w32 = out[torch.float32]
    rel = ((g32 - w32).abs() / w32.abs().clamp_min(1e-30)).max().item()
    if not (torch.equal(got, want) and torch.equal(g32, w32)):
        raise AssertionError(f"Q2 vs plain: {ulps} bf16 ulps, float32 "
                             f"relative {rel:.3e}; want bit-equal")
    return xq, w, sc, bi, err, ulps, rel


def _q2_geometry(lib, b, k, s, cin, cout, h, w, sms):
    """Q2's launch geometry at one shape from the library, held to what
    the kernel needs: N = cout rounded up to 16, 32, 64, 128 or 256 (256
    past that), at most 227 KB of shared memory, three stages or more,
    tiles that cover the output and a grid no larger than the work."""
    geom = quant.conv_geometry(lib, b, h, w, quant.padded_channels(cin),
                               cout, k, s, sms)
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    want_n = max(16, 1 << (min(cout, 256) - 1).bit_length())
    ok = (geom.nt == want_n and geom.n_tiles == -(-cout // geom.nt)
          and geom.smem <= 232448
          and geom.stages >= 3 and geom.tile_h * geom.tile_w <= 64
          and geom.tiles_y * geom.tile_h >= ho
          and geom.tiles_x * geom.tile_w >= wo
          and geom.work == b * geom.tiles_y * geom.tiles_x * geom.n_tiles
          and 1 <= geom.grid <= geom.work)
    if not ok:
        raise AssertionError(f"Q2 geometry at B={b} k{k} s{s} {cin}->{cout} "
                             f"@{h}x{w}: {geom}")
    return geom


def phase_int8_kernels(dev):
    """20 (a): Q1 and Q2 against their plain versions at each distinct
    quantized conv of the 's' model @640 (both heads share them), B=1 and
    B=32; Q2's geometry; device ms (profiler, TIMING_RUNS calls) beside
    the H100 bound and the yardsticks: `torch._int_mm` on the im2col and
    the bf16 `F.conv2d` of the layer (B=32), and at the 1x1 stride-1
    shapes `torch._int_mm` on xq viewed (M, Cp), Q2's int32 accumulator
    (both batches). Returns (max bf16 |err|, {name: summed timings over
    the shapes at B=32, and "b1_*" at B=1}, shapes)."""
    cfg = YoloConfig.from_size("s", num_classes=AF_NC, img_size=IMG_SIZE,
                               compute_dtype="bfloat16")
    shapes, n_quant = _int8_shapes(cfg)
    af_shapes, af_quant = _int8_shapes(cfg.with_(head_type="anchor_free"))
    extra = sorted(set(af_shapes) - set(shapes))
    log(f"int8 convs of 's' @{IMG_SIZE}: {n_quant} quantized on the anchor "
        f"head, {af_quant} on the anchor-free head; {len(shapes)} distinct "
        f"(k, s, cin, cout), {sum(sh[1] == 2 for sh in shapes)} at stride "
        f"2; the anchor-free head adds {len(extra)} distinct ({extra})")
    if len(shapes) != INT8_SHAPES:
        raise AssertionError(f"{len(shapes)} distinct int8 conv shapes, want "
                             f"{INT8_SHAPES}")
    lib = load_library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sums = collections.Counter()
    max_err, worst = 0.0, (0, 0.0)
    for i, (k, s, cin, cout, h, w) in enumerate(shapes):
        for b in (1, INT8_BATCH):
            geom = _q2_geometry(lib, b, k, s, cin, cout, h, w, sms)
            x, q = _q_case(b, k, s, cin, cout, h, w, dev, SEED + 31 * i + b)
            xq, wp, sc, bi, err, ulps, rel = _q_check(x, q, k, s, dev)
            max_err = max(max_err, err)
            worst = (max(worst[0], ulps), max(worst[1], rel))
            inv = quant.input_inverse(q["a_scale"], torch.bfloat16)

            def kernels():
                torch.ops.yolo_torch.int8_conv(
                    torch.ops.yolo_torch.quant_input(x, inv), wp, sc, bi, k,
                    s, True)

            kernels()
            per = kernel_ms(kernels, TIMING_RUNS)
            q1 = sum(v for n, v in per.items() if "quant_input" in n) / \
                TIMING_RUNS
            q2 = sum(v for n, v in per.items() if "int8_conv" in n) / \
                TIMING_RUNS
            b1 = roofline.bound_ms(*roofline.quant_input_work(b, cin, h, w,
                                                              2), "float32")
            b2 = roofline.bound_ms(*roofline.int8_conv_work(
                b, h, w, cin, cout, k, s, 2), "int8")
            line = (f"int8 conv k{k} s{s} {cin}->{cout} @{h}x{w} B={b}: "
                    f"Q1 {q1:.4f} ms (bound {b1[0]:.4f}, {b1[1]}), Q2 "
                    f"{q2:.4f} ms (bound {b2[0]:.4f}, {b2[1]}, "
                    f"{b2[0] / q2:.0%}); N {geom.nt}"
                    f"{' split' if geom.split else ''}, tile "
                    f"{geom.tile_h}x{geom.tile_w}, chunk {geom.chunk}, "
                    f"{geom.stages} stages, {geom.smem} B smem, weights "
                    f"{'resident' if geom.resident else 'staged'}, grid "
                    f"{geom.grid}; bit-equal (bf16 max |err| {err:.3e})")
            pre = "" if b == INT8_BATCH else "b1_"
            sums.update({f"{pre}q1": q1, f"{pre}q2": q2,
                         f"{pre}q1_bound": b1[0], f"{pre}q2_bound": b2[0]})
            if k == 1 and s == 1:
                # one cuBLASLt call computes Q2's exact int32 accumulator
                # of a 1x1 stride-1 conv: xq viewed (M, Cp) @ w^T
                a_mat = xq.view(-1, xq.shape[-1])
                if not torch.equal(torch._int_mm(a_mat, wp.t()).view(
                        *xq.shape[:3], cout), quant.int8_conv_acc(
                            xq, wp, k, s)):
                    raise AssertionError("torch._int_mm differs from Q2's "
                                         "int32 accumulator")
                mm = sum(kernel_ms(lambda: torch._int_mm(a_mat, wp.t()),
                                   TIMING_RUNS).values()) / TIMING_RUNS
                sums.update({f"{pre}q2_1x1": q2, f"{pre}int_mm_1x1": mm})
                line += (f"; 1x1: torch._int_mm on xq (M, Cp) {mm:.4f} ms, "
                         f"Q2 {mm / q2:.2f}x its speed")
            if b == INT8_BATCH:
                # the yardsticks: cuBLASLt's int8 GEMM on a prebuilt
                # im2col (the im2col itself not timed), and cuDNN's bf16
                # conv of the layer
                cols = torch.nn.functional.unfold(
                    xq.permute(0, 3, 1, 2).float(), k, padding=k // 2,
                    stride=s)
                a_mat = cols.permute(0, 2, 1).reshape(
                    -1, cols.shape[1]).to(torch.int8).contiguous()
                del cols
                b_mat = torch.zeros((cout, a_mat.shape[1]), dtype=torch.int8,
                                    device=dev)
                lib_ms = sum(kernel_ms(lambda: torch._int_mm(a_mat,
                                                             b_mat.t()),
                                       TIMING_RUNS).values()) / TIMING_RUNS
                del a_mat
                wf = torch.from_numpy(q["w_int8"]).permute(3, 2, 0, 1).to(
                    dev, torch.bfloat16).contiguous(
                        memory_format=torch.channels_last)
                conv = sum(kernel_ms(lambda: torch.nn.functional.conv2d(
                    x, wf, stride=s, padding=k // 2), TIMING_RUNS).values()
                ) / TIMING_RUNS
                p1 = median_ms(lambda: quant.quant_input_plain(x, inv),
                               runs=3, warmup=1)
                p2 = median_ms(lambda: quant.int8_conv_plain(
                    xq, wp, sc, bi, k, s, True), runs=3, warmup=1)
                sums.update({"int_mm": lib_ms, "conv_bf16": conv,
                             "q1_plain": p1, "q2_plain": p2,
                             f"q2_bound_{b2[1]}": b2[0]})
                line += (f"; yardsticks: torch._int_mm on the im2col "
                         f"{lib_ms:.4f} ms, bf16 F.conv2d {conv:.4f} ms "
                         f"(profiler); plain Q1 {p1:.3f} ms, Q2 {p2:.3f} ms "
                         f"(CUDA events, median of 3)")
            log(line)
            del x, xq
        torch.cuda.empty_cache()
    for i, (k, s, cin, cout, h, w) in enumerate(INT8_ODD_SHAPES):
        _q2_geometry(lib, 2, k, s, cin, cout, h, w, sms)
        _q_check(*_q_case(2, k, s, cin, cout, h, w, dev, SEED + 7 * i), k, s,
                 dev)
    log(f"Q1 and Q2 == plain at the odd shapes {INT8_ODD_SHAPES}, B=2")
    log(f"Q1 and Q2 == plain at {len(shapes)} shapes x B=1, {INT8_BATCH}: "
        f"int8, int32, bf16 and float32 bit-equal; summed over the shapes at "
        f"B={INT8_BATCH}: Q1 {sums['q1']:.4f} ms (bound "
        f"{sums['q1_bound']:.4f}), Q2 {sums['q2']:.4f} ms (bound "
        f"{sums['q2_bound']:.4f}, {sums['q2_bound'] / sums['q2']:.0%}), "
        f"torch._int_mm on the im2col {sums['int_mm']:.4f} ms, bf16 conv "
        f"{sums['conv_bf16']:.4f} ms, plain Q1 {sums['q1_plain']:.3f} ms, "
        f"Q2 {sums['q2_plain']:.3f} ms; at B=1: Q1 {sums['b1_q1']:.4f} ms, "
        f"Q2 {sums['b1_q2']:.4f} ms (bound {sums['b1_q2_bound']:.4f}, "
        f"{sums['b1_q2_bound'] / sums['b1_q2']:.0%}); the 13 1x1 stride-1 "
        f"shapes: Q2 {sums['q2_1x1']:.4f} ms against torch._int_mm on xq "
        f"{sums['int_mm_1x1']:.4f} ms at B={INT8_BATCH}, "
        f"{sums['b1_q2_1x1']:.4f} against {sums['b1_int_mm_1x1']:.4f} at "
        f"B=1; {_smi('name,power.limit')}")
    return max_err, sums, shapes


def phase_int8_serving(dev, ckpts, yaml_path):
    """20 (b): int8 serving of both heads on phase 17's checkpoints ('s'
    @640, nc=80, bf16): the CLI's `--int8` request and one B=32 int8
    `BatchPredictor` call with the counts at 0 before them; the
    candidates against the same path with plain Q1/Q2 on the card, the
    keep masks, the probabilities against the float path; p50, img/s and
    busy share, int8 and bf16 float. Returns {head: (Q1, Q2, K1)
    launches}."""
    from yolo_from_scratch_tpu_torch.infer.quantize import set_plain
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    config = load_dataset_yaml(str(yaml_path))
    val_img = sorted(Path(config["val"]).glob("*.jpg"))[0]
    rng = np.random.default_rng(SEED + 20)
    images = [rng.integers(0, 256, (IMG_SIZE, IMG_SIZE, 3), dtype=np.uint8)
              for _ in range(INT8_BATCH)]
    counts = {}
    for head in ("anchor", "anchor_free"):
        state, cfg, _ = load_checkpoint(ckpts[head])
        cfg = cfg.with_(compute_dtype="bfloat16")
        calib = cli._train_calibration_images(config, cfg)
        n_quant = _int8_shapes(cfg)[1]
        # the anchor-free checkpoint's class probabilities sit near its
        # prior: phase 16's gate for a trained checkpoint
        conf = CONF if head == "anchor" else AF_CKPT_CONF
        quant.quant_launches = quant.conv_launches = nms_cuda.launches = 0
        rc, out = _cli([str(val_img), str(ckpts[head]), "--int8",
                        "--dtype", "bfloat16"])
        if rc != 0 or "Running inference on" not in out or not (
                "object(s):" in out or "No objects detected." in out):
            raise AssertionError(f"--int8 request ({head}): rc {rc}:\n{out}")
        qb = BatchPredictor(state, cfg, conf_threshold=conf,
                            iou_threshold=IOU, max_outputs=MAX_OUTPUTS,
                            quantize_calib=calib, device=dev)
        results = qb(images)
        torch.cuda.synchronize()
        counts[head] = (quant.quant_launches, quant.conv_launches,
                        nms_cuda.launches)
        if counts[head] != (2 * n_quant, 2 * n_quant, 2):
            raise AssertionError(f"{head} int8 main path: (Q1, Q2, K1) "
                                 f"launches {counts[head]}, want "
                                 f"({2 * n_quant}, {2 * n_quant}, 2)")
        _finite_nonempty(results, f"{head} int8 batch image")
        log(f"{head} int8 serving: the CLI's --int8 request "
            f"({out.strip().splitlines()[-1].strip()}) and one B="
            f"{INT8_BATCH} BatchPredictor call launched (Q1, Q2, K1) "
            f"{counts[head]} times ({n_quant} quantized convs a forward)")

        # the same path with plain Q1/Q2 on the card
        args = qb.stage(images)
        cand_k = qb.postprocess.candidates(*args)
        set_plain(qb.model, True)
        cand_p = qb.postprocess.candidates(*args)
        set_plain(qb.model, False)
        same = [i for i in range(INT8_BATCH)
                if all(torch.equal(a[i], b[i]) for a, b in zip(cand_k,
                                                               cand_p))]
        score_err = (cand_k[1] - cand_p[1]).abs().max().item()
        if score_err > INT8_PROB_TOL:
            raise AssertionError(f"{head}: kernel vs plain int8 candidate "
                                 f"scores differ by {score_err}")
        keep_k = nms_cuda.nms_keep_mask_batched(
            nms_plain._class_offset_boxes(cand_k[0], cand_k[2]), cand_k[1],
            IOU, max_keep=MAX_OUTPUTS, presorted=True)
        keep_p = nms_plain.nms_keep_mask(
            nms_plain._class_offset_boxes(cand_p[0], cand_p[2]), cand_p[1],
            IOU, max_keep=MAX_OUTPUTS, presorted=True)
        bad = [i for i in same if not torch.equal(keep_k[i], keep_p[i])]
        if bad:
            raise AssertionError(f"{head}: keep masks differ on images {bad} "
                                 f"whose candidates are equal")
        fb = BatchPredictor(state, cfg, conf_threshold=conf,
                            iou_threshold=IOU, max_outputs=MAX_OUTPUTS,
                            device=dev)
        _, obj_q, cls_q, _ = qb.postprocess.decode(*args)
        _, obj_f, cls_f, _ = fb.postprocess.decode(*args)
        prob_err = max((obj_q - obj_f).abs().max().item(),
                       (cls_q - cls_f).abs().max().item())
        if prob_err > INT8_PROB_TOL:
            raise AssertionError(f"{head}: int8 vs float probabilities "
                                 f"differ by {prob_err}")
        log(f"{head} int8, kernels vs plain Q1/Q2 on the card: candidates "
            f"bit-equal on {len(same)}/{INT8_BATCH} images (max |score| err "
            f"{score_err:.3e}, tol {INT8_PROB_TOL}), K1's keep masks == the "
            f"plain NMS's on each of them; int8 vs the bf16 float path: max "
            f"|probability| err {prob_err:.3e} over all "
            f"{obj_q.numel()} predictions (tol {INT8_PROB_TOL})")

        # p50 of a request, B=32 img/s, busy share: int8 and bf16 float
        for name, calib_req, batch_pred in (("int8", [str(val_img)], qb),
                                            ("bf16", None, fb)):
            single = Predictor(state, cfg, conf_threshold=conf,
                               iou_threshold=IOU, device=dev,
                               quantize_calib=calib_req)
            single(str(val_img))
            lat = []
            for _ in range(N_REQUESTS):
                t0 = time.perf_counter()
                single(str(val_img))
                lat.append((time.perf_counter() - t0) * 1e3)
            req_busy = _busy_ms(lambda: single(str(val_img)))
            batch_pred(images)
            blat = []
            for _ in range(N_BATCHES):
                t0 = time.perf_counter()
                batch_pred(images)
                blat.append((time.perf_counter() - t0) * 1e3)
            busy = _busy_ms(lambda: batch_pred(images))
            p50, bp50 = statistics.median(lat), statistics.median(blat)
            log(f"{head} {name} serving: request p50 {p50:.3f} ms (host "
                f"clock, {N_REQUESTS} requests of a {IMG_SIZE}x{IMG_SIZE} "
                f"JPEG), device "
                f"busy {req_busy:.3f} ms ({req_busy / p50:.0%}); B="
                f"{INT8_BATCH} p50 {bp50:.3f} ms, "
                f"{INT8_BATCH * 1e3 / bp50:.1f} img/s, device busy "
                f"{busy:.3f} ms ({busy / bp50:.0%}; profiler); "
                f"{_smi('name,power.limit')}")
        del qb, fb, single
        torch.cuda.empty_cache()
    return counts


ARTIFACT_SCRIPT = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile

from yolo_from_scratch_tpu_torch.infer.artifact import load_serving_artifact

path, out, images = sys.argv[1], sys.argv[2], sys.argv[3:]
art = load_serving_artifact(path)
staged = art.stage(images)
art.run(*staged)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    result = art.run(*staged)
    torch.cuda.synchronize()
names = {"mask": "nms_mask_pass", "scan": "nms_scan",
         "q1": "quant_input_kernel", "q2": "int8_conv_tma_kernel"}
counts = {k: sum(e.count for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and v in e.key) for k, v in names.items()}
from yolo_from_scratch_tpu_torch.infer.detections import detections_per_image
dets = detections_per_image(*(t.cpu() for t in result), len(images))
bad = sorted(m for m in sys.modules
             if m.startswith("yolo_from_scratch_tpu_torch.models")
             or m.split(".")[0] in ("jax", "yolo_from_scratch_tpu"))
json.dump({"dets": dets, "counts": counts, "meta": art.meta,
           "bad_modules": bad}, open(out, "w"))
"""


def _served_checkpoint(ckpt, head, out):
    """A copy of a phase 17 checkpoint whose scores pass the CLI's default
    gate of 0.5 on about half the cells, so that the artifacts have
    detections to compare: the anchor head's objectness biases raised by
    4.6 (tests/test_torch_predict.py's `served`), the anchor-free head's
    class biases set to 0 (its prior puts them near -11)."""
    from yolo_from_scratch_tpu_torch.utils.checkpoint import save_checkpoint
    from yolo_from_scratch_tpu_torch.utils.convert import to_flax_variables

    state, cfg, _ = load_checkpoint(ckpt)
    for name in ("head_p3", "head_p4", "head_p5"):
        if head == "anchor":
            state[f"{name}.pred.bias"].view(3, -1)[:, 4] += 4.6
        else:
            state[f"{name}.cls_pred.bias"].zero_()
    save_checkpoint(out, to_flax_variables(state), cfg)
    return out


def start_export(ckpts, yaml_path, workdir, layout=None,
                 heads=("anchor", "anchor_free")):
    """20 (c): `--export` through the CLI at the default batch of 8, float
    and --int8, for each of `heads`, of phase 17's checkpoints with their
    gate biases raised (`_served_checkpoint`), one export after another
    (each timed with the card and host to itself), then each artifact
    started in a fresh interpreter (`ARTIFACT_SCRIPT`, which times
    nothing), all at once. `layout` (a key of PK_LAYOUTS; 27 (c)): the
    packed model's artifacts, which take the 4x-packed batch their loader
    packs on the host. Returns what `check_export` takes."""
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    ckpts = {head: _served_checkpoint(ckpts[head], head,
                                      workdir / f"served_{head}.ckpt")
             for head in heads}
    flags = ["--packed", layout] if layout else []
    tag = f"{layout}_" if layout else ""
    config = load_dataset_yaml(str(yaml_path))
    images = [str(p) for p in sorted(Path(config["val"]).glob("*.jpg"))]
    images = images[:EXPORT_BATCH]
    jobs = {}
    for head in heads:
        for int8 in (False, True):
            name = f"{tag}{head}{'_int8' if int8 else ''}"
            path = workdir / f"{name}.yexp"
            t0 = time.perf_counter()
            rc, out = _cli(([str(yaml_path)] if int8 else [])
                           + [str(ckpts[head]), "--export", str(path),
                              "--dtype", "bfloat16", *flags]
                           + (["--int8"] if int8 else []))
            lines = out.strip().splitlines()
            want = (f"  batch {EXPORT_BATCH}, img {IMG_SIZE}, classes "
                    f"{AF_NC}, platforms cuda, nms cuda"
                    + (", int8" if int8 else ""))
            if rc != 0 or lines[-1] != want or not lines[-2].startswith(
                    f"Exported {ckpts[head]} -> {path} ("):
                raise AssertionError(f"--export {name}: rc {rc}:\n{out}")
            log(f"--export {name}: {time.perf_counter() - t0:.1f} s, "
                f"{lines[-2].split('(')[-1].rstrip(')')}; {lines[-1].strip()}")
            jobs[name] = (path, workdir / f"{name}.json")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", ARTIFACT_SCRIPT, str(path), str(out),
         *images], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=Path(__file__).resolve().parent)
        for name, (path, out) in jobs.items()}
    _STARTED.extend(procs.values())
    return dict(ckpts=ckpts, config=config, images=images, jobs=jobs,
                procs=procs, layout=layout, t0=time.perf_counter())


def check_export(dev, started):
    """20 (c), 27 (c): join `start_export`'s artifacts, each served in its
    fresh interpreter (no model module imported there): K1's and Q2's
    launches in it counted by the profiler, its detections against the
    live BatchPredictor's on the same staged batch. Returns {artifact: its
    kernel counts}."""
    from yolo_from_scratch_tpu_torch.infer.artifact import stage_images

    ckpts, config, images, jobs, procs, layout = (started[k] for k in (
        "ckpts", "config", "images", "jobs", "procs", "layout"))
    for name, proc in procs.items():
        try:
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        if proc.returncode != 0:
            raise AssertionError(f"artifact {name} in a fresh interpreter: "
                                 f"rc {proc.returncode}\n{err[-3000:]}")
    log(f"the {len(jobs)} artifacts served in fresh interpreters, in "
        f"parallel: {time.perf_counter() - started['t0']:.1f} s")
    counts = {}
    for name, (path, out) in jobs.items():
        res = json.loads(Path(out).read_text())
        head = "anchor_free" if "anchor_free" in name else "anchor"
        int8 = name.endswith("int8")
        state, cfg, _ = load_checkpoint(ckpts[head])
        cfg = cfg.with_(compute_dtype="bfloat16",
                        **PK_LAYOUTS.get(layout, {}))
        if res["meta"]["packed_stem"] is not bool(layout):
            raise AssertionError(f"artifact {name}: header packed_stem "
                                 f"{res['meta']['packed_stem']}")
        n_quant = _int8_shapes(cfg)[1] if int8 else 0
        c = res["counts"]
        if res["bad_modules"] or c != {"mask": 1, "scan": 1, "q1": n_quant,
                                       "q2": n_quant}:
            raise AssertionError(f"artifact {name}: kernels {c} (want one "
                                 f"K1 launch, {n_quant} Q1/Q2), modules "
                                 f"{res['bad_modules']}")
        live = BatchPredictor(
            state, cfg, device=dev,
            quantize_calib=(cli._train_calibration_images(config, cfg)
                            if int8 else None))
        staged = stage_images(images, IMG_SIZE, EXPORT_BATCH, dev,
                              packed=bool(layout))
        want = detections_per_image(
            *(t.cpu() for t in live.postprocess(*staged)), len(images))
        got = res["dets"]
        for g, w in zip(got, want):
            a, b = np.asarray(sorted(g)), np.asarray(sorted(w))
            if a.shape != b.shape or (len(a) and not np.allclose(
                    a, b, rtol=ARTIFACT_RTOL, atol=ARTIFACT_ATOL)):
                raise AssertionError(f"artifact {name} vs the live "
                                     f"BatchPredictor: {a.shape} vs "
                                     f"{b.shape}")
        counts[name] = c
        log(f"artifact {name}: {sum(map(len, got))} detections on "
            f"{len(images)} images == the live BatchPredictor's (rtol "
            f"{ARTIFACT_RTOL}, atol {ARTIFACT_ATOL}); kernels in one call "
            f"(profiler, fresh interpreter): K1 mask pass {c['mask']} + scan "
            f"{c['scan']}, Q1 {c['q1']}, Q2 {c['q2']}; no model module "
            f"loaded")
        del live
        torch.cuda.empty_cache()
    return counts


def _free_port():
    """A free TCP port on localhost for a coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dp_world1(dev, workdir, yaml_path):
    """(b) `--distributed` at a world of one over NCCL through the CLI
    (`--val-det`, K2 on) against the same command line without it, both
    deterministic as in phase 18: the checkpoints bit-equal. Returns K1's
    and K2's launches in the distributed run."""
    args = [str(yaml_path), "--epochs", "1", "--batch-size", "8", "--size",
            "s", "--img-size", str(IMG_SIZE), "--val-det"]
    world1 = ["--distributed", "--coordinator", f"127.0.0.1:{_free_port()}",
              "--num-processes", "1", "--process-id", "0"]
    gated = sum(_gated_convs(YoloConfig.from_size(
        "s", num_classes=AF_NC, img_size=IMG_SIZE,
        compute_dtype="bfloat16")).values())
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    ckpts, launches = {}, {}
    cwd = os.getcwd()
    t0 = time.perf_counter()
    try:
        for name, extra in (("flagless", []), ("world1", world1)):
            (workdir / f"dp_{name}").mkdir()
            os.chdir(workdir / f"dp_{name}")
            conv_bwd.launches = 0
            nms_cuda.launches = 0
            with _deterministic():
                rc, out = _cli(args + extra)
            launches[name] = (nms_cuda.launches, conv_bwd.launches)
            epoch = EPOCH_LINE.search(out)
            if rc != 0 or not epoch or " | Det: P " not in epoch.group(0):
                raise AssertionError(f"phase 21 (b) {name} CLI: rc {rc}, "
                                     f"output:\n{out}")
            if name == "world1" and (
                    "Distributed: process 0/1, backend nccl" not in out
                    or "Data-parallel mesh over 1 process(es)" not in out):
                raise AssertionError(f"phase 21 (b): no NCCL group of one:\n"
                                     f"{out}")
            ckpts[name] = _flat_tree(read_payload(_saved(out, name)))
    finally:
        os.chdir(cwd)
    a, b = ckpts["world1"], ckpts["flagless"]
    differ = sorted(k for k in b if k not in a or not np.array_equal(a[k],
                                                                     b[k]))
    want_k2 = gated * TRAIN_STEPS * conv_bwd.LAUNCHES_PER_CALL
    log(f"phase 21 (b) --distributed --num-processes 1 (NCCL) vs no flag, "
        f"deterministic, 's' @{IMG_SIZE} nc={AF_NC} b8 bf16, 1 epoch of "
        f"{TRAIN_STEPS} steps + --val-det: checkpoints "
        f"{len(b) - len(differ)} / {len(b)} leaves bit-equal; (K1, K2) "
        f"launches {launches['world1']} against {launches['flagless']} "
        f"(K2 want {want_k2}); {time.perf_counter() - t0:.1f} s")
    if differ or set(a) != set(b):
        raise AssertionError(f"world 1 differs from the flagless run: "
                             f"{differ[:8]}")
    if launches["world1"][1] != want_k2 or launches["world1"][0] < 1:
        raise AssertionError(f"phase 21 (b) launches {launches['world1']}")
    return launches["world1"]


DP_RANK_SCRIPT = r"""
import os
import sys

import numpy as np
import torch

from yolo_from_scratch_tpu_torch import YoloConfig, cli
from yolo_from_scratch_tpu_torch.data import YoloDataset
from yolo_from_scratch_tpu_torch.device import tf32_disabled
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import conv_bwd, nms_cuda
from yolo_from_scratch_tpu_torch.parallel.distributed import (
    init_distributed, shutdown)
from yolo_from_scratch_tpu_torch.parallel.mesh import make_mesh
from yolo_from_scratch_tpu_torch.train import metrics, steps

rank, coordinator, job_path, out_path = sys.argv[1:5]
rank = int(rank)
init_distributed(coordinator, 2, rank, backend="gloo", device="cuda")
mesh = make_mesh("cuda")
job = torch.load(job_path, weights_only=False)
cfg = YoloConfig(**job["cfg"])
model = YOLO(cfg)
model.load_state_dict(job["state"])
model.to(mesh.device)
state = steps.TrainState(model, steps.make_optimizer(model.parameters(),
                                                     job["lr"]))
clip = steps.clip_by_global_norm_
seen = {}


def recording_clip(grads, *a, **kw):
    seen["grads"] = [g.detach().cpu() for g in grads]
    return clip(grads, *a, **kw)


steps.clip_by_global_norm_ = recording_clip
b = job["images"].shape[0] // 2
rows = slice(rank * b, (rank + 1) * b)
images = torch.from_numpy(job["images"][rows]).to(mesh.device)
targets = [torch.from_numpy(t[rows]).to(mesh.device) for t in job["targets"]]
conv_bwd.launches = 0
with tf32_disabled():
    state, m = steps.make_train_step(cfg, device=mesh.device, mesh=mesh)(
        state, images, targets)
torch.cuda.synchronize()
k2 = conv_bwd.launches
names = [n for n, _ in model.named_parameters()]
# --val-det's counts on the odd split (prf1 reports them unchanged here)
metrics.prf1 = lambda tp, fp, fn: (tp, fp, fn)
ds = YoloDataset(job["val"], cfg.num_classes, cfg.anchors_array,
                 cfg.img_size, backend="pil")
ds.imgs, ds.labels = ds.imgs[:job["n_val"]], ds.labels[:job["n_val"]]
nms_cuda.launches = 0
counts = cli._det_eval(cfg, model, ds, mesh.device, mesh)(model)
torch.cuda.synchronize()
torch.save({"metrics": {k: v.item() for k, v in m.items()},
            "grads": dict(zip(names, seen["grads"])),
            "state": {k: v.cpu() for k, v in model.state_dict().items()},
            "k2": k2, "k1": nms_cuda.launches, "counts": counts,
            "device": str(mesh.device)}, out_path)
shutdown()
"""


def phase_dp_two_ranks(dev, workdir, yaml_path):
    """(c) two ranks on the one card (`gloo` on CUDA tensors, float32, TF32
    off, 4 images each) against one process on the global batch of 8:
    one step's global loss and summed gradient before the clip within
    phase 8's tolerances, the BatchNorm statistics within the CPU tests'
    and equal on both ranks, K2's launches on each rank held to the gated
    convs; `--val-det`'s counts on an odd split of DP_VAL images summed
    over the ranks equal one process's. Returns (K1, K2) launches summed
    over the ranks."""
    from yolo_from_scratch_tpu_torch.train import steps
    from yolo_from_scratch_tpu_torch.train.map_eval import (
        evaluate_det_counts,
    )
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    cfg = YoloConfig.from_size("s", num_classes=AF_NC, img_size=IMG_SIZE,
                               compute_dtype="float32")
    config = load_dataset_yaml(yaml_path)
    loader = DataLoader(YoloDataset(config["train"], AF_NC, cfg.anchors_array,
                                    IMG_SIZE, backend="pil"),
                        batch_size=DP_WORLD * DP_BATCH, prefetch=0)
    images, targets = next(iter(loader))
    state = YOLO(cfg).reset_parameters(
        torch.Generator().manual_seed(SEED)).state_dict()
    for head in ("head_p3", "head_p4", "head_p5"):
        # objectness and class scores up, so that detections pass
        # --val-det's gate of 0.5
        state[f"{head}.pred.bias"].view(3, -1)[:, 4] += 10.0
        state[f"{head}.pred.bias"].view(3, -1)[:, 5:] += 6.0
    job = dict(cfg=dict(num_classes=AF_NC, img_size=IMG_SIZE,
                        width_mult=cfg.width_mult, depth_mult=cfg.depth_mult,
                        compute_dtype="float32"),
               state=state, lr=DP_LR, images=images, targets=targets,
               val=config["val"], n_val=DP_VAL)
    torch.save(job, workdir / "dp_job.pt")
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    coordinator = f"127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", DP_RANK_SCRIPT, str(r), coordinator,
         str(workdir / "dp_job.pt"), str(workdir / f"dp_rank{r}.pt")],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(DP_WORLD)]
    try:
        results = [p.communicate(timeout=DP_JOIN_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, results):
        if p.returncode != 0:
            raise AssertionError(f"phase 21 (c) rank exited {p.returncode}:"
                                 f"\n{err[-4000:]}")
    ranks = [torch.load(workdir / f"dp_rank{r}.pt", weights_only=False)
             for r in range(DP_WORLD)]
    rank_s = time.perf_counter() - t0

    # one process on the global batch, the same weights and settings
    model = YOLO(cfg)
    model.load_state_dict(state)
    model.to(dev)
    single = steps.TrainState(model, steps.make_optimizer(model.parameters(),
                                                          DP_LR))
    clip, seen = steps.clip_by_global_norm_, {}

    def recording_clip(grads, *a, **kw):
        seen["grads"] = [g.detach().cpu() for g in grads]
        return clip(grads, *a, **kw)

    steps.clip_by_global_norm_ = recording_clip
    try:
        with tf32_disabled():
            single, m = steps.make_train_step(cfg, device=dev)(
                single, torch.from_numpy(images).to(dev),
                [torch.from_numpy(t).to(dev) for t in targets])
        torch.cuda.synchronize()
    finally:
        steps.clip_by_global_norm_ = clip
    want_grads = dict(zip([n for n, _ in model.named_parameters()],
                          seen["grads"]))
    want_state = {k: v.cpu() for k, v in model.state_dict().items()}
    loss = sum(r["metrics"]["loss"] for r in ranks)
    rel_loss = abs(loss - m["loss"].item()) / abs(m["loss"].item())
    worst = max(((ranks[0]["grads"][k] - g).abs().max().item()
                 / g.abs().max().clamp(min=1e-30).item(), k)
                for k, g in want_grads.items() if k not in PRE_BN_BIASES)
    bn = [k for k in want_state if k.endswith((".bn.mean", ".bn.var"))]
    bn_bad = [k for k in bn if not np.allclose(
        ranks[0]["state"][k].numpy(), want_state[k].numpy(), rtol=DP_BN_RTOL,
        atol=DP_BN_ATOL * want_state[k].abs().max().item())]
    bn_worst = max((ranks[0]["state"][k] - want_state[k]).abs().max().item()
                   / want_state[k].abs().max().clamp(min=1e-30).item()
                   for k in bn)
    across = [k for k in ranks[0]["state"]
              if not torch.equal(ranks[0]["state"][k], ranks[1]["state"][k])]
    gated = sum(_gated_convs(cfg).values()) * conv_bwd.LAUNCHES_PER_CALL

    ds = YoloDataset(config["val"], AF_NC, cfg.anchors_array, IMG_SIZE,
                     backend="pil")
    ds.imgs, ds.labels = ds.imgs[:DP_VAL], ds.labels[:DP_VAL]
    counts = evaluate_det_counts(BatchPredictor(state, cfg,
                                                conf_threshold=0.5,
                                                device=dev), ds)
    log(f"phase 21 (c) 2 ranks on one card (gloo on CUDA tensors, "
        f"{ranks[0]['device']} each; {rank_s:.1f} s with start-up), 's' "
        f"@{IMG_SIZE} nc={AF_NC} float32 TF32 off, {DP_BATCH} images a rank, "
        f"vs one process on the {DP_WORLD * DP_BATCH}: loss "
        f"{loss:.6f} vs {m['loss'].item():.6f} ({rel_loss:.2e} relative, tol "
        f"{PARITY_LOSS_TOL}); worst gradient {worst[0]:.2e} of its tensor's "
        f"max ({worst[1]}; tol {PARITY_GRAD_TOL}); BatchNorm statistics "
        f"worst {bn_worst:.2e} of the tensor's max, {len(bn) - len(bn_bad)} "
        f"/ {len(bn)} within rtol {DP_BN_RTOL} + {DP_BN_ATOL} of the max; "
        f"state tensors differing between the ranks: {len(across)}; K2 "
        f"launches a rank {[r['k2'] for r in ranks]} (want {gated}); "
        f"--val-det on {DP_VAL} images: ranks' (tp, fp, fn) "
        f"{[r['counts'] for r in ranks]} vs one process {counts}, K1 "
        f"launches a rank {[r['k1'] for r in ranks]}")
    if (rel_loss > PARITY_LOSS_TOL or worst[0] > PARITY_GRAD_TOL or bn_bad
            or across):
        raise AssertionError("two ranks differ from one process")
    if any(r["k2"] != gated for r in ranks) or any(r["k1"] < 1
                                                   for r in ranks):
        raise AssertionError("phase 21 (c): kernel launches")
    if any(tuple(r["counts"]) != tuple(counts) for r in ranks) or \
            sum(counts) == 0:
        raise AssertionError("phase 21 (c): sharded --val-det counts differ "
                             "from one process's")
    return (sum(r["k1"] for r in ranks), sum(r["k2"] for r in ranks))


MESH_RANK_SCRIPT = r"""
import os
import sys

import numpy as np
import torch

from yolo_from_scratch_tpu_torch import YoloConfig
from yolo_from_scratch_tpu_torch.device import tf32_disabled
from yolo_from_scratch_tpu_torch.models import anchor_free
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import conv_bwd
from yolo_from_scratch_tpu_torch.parallel.distributed import (
    init_distributed, shutdown)
from yolo_from_scratch_tpu_torch.parallel.mesh import (
    batch_sharding, batch_sharding_for, image_sharding, make_mesh,
    make_mesh_2d, make_mesh_dm)
from yolo_from_scratch_tpu_torch.parallel.tensor import (
    full_state_dict, gather_state_tp, shard_model_)
from yolo_from_scratch_tpu_torch.train import steps

rank, world, coordinator, job_path, out_path = sys.argv[1:6]
rank, world = int(rank), int(world)
# a loopback coordinator with more ranks than cards: gloo
init_distributed(coordinator, world, rank, device="cuda")
job = torch.load(job_path, weights_only=False)
# "space": the rows of the global batch (--spatial); "model": the whole
# batch and this rank's output channels (--model-parallel); "data": this
# rank's images of the global batch (1-D)
if job["axis"] == "space":
    mesh = make_mesh_2d(job["n"], "cuda")
    shard_images, shard_targets = image_sharding, batch_sharding_for
elif job["axis"] == "model":
    mesh = make_mesh_dm(job["n"], "cuda")
    shard_images = shard_targets = batch_sharding
else:
    mesh = make_mesh("cuda")
    shard_images = shard_targets = batch_sharding
seen = {}
clip, tal, fused = (steps.clip_by_global_norm_, anchor_free.tal_assign,
                    conv_bwd.fused_bwd)


def recording_clip(grads, *a, **kw):
    seen["grads"] = [g.detach().clone() for g in grads]
    return clip(grads, *a, **kw)


def recording_tal(*a, **kw):
    out = tal(*a, **kw)
    seen["fg"] = out["fg"].cpu()
    return out


def recording_fused(x, dy, w):
    seen["k2_shapes"].append((tuple(x.shape), tuple(dy.shape),
                              tuple(w.shape)))
    return fused(x, dy, w)


steps.clip_by_global_norm_ = recording_clip
anchor_free.tal_assign = recording_tal
conv_bwd.fused_bwd = recording_fused
out = {"backend": torch.distributed.get_backend(), "device": str(mesh.device)}
for run in job["runs"]:
    os.environ["YOLO_FUSED_CONV_BWD"] = "1" if run["fused"] else "0"
    cfg = YoloConfig(**run["cfg"])
    model = YOLO(cfg)
    model.load_state_dict(job["states"][cfg.head_type])
    shard_model_(model, mesh)
    model.to(mesh.device)
    keys = getattr(model, "tp_keys", frozenset())
    state = steps.TrainState(model, steps.make_optimizer(model.parameters(),
                                                         job["lr"]))
    step = steps.make_train_step(cfg, device=mesh.device, mesh=mesh,
                                 **run["kw"])
    # a step that cuts the rows itself (the device mosaic) takes whole
    # images; rows follow the block plan of the run's P5 grid
    grid = (cfg.img_size // 32,) if job["axis"] == "space" else ()
    images = torch.from_numpy(np.ascontiguousarray(
        batch_sharding(mesh, run["images"]) if step.takes_whole_images
        else shard_images(mesh, run["images"], *grid))).to(mesh.device)
    targets = [torch.from_numpy(np.ascontiguousarray(
        shard_targets(mesh, t, *grid))).to(mesh.device)
        for t in run["targets"]]
    seen.pop("fg", None)
    seen["k2_shapes"] = []
    torch.cuda.synchronize()
    conv_bwd.launches = 0
    with tf32_disabled():
        state, m = step(state, images, targets)
    torch.cuda.synchronize()
    k2 = conv_bwd.launches
    names = [n for n, _ in model.named_parameters()]
    grads = gather_state_tp(mesh, dict(zip(names, seen["grads"])), keys)
    held = [*model.parameters()] + [t for p in model.parameters()
                                    for k, t in state.optimizer.state[p].items()
                                    if k in ("exp_avg", "exp_avg_sq")]
    out[run["name"]] = {
        "metrics": {k: v.item() for k, v in m.items()},
        "grads": {k: v.cpu() for k, v in grads.items()},
        "state": {k: v.cpu() for k, v in full_state_dict(model).items()},
        "local": {k: v.cpu() for k, v in model.state_dict().items()},
        "keys": keys,
        "held_bytes": sum(t.numel() * t.element_size() for t in held),
        "fg": seen.get("fg"), "k2": k2, "k2_shapes": seen["k2_shapes"]}
torch.save(out, out_path)
shutdown()
"""

def _start_ranks(script, args, world, workdir, env=None):
    """`script` in `world` processes on the card, rank r with (r, world,
    a loopback coordinator, *args): the started processes. A phase that
    fails before it joins them leaves them to `_kill_started` at exit."""
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), coordinator,
         *args(r)], cwd=workdir, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for r in range(world)]
    _STARTED.extend(procs)
    return procs


_STARTED = []


@atexit.register
def _kill_started():
    """End every rank process this script started that still runs."""
    for p in _STARTED:
        if p.poll() is None:
            p.kill()
            p.wait()


def _join_ranks(procs, what):
    """Wait for `_start_ranks`' processes within SP_JOIN_S (then kill
    them); raises unless every rank exits 0. Returns their stdouts."""
    try:
        results = [p.communicate(timeout=SP_JOIN_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, results):
        if p.returncode != 0:
            raise AssertionError(f"{what}: a rank exited {p.returncode}:\n"
                                 f"{out[-2000:]}\n{err[-4000:]}")
    return [out for out, _ in results]


def _run_ranks(script, args, world, workdir, what, env=None):
    """`script` in `world` processes on the card (`_start_ranks`), joined;
    their stdouts."""
    return _join_ranks(_start_ranks(script, args, world, workdir, env), what)


def _sp_runs(yaml_path):
    """Phase 22's steps: the anchor head on dense host targets and the
    anchor-free head on compact labels (one candidate batch of
    SP_BATCH images each of its AF_TRIES), float32 for (a), then bf16
    with K2 on for (b), and the heads' seeded weights."""
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    train = load_dataset_yaml(yaml_path)["train"]
    runs, states = [], {}
    for head in ("anchor", "anchor_free"):
        cfg = YoloConfig.from_size("s", num_classes=AF_NC, img_size=IMG_SIZE,
                                   head_type=head)
        states[head] = YOLO(cfg).reset_parameters(
            torch.Generator().manual_seed(SEED)).state_dict()
        ds = YoloDataset(train, AF_NC, cfg.anchors_array, IMG_SIZE,
                         backend="pil", head_type=head)
        tries = 1 if head == "anchor" else AF_TRIES
        for t in range(tries):
            idx = range(t * SP_BATCH, (t + 1) * SP_BATCH)
            if head == "anchor":
                images, targets = ds.load_batch(idx)
                kw = {}
            else:
                images, labels, counts = ds.load_batch_compact(
                    idx, capacity=COMPACT_K)
                targets, kw = [labels, counts], dict(compact_targets=True)
            for dtype in ("float32", "bfloat16"):
                if dtype == "bfloat16" and t:
                    continue  # (b) takes the first batch
                runs.append(dict(
                    name=(head, dtype, t), cfg=dict(
                        num_classes=AF_NC, img_size=IMG_SIZE,
                        width_mult=cfg.width_mult, depth_mult=cfg.depth_mult,
                        head_type=head, compute_dtype=dtype),
                    images=images, targets=targets, kw=kw,
                    fused=dtype == "bfloat16"))
    return runs, states


def _single_step(dev, run, state_dict):
    """One process's step on the whole batch of `run`, TF32 off, the K2
    switch as `run["fused"]` sets it: (loss, gradients, state, TAL's
    foreground mask or None)."""
    from yolo_from_scratch_tpu_torch.train import steps

    os.environ["YOLO_FUSED_CONV_BWD"] = "1" if run["fused"] else "0"
    cfg = YoloConfig(**run["cfg"])
    model = YOLO(cfg)
    model.load_state_dict(state_dict)
    model.to(dev)
    state = steps.TrainState(model, steps.make_optimizer(model.parameters(),
                                                         DP_LR))
    seen = {}
    clip, tal = steps.clip_by_global_norm_, anchor_free.tal_assign

    def recording_clip(grads, *a, **kw):
        seen["grads"] = [g.detach().to("cpu", copy=True) for g in grads]
        return clip(grads, *a, **kw)

    def recording_tal(*a, **kw):
        out = tal(*a, **kw)
        seen["fg"] = out["fg"].cpu()
        return out

    steps.clip_by_global_norm_ = recording_clip
    anchor_free.tal_assign = recording_tal
    try:
        with tf32_disabled():
            state, m = steps.make_train_step(cfg, device=dev, **run["kw"])(
                state, torch.from_numpy(run["images"]).to(dev),
                [torch.from_numpy(t).to(dev) for t in run["targets"]])
        torch.cuda.synchronize()
    finally:
        steps.clip_by_global_norm_ = clip
        anchor_free.tal_assign = tal
        os.environ["YOLO_FUSED_CONV_BWD"] = "0"
    return (m["loss"].item(),
            dict(zip([n for n, _ in model.named_parameters()],
                     seen["grads"])),
            {k: v.cpu() for k, v in model.state_dict().items()},
            seen.get("fg"))


def _start_mesh_ranks(axis, n, runs, states, workdir, tag="", env=None):
    """Start `MESH_RANK_SCRIPT`'s steps of `runs` in `n` ranks on the card
    (1 x n, the mesh axis `axis`; `tag` names their files; `env` theirs):
    (the processes, their start time)."""
    job = workdir / f"{axis}{tag}_job.pt"
    torch.save({"runs": runs, "states": states, "lr": DP_LR, "axis": axis,
                "n": n}, job)
    return (_start_ranks(MESH_RANK_SCRIPT, lambda r: (
        str(job), str(workdir / f"{axis}{tag}_rank{r}.pt")), n,
        Path(__file__).resolve().parent, env), time.perf_counter())


def _join_mesh_ranks(axis, n, started, workdir, what, tag=""):
    """Join `_start_mesh_ranks`' ranks: each rank's results, and the
    seconds they took with start-up."""
    procs, t0 = started
    _join_ranks(procs, what)
    ranks = [torch.load(workdir / f"{axis}{tag}_rank{r}.pt",
                        weights_only=False) for r in range(n)]
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError(f"{what}: the ranks sharing the card are not "
                             f"on gloo")
    return ranks, time.perf_counter() - t0


def _mesh_ranks(axis, n, runs, states, workdir, what):
    """`MESH_RANK_SCRIPT`'s steps of `runs` in `n` ranks on the card (1 x
    n, the mesh axis `axis`): each rank's results, and the seconds both
    took with start-up."""
    return _join_mesh_ranks(axis, n, _start_mesh_ranks(
        axis, n, runs, states, workdir), workdir, what)


def _matched_single(dev, runs, ranks, states, head, what):
    """One process's float32 step on the first of `head`'s batches whose
    TAL foreground mask equals rank 0's (the anchor head has one batch):
    (the run, its batch index, each rank's results for it, one process's
    `_single_step`, K2's launches in that step)."""
    for t in range(1 if head == "anchor" else AF_TRIES):
        run = next(r for r in runs if r["name"] == (head, "float32", t))
        conv_bwd.launches = 0
        single = _single_step(dev, run, states[head])
        k2 = conv_bwd.launches
        got = [r[run["name"]] for r in ranks]
        fg = single[3]
        n_diff = 0 if fg is None else int((got[0]["fg"] != fg).sum())
        if n_diff == 0:
            return run, t, got, single, k2
        log(f"{what} {head}: images {t * SP_BATCH}-{(t + 1) * SP_BATCH - 1}:"
            f" {n_diff} of {int(fg.sum())} fg cells differ from one "
            f"process's; the next batch")
    raise AssertionError(f"{what}: {head} fg masks differ on all "
                         f"{AF_TRIES} batches")


def _worst(got, want):
    """(largest |got - want| over the largest |want|, tensor) over the
    gradients, the pre-BN biases left out (their gradient is float noise
    around 0)."""
    return max(((got[k] - g).abs().max().item()
                / g.abs().max().clamp(min=1e-30).item(), k)
               for k, g in want.items() if k not in PRE_BN_BIASES)


def _bn_worst(got, want):
    """`_worst` over the BatchNorm statistics of two full-size states."""
    return _worst({k: v for k, v in got.items()
                   if k.endswith((".bn.mean", ".bn.var"))},
                  {k: v for k, v in want.items()
                   if k.endswith((".bn.mean", ".bn.var"))})


def _ranks_differ(a, b):
    """The keys whose tensors differ between two ranks' states."""
    return [k for k in a if not torch.equal(a[k], b[k])]


def phase_spatial_step(dev, workdir, yaml_path, card):
    """(a) two ranks on the one card, 1 x 2 (`gloo` on CUDA tensors), 's'
    @640 nc=80 float32 TF32 off, the global batch of SP_BATCH held by both
    as row halves, against one process on the same batch, both heads:
    loss, gradients and BatchNorm statistics, the ranks' weights bit for
    bit (the anchor-free head on the first batch whose foreground masks
    agree); (b) the same in bf16 with YOLO_FUSED_CONV_BWD=1: K2's
    launches a rank held to the gated convs. Returns K2's launches summed
    over the ranks in (b)."""
    runs, states = _sp_runs(yaml_path)
    ranks, rank_s = _mesh_ranks("space", SP_SPACE, runs, states, workdir,
                                "phase 22 (a)")
    k2_total = 0
    for head in ("anchor", "anchor_free"):
        run, t, got, (loss, grads, state, _), _ = _matched_single(
            dev, runs, ranks, states, head, "phase 22 (a)")
        total = sum(r["metrics"]["loss"] for r in got)
        rel_loss = abs(total - loss) / abs(loss)
        worst = _worst(got[0]["grads"], grads)
        bn_worst = _bn_worst(got[0]["state"], state)
        across = _ranks_differ(got[0]["state"], got[1]["state"])
        log(f"phase 22 (a) {head}, 2 ranks x {SP_SPACE} row blocks on one "
            f"card ({card}; gloo on CUDA tensors; {rank_s:.1f} s for both "
            f"ranks' (a) and (b) with start-up), 's' @{IMG_SIZE} nc={AF_NC} "
            f"float32 TF32 off, a global batch of {SP_BATCH} (images "
            f"{t * SP_BATCH}-{(t + 1) * SP_BATCH - 1}) vs one process: loss "
            f"{total:.7f} vs {loss:.7f} ({rel_loss:.2e} relative, tol "
            f"{SP_LOSS_RTOL[head]}); worst gradient {worst[0]:.2e} of its tensor's "
            f"max ({worst[1]}; tol {PARITY_GRAD_TOL}); BatchNorm statistics "
            f"worst {bn_worst[0]:.2e} of the tensor's max ({bn_worst[1]}; "
            f"tol {SP_BN_TOL}); state tensors differing between the ranks: "
            f"{len(across)}")
        if (rel_loss > SP_LOSS_RTOL[head] or worst[0] > PARITY_GRAD_TOL
                or bn_worst[0] > SP_BN_TOL or across):
            raise AssertionError(f"phase 22 (a) {head}: the spatial step "
                                 f"differs from one process's")
        # (b) bf16, K2 on: its launches on each rank
        bf16 = [r[(head, "bfloat16", 0)] for r in ranks]
        cfg = YoloConfig(**next(r["cfg"] for r in runs
                                if r["name"] == (head, "bfloat16", 0)))
        gated = sum(_gated_convs(cfg).values())
        want = gated * conv_bwd.LAUNCHES_PER_CALL
        across = _ranks_differ(bf16[0]["state"], bf16[1]["state"])
        log(f"phase 22 (b) {head} bf16, YOLO_FUSED_CONV_BWD=1 ({card}): K2 "
            f"launches a rank {[r['k2'] for r in bf16]} for one step (want "
            f"{gated} gated convs x {conv_bwd.LAUNCHES_PER_CALL} = {want}); "
            f"losses {[round(r['metrics']['loss'], 6) for r in bf16]}; state "
            f"tensors differing between the ranks: {len(across)}")
        if any(r["k2"] != want for r in bf16) or across or not all(
                np.isfinite(r["metrics"]["loss"]) for r in bf16):
            raise AssertionError(f"phase 22 (b) {head}: K2 launches or "
                                 f"ranks differ")
        k2_total += sum(r["k2"] for r in bf16)
    return k2_total


def phase_tp_step(dev, workdir, yaml_path, card):
    """(a) two ranks on the one card, 1 x 2 data x model (`gloo` on CUDA
    tensors), each with its channel slices of the 's' model @640 nc=80
    and the whole global batch of 4, YOLO_FUSED_CONV_BWD=1: float32 TF32
    off against one process with K2 (loss, gathered gradients, BatchNorm
    statistics, the gathered weights equal on both ranks, the replicated
    leaves too; the anchor-free head on the first batch whose foreground
    masks agree), then bf16 against one process with K2; K2's launches a
    rank held to the gated convs (the 40x40 ones in float32), at the
    global 64->64 shapes; (b) the parameters and Adam moments a rank
    holds against one process's. Returns K2's launches summed over the
    ranks."""
    runs, states = _sp_runs(yaml_path)
    # K2 on in float32 too: the gate takes the 40x40 convs there, so the
    # float32 bounds hold K2's model-mesh path as well
    runs = [dict(r, fused=True) for r in runs]
    ranks, rank_s = _mesh_ranks("model", TP_MODEL, runs, states, workdir,
                                "phase 23 (a)")
    k2_total = 0
    for head in ("anchor", "anchor_free"):
        run, t, got, (loss, grads, state, _), single_k2 = _matched_single(
            dev, runs, ranks, states, head, "phase 23 (a)")
        # every rank of the model group computes its data shard's whole loss
        rel_loss = abs(got[0]["metrics"]["loss"] - loss) / abs(loss)
        worst = _worst(got[0]["grads"], grads)
        bn_worst = _bn_worst(got[0]["state"], state)
        across = _ranks_differ(got[0]["state"], got[1]["state"])
        replicated = [k for k in _ranks_differ(got[0]["local"],
                                               got[1]["local"])
                      if k not in got[0]["keys"]]
        full_bytes = 3 * 4 * sum(p.numel() for p in YOLO(
            YoloConfig(**run["cfg"]), device="meta").parameters())
        shares = [r["held_bytes"] / full_bytes for r in got]
        want = (sum(_gated_convs(YoloConfig(**run["cfg"])).values())
                * conv_bwd.LAUNCHES_PER_CALL)
        log(f"phase 23 (a) {head}, 1 x {TP_MODEL} data x model on one card "
            f"({card}; gloo on CUDA tensors; {rank_s:.1f} s for both ranks' "
            f"steps with start-up), 's' @{IMG_SIZE} nc={AF_NC} float32 TF32 "
            f"off, a global batch of {SP_BATCH} (images {t * SP_BATCH}-"
            f"{(t + 1) * SP_BATCH - 1}) vs one process: loss "
            f"{got[0]['metrics']['loss']:.7f} vs {loss:.7f} ({rel_loss:.2e} "
            f"relative, tol {PARITY_LOSS_TOL}); worst gathered gradient "
            f"{worst[0]:.2e} of its tensor's max ({worst[1]}; tol "
            f"{PARITY_GRAD_TOL}); BatchNorm statistics worst "
            f"{bn_worst[0]:.2e} of the tensor's max ({bn_worst[1]}; tol "
            f"{SP_BN_TOL}); gathered state tensors differing between "
            f"the ranks: {len(across)}, replicated ones: {len(replicated)}; "
            f"K2 on: launches a rank {[r['k2'] for r in got]} (want {want}, "
            f"one process {single_k2})")
        log(f"phase 23 (b) {head}: parameters + Adam moments held a rank "
            f"{[r['held_bytes'] for r in got]} bytes vs one process's "
            f"{full_bytes} ({', '.join(f'{x:.4f}x' for x in shares)}; at "
            f"most {TP_MEMORY_SHARE}x)")
        if (rel_loss > PARITY_LOSS_TOL or worst[0] > PARITY_GRAD_TOL
                or bn_worst[0] > SP_BN_TOL or across or replicated
                or single_k2 != want or any(r["k2"] != want for r in got)):
            raise AssertionError(f"phase 23 (a) {head}: the model-parallel "
                                 f"step differs from one process's")
        if max(shares) > TP_MEMORY_SHARE:
            raise AssertionError(f"phase 23 (b) {head}: a rank holds "
                                 f"{max(shares):.4f}x one process's state")
        # bf16, K2 on: its launches and shapes on each rank, against one
        # process with K2
        # bf16's own noise beside it: one process's bf16 step against its
        # float32 step on the same batch (batch 0)
        loss32, grads32 = (loss, grads) if t == 0 else (None, None)
        run = next(r for r in runs if r["name"] == (head, "bfloat16", 0))
        bf16 = [r[run["name"]] for r in ranks]
        conv_bwd.launches = 0
        loss, grads, _, _ = _single_step(dev, run, states[head])
        single_k2 = conv_bwd.launches
        gated = sum(_gated_convs(YoloConfig(**run["cfg"])).values())
        want = gated * conv_bwd.LAUNCHES_PER_CALL
        shapes = {s for r in bf16 for s in r["k2_shapes"]}
        rel_loss = abs(bf16[0]["metrics"]["loss"] - loss) / abs(loss)
        worst = _worst(bf16[0]["grads"], grads)
        noise = ("float32 batch not batch 0" if loss32 is None else
                 f"{abs(loss - loss32) / abs(loss32):.2e} relative loss, worst "
                 f"gradient {_worst(grads, grads32)[0]:.2e} of its max")
        across = _ranks_differ(bf16[0]["state"], bf16[1]["state"])
        log(f"phase 23 (a) {head} bf16, YOLO_FUSED_CONV_BWD=1 ({card}): K2 "
            f"launches a rank {[r['k2'] for r in bf16]} for one step (want "
            f"{gated} gated convs x {conv_bwd.LAUNCHES_PER_CALL} = {want}; one "
            f"process {single_k2}), at (x, dy, w) shapes {sorted(shapes)}; "
            f"loss {bf16[0]['metrics']['loss']:.6f} vs one process with K2 "
            f"{loss:.6f} ({rel_loss:.2e} relative, tol {TP_BF16_LOSS_RTOL}); "
            f"worst gathered gradient {worst[0]:.2e} of its tensor's max "
            f"({worst[1]}; logged); one process's bf16 step against its "
            f"float32 one: {noise}; gathered state tensors differing "
            f"between the ranks: {len(across)}")
        if (any(r["k2"] != want for r in bf16) or single_k2 != want or across
                or any(x[1] != 64 or dy[1] != 64 or w != (64, 64, 3, 3)
                       or x[0] != SP_BATCH for x, dy, w in shapes)
                or rel_loss > TP_BF16_LOSS_RTOL
                or not np.isfinite(bf16[0]["metrics"]["loss"])):
            raise AssertionError(f"phase 23 (a) {head} bf16: K2's launches "
                                 f"or shapes, the ranks, or the step")
        k2_total += sum(r["k2"] for r in bf16) + sum(r["k2"] for r in got)
    return k2_total


def phase_mesh_k2(dev, card, cases, seed, what):
    """K2 at a mesh's shapes (`cases`: B, H, W, dtype) against its plain
    version, two runs bit-equal; device ms of the kernel, its plain
    version and the one-call library backward beside the H100 bound.
    Returns (largest absolute error, {case: (kernel, plain, library,
    bound)})."""
    err, times = 0.0, {}
    for i, (b, h, w, dtype) in enumerate(cases):
        (x, dy, wt), e, rel_dx, rel_dw = _k2_held(b, h, w, dtype, dev,
                                                  seed + i)
        err = max(err, e)
        ms = [device_ms(f) for f in (
            lambda: conv_bwd._launch(x, dy, wt),
            lambda: conv_bwd.fused_bwd_plain(x, dy, wt),
            lambda: bwdproto.library_bwd(x, dy, wt))]
        bound = _bound(b, h, w, dtype)
        times[(b, h, w)] = (*ms, bound[0])
        log(f"{what} {_case_name(b, h, w, dtype)} ({card}): dx err "
            f"{rel_dx:.3e}, dW err {rel_dw:.3e} of max (tol "
            f"{K2_TOL[dtype][0]:.1e} / {K2_TOL[dtype][1]:.1e}), 2 runs "
            f"bit-equal; device ms (profiler, {TIMING_RUNS} calls): kernel "
            f"{ms[0]:.4f}, plain {ms[1]:.4f}, library convolution_backward "
            f"{ms[2]:.4f}, H100 bound {bound[0]:.4f} ({bound[1]}; kernel at "
            f"{bound[0] / ms[0]:.1%} of it)")
    return err, times


MESH_CLI_SCRIPT = r"""
import sys

from yolo_from_scratch_tpu_torch import cli
from yolo_from_scratch_tpu_torch.ops import conv_bwd, nms_cuda

rank, world, coordinator, *args = sys.argv[1:]
rc = cli.main(args + ["--distributed", "--coordinator", coordinator,
                      "--num-processes", world, "--process-id", rank])
print(f"LAUNCHES K1 {nms_cuda.launches} K2 {conv_bwd.launches}", flush=True)
sys.exit(rc)
"""


def _mesh_flag(axis):
    """(the CLI flag, N) of a mesh axis: "space" `--spatial 2`, "model"
    `--model-parallel 2`."""
    return {"space": ("--spatial", SP_SPACE),
            "model": ("--model-parallel", TP_MODEL)}[axis]


def start_mesh_cli(workdir, yaml_path, axis):
    """Start `check_mesh_cli`'s three CLI runs at once (their ranks share
    the card and its host): (the started runs, their start time)."""
    flag, n = _mesh_flag(axis)
    repo = str(Path(__file__).resolve().parent)
    env = dict(os.environ, YOLO_FUSED_CONV_BWD="1", PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    started = []
    for head, n_data, steps in (
            ("anchor", 1, TRAIN_STEPS), ("anchor_free", 1, TRAIN_STEPS),
            ("anchor", 2, 1 if axis == "space" else TRAIN_STEPS)):
        run_dir = workdir / f"{axis}_cli_{head}_{n_data}x{n}"
        run_dir.mkdir()
        batch = 16 // (n_data * steps)  # 16 train images
        args = [str(yaml_path), "--epochs", "1", "--batch-size", str(batch),
                "--size", "s", "--img-size", str(IMG_SIZE), "--val-det",
                "--head", head, "--data-parallel", flag, str(n)]
        started.append((head, n_data, steps, run_dir, _start_ranks(
            MESH_CLI_SCRIPT, lambda r, args=args: args, n_data * n,
            run_dir, env)))
    return started, t0


def check_mesh_cli(dev, card, started, axis, what):
    """`--data-parallel --distributed` with the mesh flag of `axis`
    ("space": `--spatial 2`, "model": `--model-parallel 2`) through the
    CLI, one bf16 epoch of the 16 train images with --val-det, K2 on:
    each head in two processes on the card (1 x 2, 2 steps), and the
    anchor head in four (2 x 2; one step under --spatial, 2 under
    --model-parallel), the three runs at once (`start_mesh_cli`, which
    starts them beside the phase's rank steps). Every rank prints the 2-D
    banner (and, on a model mesh, JAX's sharded-fraction line) and the
    same epoch line, K1's launches rise on every rank and K2's equal the
    gated convs; rank 0's checkpoint, at full size, serves one request
    through K1 in a one-process `Predictor`. Returns (K1, K2) launches
    summed over every rank and the requests."""
    from yolo_from_scratch_tpu_torch.parallel.mesh import Mesh
    from yolo_from_scratch_tpu_torch.parallel.tensor import (
        shard_model_,
        sharded_fraction,
    )

    flag, n = _mesh_flag(axis)
    started, t0 = started
    k1_total = k2_total = 0
    for head, n_data, steps, run_dir, procs in started:
        world = n_data * n
        outs = _join_ranks(procs, f"{what} {head} {n_data}x{n}")
        wall = time.perf_counter() - t0
        cfg = YoloConfig.from_size("s", num_classes=AF_NC, img_size=IMG_SIZE,
                                   compute_dtype="bfloat16", head_type=head)
        banners = [f"2-D mesh: data={n_data} x {axis}={n} over {world} "
                   f"process(es)"]
        if axis == "model":
            fraction = sharded_fraction(shard_model_(
                YOLO(cfg, device="meta"),
                Mesh(0, n, torch.device("cpu"), n_model=n)))
            banners.append(f"Model-parallel: {fraction:.0%} of params "
                           f"channel-sharded {n}-way")
        want_k2 = (sum(_gated_convs(cfg).values()) * steps
                   * conv_bwd.LAUNCHES_PER_CALL)
        epochs, launches = [], []
        for r, out in enumerate(outs):
            epoch = re.search(r"Epoch 1: .* \| LR: ", out)
            counts = re.search(r"LAUNCHES K1 (\d+) K2 (\d+)", out)
            if (not epoch or " | Det: P " not in epoch.group(0) or not counts
                    or any(b not in out.splitlines() for b in banners)
                    or "backend gloo" not in out):
                raise AssertionError(f"{what} {head} rank {r}:\n{out}")
            epochs.append(epoch.group(0))
            launches.append((int(counts.group(1)), int(counts.group(2))))
        ckpt = sorted(run_dir.glob("yolo_*.ckpt"))
        if len(ckpt) != 1:
            raise AssertionError(f"{what}: checkpoints {ckpt}")
        sd, ckpt_cfg, _ = load_checkpoint(ckpt[0])
        full = {k: tuple(v.shape) for k, v in
                YOLO(ckpt_cfg, device="meta").state_dict().items()}
        img = np.random.default_rng(SEED).integers(
            0, 256, (IMG_SIZE, IMG_SIZE, 3), dtype=np.uint8)
        nms_cuda.launches = 0
        dets = Predictor(sd, ckpt_cfg, conf_threshold=1e-6, device=dev)(img)
        torch.cuda.synchronize()
        k1_request = nms_cuda.launches
        log(f"{what} {head} CLI --distributed {flag} {n} over {world} "
            f"processes ({n_data} x {n}) on one card ({card}), 1 bf16 epoch "
            f"of {steps} step(s) + --val-det, K2 on: done {wall:.1f} s after "
            f"the three runs' start; banners {banners} on every rank; epoch "
            f"lines equal on every rank: {len(set(epochs)) == 1}; (K1, K2) "
            f"launches a rank {launches} (K2 want {want_k2}); rank 0's "
            f"checkpoint ({ckpt_cfg.head_type}, full size: "
            f"{ {k: tuple(v.shape) for k, v in sd.items()} == full}) served "
            f"{len(dets)} detections, K1 launched {k1_request} times")
        if (len(set(epochs)) != 1 or any(k1 < 1 or k2 != want_k2
                                         for k1, k2 in launches)
                or ckpt_cfg.head_type != head or not dets or k1_request < 1
                or {k: tuple(v.shape) for k, v in sd.items()} != full):
            raise AssertionError(f"{what} {head}: the ranks differ, or a "
                                 f"kernel's launches, the checkpoint or the "
                                 f"request")
        k1_total += sum(k1 for k1, _ in launches) + k1_request
        k2_total += sum(k2 for _, k2 in launches)
    return k1_total, k2_total


WC_STREAM_SCRIPT = r"""
import sys

import torch

from yolo_from_scratch_tpu_torch import YoloConfig
from yolo_from_scratch_tpu_torch.device import tf32_disabled
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import conv_bwd
from yolo_from_scratch_tpu_torch.parallel.distributed import (
    init_distributed, shutdown)
from yolo_from_scratch_tpu_torch.parallel.mesh import make_mesh
from yolo_from_scratch_tpu_torch.train import steps

rank, world, coordinator, job_path, out_path = sys.argv[1:6]
rank, world = int(rank), int(world)
# a loopback coordinator with more ranks than cards: gloo
init_distributed(coordinator, world, rank, device="cuda")
mesh = make_mesh("cuda")
job = torch.load(job_path, weights_only=False)
cfg = YoloConfig(**job["cfg"])
model = YOLO(cfg)
model.load_state_dict(job["state"])
model.to(mesh.device)
state = steps.TrainState(model, steps.make_optimizer(
    model.parameters(), job["lr"], capturable=True))
b = job["chunk"][0].shape[1] // world
chunk = [torch.from_numpy(a[:, rank * b:(rank + 1) * b].copy()).to(
    mesh.device) for a in job["chunk"]]
trainer = steps.make_train_step_multi_compact(cfg, device=mesh.device,
                                              mesh=mesh, **job["kw"])
conv_bwd.launches = 0
with tf32_disabled():
    state, m = trainer(state, *chunk)
torch.cuda.synchronize()
torch.save({"metrics": {k: v.item() for k, v in m.items()},
            "state": {k: v.cpu() for k, v in model.state_dict().items()},
            "k2": conv_bwd.launches, "step": state.step,
            "path": steps.chunk_path(mesh.device, mesh),
            "backend": torch.distributed.get_backend()}, out_path)
shutdown()
"""


def _wc_runs(yaml_path):
    """Phase 24 (a)'s mosaic steps on one global batch of WC_BATCH: the
    anchor head float32 (K2 off) and bf16 (K2 on), the anchor-free head
    bf16 (K2 on), and the heads' seeded weights."""
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    train = load_dataset_yaml(yaml_path)["train"]
    runs, states = [], {}
    for head, dtypes in (("anchor", ("float32", "bfloat16")),
                         ("anchor_free", ("bfloat16",))):
        cfg = YoloConfig.from_size("s", num_classes=AF_NC, img_size=IMG_SIZE,
                                   head_type=head)
        states[head] = YOLO(cfg).reset_parameters(
            torch.Generator().manual_seed(SEED)).state_dict()
        ds = YoloDataset(train, AF_NC, cfg.anchors_array, IMG_SIZE,
                         backend="pil", head_type=head)
        images, labels, counts = ds.load_batch_compact(
            range(WC_BATCH), capacity=COMPACT_K, image_dtype="uint8")
        for dtype in dtypes:
            runs.append(dict(
                name=(head, dtype, 0), cfg=dict(
                    num_classes=AF_NC, img_size=IMG_SIZE,
                    width_mult=cfg.width_mult, depth_mult=cfg.depth_mult,
                    head_type=head, compute_dtype=dtype),
                images=images, targets=[labels, counts],
                kw=dict(compact_targets=True, device_mosaic=True,
                        augment_seed=SEED),
                fused=dtype == "bfloat16"))
    return runs, states


def phase_world_mosaic(dev, workdir, yaml_path, card):
    """(a) `--compact-targets --device-mosaic` on two ranks on the one card
    (`gloo` on CUDA tensors), one global batch of WC_BATCH, on the 1-D
    mesh (partners gathered over the ranks), 1 x 2 data x space (whole
    images composed, rows cut after the mosaic) and 1 x 2 data x model,
    the three launches at once: the anchor head in float32 TF32 off
    against one process on the global batch with the same draws (loss,
    gradients, BatchNorm statistics at phases 21 (c), 22 (a) and 23 (a)'s
    tolerances), both heads in bf16 with K2 against one process with K2
    (loss at phase 23's TP_BF16_LOSS_RTOL), K2's launches a rank held to
    the gated convs, the ranks' gathered states bit-equal. Returns K2's
    launches summed over the ranks."""
    runs, states = _wc_runs(yaml_path)
    workdir.mkdir(exist_ok=True)
    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    started = {}
    for axis in ("data", "space", "model"):
        job = workdir / f"{axis}_job.pt"
        torch.save({"runs": runs, "states": states, "lr": DP_LR,
                    "axis": axis, "n": 2}, job)
        started[axis] = _start_ranks(
            MESH_RANK_SCRIPT, lambda r, axis=axis, job=job: (
                str(job), str(workdir / f"{axis}_rank{r}.pt")), 2, repo)
    singles = {}
    for run in runs:
        conv_bwd.launches = 0
        singles[run["name"]] = (*_single_step(dev, run,
                                              states[run["name"][0]]),
                                conv_bwd.launches)
    ranks = {}
    for axis, procs in started.items():
        _join_ranks(procs, f"phase 24 (a) {axis}")
        ranks[axis] = [torch.load(workdir / f"{axis}_rank{r}.pt",
                                  weights_only=False) for r in range(2)]
        if any(r["backend"] != "gloo" for r in ranks[axis]):
            raise AssertionError(f"phase 24 (a) {axis}: the ranks sharing "
                                 f"the card are not on gloo")
    rank_s = time.perf_counter() - t0
    # each axis's float32 tolerances: phase 21 (c)'s, 22 (a)'s, 23 (a)'s
    tols = {"data": (PARITY_LOSS_TOL, DP_BN_RTOL, DP_BN_ATOL),
            "space": (SP_LOSS_RTOL["anchor"], 0.0, SP_BN_TOL),
            "model": (PARITY_LOSS_TOL, 0.0, SP_BN_TOL)}
    k2_total = 0
    for axis, got_all in ranks.items():
        for run in runs:
            head, dtype, _ = run["name"]
            got = [r[run["name"]] for r in got_all]
            loss, grads, state, _, single_k2 = singles[run["name"]]
            # a model group's ranks each compute their data shard's loss
            total = (got[0]["metrics"]["loss"] if axis == "model"
                     else sum(r["metrics"]["loss"] for r in got))
            rel_loss = abs(total - loss) / abs(loss)
            across = _ranks_differ(got[0]["state"], got[1]["state"])
            cfg = YoloConfig(**run["cfg"])
            want_k2 = (sum(_gated_convs(cfg).values())
                       * conv_bwd.LAUNCHES_PER_CALL if run["fused"] else 0)
            k2 = [r["k2"] for r in got]
            k2_total += sum(k2)
            what = (f"phase 24 (a) {axis} 1 x 2 ({card}), {head} {dtype} "
                    f"--device-mosaic, a global batch of {WC_BATCH}")
            if dtype == "float32":
                loss_tol, bn_rtol, bn_atol = tols[axis]
                worst = _worst(got[0]["grads"], grads)
                bn = [k for k in state if k.endswith((".bn.mean", ".bn.var"))]
                bn_bad = [k for k in bn if not np.allclose(
                    got[0]["state"][k].numpy(), state[k].numpy(),
                    rtol=bn_rtol, atol=bn_atol * state[k].abs().max().item())]
                bn_worst = _bn_worst(got[0]["state"], state)
                log(f"{what}, TF32 off, vs one process: loss {total:.7f} vs "
                    f"{loss:.7f} ({rel_loss:.2e} relative, tol {loss_tol}); "
                    f"worst gradient {worst[0]:.2e} of its tensor's max "
                    f"({worst[1]}; tol {PARITY_GRAD_TOL}); BatchNorm "
                    f"statistics worst {bn_worst[0]:.2e} of the tensor's max "
                    f"({bn_worst[1]}), {len(bn) - len(bn_bad)} / {len(bn)} "
                    f"within rtol {bn_rtol} + {bn_atol} of the max; state "
                    f"tensors differing between the ranks: {len(across)}")
                if (rel_loss > loss_tol or worst[0] > PARITY_GRAD_TOL
                        or bn_bad or across):
                    raise AssertionError(f"{what}: the ranks differ from "
                                         f"one process")
                continue
            log(f"{what}, YOLO_FUSED_CONV_BWD=1, vs one process with K2: loss "
                f"{total:.6f} vs {loss:.6f} ({rel_loss:.2e} relative, tol "
                f"{TP_BF16_LOSS_RTOL}); K2 launches a rank {k2} (want "
                f"{want_k2}, one process {single_k2}); state tensors "
                f"differing between the ranks: {len(across)}")
            if (rel_loss > TP_BF16_LOSS_RTOL or across or single_k2 != want_k2
                    or any(k != want_k2 for k in k2)):
                raise AssertionError(f"{what}: the loss, K2's launches or "
                                     f"the ranks")
    log(f"phase 24 (a): three launches of two ranks, {rank_s:.1f} s with "
        f"start-up and the one-process steps")
    return k2_total


def _wc_chunk(yaml_path, n, b):
    """n steps of b images of phase 16's train split from image 0: uint8
    images (n, b, S, S, 3), compact labels (n, b, K, 5), counts (n, b)."""
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    ds = YoloDataset(load_dataset_yaml(yaml_path)["train"], AF_NC,
                     img_size=IMG_SIZE, backend="pil")
    images, labels, counts = ds.load_batch_compact(
        range(n * b), capacity=COMPACT_K, image_dtype="uint8")
    return tuple(a.reshape(n, b, *a.shape[1:])
                 for a in (images, labels, counts))


def start_world_stream(workdir, yaml_path):
    """(b3) starts two `gloo` ranks on the card, each running the scanned
    trainer's eager chunk of WC_N steps on its two images of a global
    batch of WC_BATCH (float32 TF32 off, the anchor head's stream recipe,
    K2 on); `check_world_stream` joins them. Returns what it needs."""
    workdir.mkdir(exist_ok=True)
    cfg = YoloConfig.from_size("s", num_classes=AF_NC, img_size=IMG_SIZE,
                               compute_dtype="float32")
    state = YOLO(cfg).reset_parameters(
        torch.Generator().manual_seed(SEED)).state_dict()
    chunk = _wc_chunk(yaml_path, WC_N, WC_BATCH)
    job = workdir / "stream_job.pt"
    torch.save({"cfg": dict(num_classes=AF_NC, img_size=IMG_SIZE,
                            width_mult=cfg.width_mult,
                            depth_mult=cfg.depth_mult,
                            compute_dtype="float32"),
                "state": state, "lr": WC_STREAM_LR, "chunk": chunk,
                "kw": WC_STREAM_FLAGS}, job)
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    procs = _start_ranks(WC_STREAM_SCRIPT, lambda r: (
        str(job), str(workdir / f"stream_rank{r}.pt")), 2,
        Path(__file__).resolve().parent)
    return workdir, cfg, state, chunk, procs, time.perf_counter()


def phase_nccl_world1(dev, yaml_path, card):
    """(b1) a bare `all_reduce` captured in a CUDA graph on an NCCL world
    of one in this process, replayed twice; then the scanned trainer on
    that group (the anchor head's stream recipe, 's' b8 bf16, K2 on)
    captures its collectives and replays, K2's launches in one replay
    from the profiler. Returns those launches."""
    import torch.distributed as dist

    from yolo_from_scratch_tpu_torch.parallel.mesh import make_mesh
    from yolo_from_scratch_tpu_torch.train import steps

    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    t0 = time.perf_counter()
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        buf = torch.zeros(4, device=dev)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            dist.all_reduce(buf)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            buf.add_(1.0)
            dist.all_reduce(buf)
            buf.mul_(2.0)
        replays = []
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            replays.append(buf.tolist())
        log(f"phase 24 (b1) a bare all_reduce captured on an NCCL world of "
            f"one ({card}; torch {torch.__version__}, NCCL "
            f"{'.'.join(map(str, torch.cuda.nccl.version()))}): two replays "
            f"read {replays} (want [2.0] * 4, [6.0] * 4)")
        if replays != [[2.0] * 4, [6.0] * 4]:
            raise AssertionError("phase 24 (b1): the captured all_reduce")
        del graph
        mesh = make_mesh(dev)
        cfg = _stream_cfg("anchor")
        path = steps.chunk_path(dev, mesh)
        state = create_train_state(cfg, 1e-3, seed=SEED, device=dev)
        trainer = steps.make_train_step_multi_compact(
            cfg, device=dev, mesh=mesh, **WC_STREAM_FLAGS)
        chunk = [torch.from_numpy(a).to(dev)
                 for a in _wc_chunk(yaml_path, WC_CLI_CHUNK, 8)]
        state, m = trainer(state, *chunk)
        counts = _launch_counts(lambda: trainer(state, *chunk))
        k2 = sum(n for k, (n, _) in counts.items() if "conv3x3_bwd" in k)
        want = (sum(_gated_convs(cfg).values()) * WC_CLI_CHUNK
                * conv_bwd.LAUNCHES_PER_CALL)
        nccl = sum(n for k, (n, _) in counts.items() if "nccl" in k.lower())
        log(f"phase 24 (b1) the scanned trainer on that group ('s' @"
            f"{IMG_SIZE} nc={AF_NC} b8 bf16, {WC_CLI_CHUNK} steps, the "
            f"anchor head's stream recipe): chunks {path!r}; one replay "
            f"launches {sum(n for n, _ in counts.values())} kernels, K2 {k2} "
            f"of them (want {want}), NCCL kernels {nccl}; loss "
            f"{m['loss'].item():.4f}; {time.perf_counter() - t0:.1f} s")
        if (path != "CUDA graph (nccl)" or k2 != want
                or not np.isfinite(m["loss"].item())):
            raise AssertionError("phase 24 (b1): the NCCL chunk graph")
        del trainer, state, chunk
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return k2


def phase_stream_cli_world1(workdir, yaml_path, card):
    """(b2) the CLI's `--distributed --stream` at a world of one over NCCL
    (collectives inside the chunk's graph) against the flagless `--stream`,
    2 epochs of WC_CLI_CHUNK steps at b8, deterministic as in phase 18:
    the checkpoints bit-equal, the banners naming the graphed chunks, K2's
    wrapper calls (warm-up and capture) equal."""
    args = [str(yaml_path), "--epochs", "2", "--batch-size", "8", "--size",
            "s", "--img-size", str(IMG_SIZE), "--stream", "--stream-chunk",
            str(WC_CLI_CHUNK), "--compact-targets", *STREAM_FLAGS["anchor"]]
    world1 = ["--distributed", "--coordinator", f"127.0.0.1:{_free_port()}",
              "--num-processes", "1", "--process-id", "0"]
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    workdir.mkdir(exist_ok=True)
    ckpts, banners, calls = {}, {}, {}
    cwd = os.getcwd()
    t0 = time.perf_counter()
    try:
        for name, extra in (("flagless", []), ("world1", world1)):
            (workdir / f"cli_{name}").mkdir()
            os.chdir(workdir / f"cli_{name}")
            conv_bwd.launches = 0
            with _deterministic():
                rc, out = _cli(args + extra)
            calls[name] = conv_bwd.launches
            banner = re.search(r"; chunks: (.*)$", out, re.M)
            if (rc != 0 or not banner
                    or len(re.findall(r"^Epoch \d: ", out, re.M)) != 2):
                raise AssertionError(f"phase 24 (b2) {name} CLI: rc {rc}, "
                                     f"output:\n{out}")
            banners[name] = banner.group(1)
            ckpts[name] = _flat_tree(read_payload(_saved(out, name)))
    finally:
        os.chdir(cwd)
    a, b = ckpts["world1"], ckpts["flagless"]
    differ = sorted(k for k in b if k not in a or not np.array_equal(a[k],
                                                                     b[k]))
    log(f"phase 24 (b2) CLI --distributed --stream at a world of one (NCCL) "
        f"vs --stream ({card}), 2 epochs of {WC_CLI_CHUNK} steps at b8, "
        f"deterministic: checkpoints {len(b) - len(differ)} / {len(b)} leaves "
        f"bit-equal; chunks {banners}; K2 wrapper calls (warm-up and capture) "
        f"{calls}; {time.perf_counter() - t0:.1f} s")
    if (differ or set(a) != set(b) or banners["world1"] != "CUDA graph (nccl)"
            or banners["flagless"] != "CUDA graph"
            or calls["world1"] != calls["flagless"]):
        raise AssertionError(f"phase 24 (b2): world 1 differs from the "
                             f"flagless run: {differ[:8]}")


def check_world_stream(dev, card, started):
    """(b3) one process's graphed chunk on the global batch against the
    two ranks of `start_world_stream`: the mean loss (the ranks' parts
    summed) and the BatchNorm statistics at phase 21 (c)'s tolerances, the
    ranks' states bit-equal, their chunks eager on gloo, K2's calls held
    to the gated convs. Returns the ranks' K2 launches."""
    from yolo_from_scratch_tpu_torch.train import steps

    workdir, cfg, state_dict, chunk, procs, t0 = started
    model = YOLO(cfg)
    model.load_state_dict(state_dict)
    model.to(dev)
    state = steps.TrainState(model, steps.make_optimizer(
        model.parameters(), WC_STREAM_LR, capturable=True))
    conv_bwd.launches = 0
    with tf32_disabled():
        state, m = steps.make_train_step_multi_compact(
            cfg, device=dev, **WC_STREAM_FLAGS)(
            state, *(torch.from_numpy(x).to(dev) for x in chunk))
    torch.cuda.synchronize()
    single_calls = conv_bwd.launches
    want_state = {k: v.cpu() for k, v in model.state_dict().items()}
    loss = m["loss"].item()
    _join_ranks(procs, "phase 24 (b3)")
    ranks = [torch.load(workdir / f"stream_rank{r}.pt", weights_only=False)
             for r in range(2)]
    total = sum(r["metrics"]["loss"] for r in ranks)
    rel_loss = abs(total - loss) / abs(loss)
    bn = [k for k in want_state if k.endswith((".bn.mean", ".bn.var"))]
    bn_bad = [k for k in bn if not np.allclose(
        ranks[0]["state"][k].numpy(), want_state[k].numpy(), rtol=DP_BN_RTOL,
        atol=DP_BN_ATOL * want_state[k].abs().max().item())]
    bn_worst = _bn_worst(ranks[0]["state"], want_state)
    across = _ranks_differ(ranks[0]["state"], ranks[1]["state"])
    gated = sum(_gated_convs(cfg).values()) * conv_bwd.LAUNCHES_PER_CALL
    log(f"phase 24 (b3) two gloo ranks' eager chunk ({ranks[0]['path']!r}; "
        f"{WC_N} steps, {WC_BATCH // 2} images a rank; {card}) vs one "
        f"process's graphed chunk on {WC_BATCH}, 's' @{IMG_SIZE} nc={AF_NC} "
        f"float32 TF32 off, lr {WC_STREAM_LR}, "
        f"{' '.join(STREAM_FLAGS['anchor'])}: mean loss {total:.7f} vs "
        f"{loss:.7f} ({rel_loss:.2e} relative, tol {PARITY_LOSS_TOL}); "
        f"BatchNorm statistics worst {bn_worst[0]:.2e} of the tensor's max "
        f"({bn_worst[1]}), {len(bn) - len(bn_bad)} / {len(bn)} within rtol "
        f"{DP_BN_RTOL} + {DP_BN_ATOL} of the max; state tensors differing "
        f"between the ranks: {len(across)}; K2 wrapper calls a rank "
        f"{[r['k2'] for r in ranks]} (want {gated * WC_N}), one process "
        f"{single_calls} (warm-up + capture, want {gated * (1 + WC_N)}); "
        f"{time.perf_counter() - t0:.1f} s since the ranks' start")
    if (rel_loss > PARITY_LOSS_TOL or bn_bad or across
            or any(r["path"] != "eager (gloo cannot be captured)"
                   or r["backend"] != "gloo" or r["step"] != WC_N
                   or r["k2"] != gated * WC_N for r in ranks)
            or single_calls != gated * (1 + WC_N)):
        raise AssertionError("phase 24 (b3): the ranks' eager chunk differs "
                             "from one process's graphed chunk")
    return sum(r["k2"] for r in ranks)


def start_world_multiscale(workdir, yaml_path):
    """(c) starts the CLI's `--multi-scale --val-det` one-epoch runs, each
    in two processes on the card, the three at once: 1-D at IMG_SIZE,
    `--spatial 2 --img-size WC_SPATIAL_IMG`, `--model-parallel 2`. Returns
    the started runs for `check_world_multiscale`."""
    workdir.mkdir(exist_ok=True)
    repo = str(Path(__file__).resolve().parent)
    env = dict(os.environ, YOLO_FUSED_CONV_BWD="1", PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    started = []
    for axis, flags, img in (("data", [], IMG_SIZE),
                             ("space", ["--spatial", "2"], WC_SPATIAL_IMG),
                             ("model", ["--model-parallel", "2"], IMG_SIZE)):
        run_dir = workdir / f"ms_{axis}"
        run_dir.mkdir()
        args = [str(yaml_path), "--epochs", "1", "--batch-size", "8",
                "--size", "s", "--img-size", str(img), "--val-det",
                "--multi-scale", "--data-parallel", *flags]
        started.append((axis, img, run_dir, _start_ranks(
            MESH_CLI_SCRIPT, lambda r, args=args: args, 2, run_dir, env)))
    return started, time.perf_counter()


def check_world_multiscale(dev, card, started):
    """(c) joins the runs of `start_world_multiscale`: every rank prints
    the bucket banner and the same epoch line, K1 launches on every rank,
    K2's launches equal the gated convs of the first bucket's size times
    the steps, and rank 0's checkpoint, at full size, serves one request
    through K1. Returns (K1, K2) launches summed over the ranks and the
    requests."""
    runs, t0 = started
    k1_total = k2_total = 0
    for axis, img, run_dir, procs in runs:
        outs = _join_ranks(procs, f"phase 24 (c) {axis}")
        sizes = cli.multi_scale_sizes(img)
        n_data = 2 if axis == "data" else 1
        steps = 16 // (8 * n_data)  # phase 16's 16 train images at b8
        cfg = YoloConfig.from_size("s", num_classes=AF_NC, img_size=sizes[0],
                                   compute_dtype="bfloat16")
        want_k2 = (sum(_gated_convs(cfg).values()) * steps
                   * conv_bwd.LAUNCHES_PER_CALL)
        epochs, launches = [], []
        for r, out in enumerate(outs):
            epoch = re.search(r"Epoch 1: .* \| LR: ", out)
            counts = re.search(r"LAUNCHES K1 (\d+) K2 (\d+)", out)
            if (not epoch or " | Det: P " not in epoch.group(0) or not counts
                    or f"Multi-scale buckets: {sizes} (epoch-rotated)"
                    not in out or "backend gloo" not in out):
                raise AssertionError(f"phase 24 (c) {axis} rank {r}:\n{out}")
            epochs.append(epoch.group(0))
            launches.append((int(counts.group(1)), int(counts.group(2))))
        ckpt = sorted(run_dir.glob("yolo_*.ckpt"))
        if len(ckpt) != 1:
            raise AssertionError(f"phase 24 (c) {axis}: checkpoints {ckpt}")
        sd, ckpt_cfg, _ = load_checkpoint(ckpt[0])
        full = {k: tuple(v.shape) for k, v in
                YOLO(ckpt_cfg, device="meta").state_dict().items()}
        img_u8 = np.random.default_rng(SEED).integers(
            0, 256, (img, img, 3), dtype=np.uint8)
        nms_cuda.launches = 0
        dets = Predictor(sd, ckpt_cfg, conf_threshold=1e-6, device=dev)(img_u8)
        torch.cuda.synchronize()
        k1_request = nms_cuda.launches
        at_full = {k: tuple(v.shape) for k, v in sd.items()} == full
        log(f"phase 24 (c) CLI --multi-scale --val-det --distributed {axis} "
            f"over 2 processes on one card ({card}) at --img-size {img}: "
            f"buckets {sizes}, one bf16 epoch of {steps} step(s) at "
            f"{sizes[0]}, done {time.perf_counter() - t0:.1f} s after the "
            f"three runs' start; epoch lines equal on both ranks: "
            f"{len(set(epochs)) == 1}; (K1, K2) launches a rank {launches} "
            f"(K2 want {want_k2}); rank 0's checkpoint (full size: {at_full}, "
            f"img {ckpt_cfg.img_size}) served {len(dets)} detections, K1 "
            f"launched {k1_request} times")
        if (len(set(epochs)) != 1 or any(k1 < 1 or k2 != want_k2
                                         for k1, k2 in launches)
                or not at_full or ckpt_cfg.img_size != img or not dets
                or k1_request < 1):
            raise AssertionError(f"phase 24 (c) {axis}: the ranks differ, a "
                                 f"kernel's launches, the checkpoint or the "
                                 f"request")
        k1_total += sum(k1 for k1, _ in launches) + k1_request
        k2_total += sum(k2 for _, k2 in launches)
    return k1_total, k2_total


def _un_runs(yaml_path, img, bf16):
    """Phase 25 (a)'s steps at `img`: both heads on compact labels (one
    batch of SP_BATCH images for the anchor head, AF_TRIES candidates for
    the anchor-free one), float32, and with `bf16` the first batch in
    bf16 with K2 on; the heads' seeded weights."""
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    train = load_dataset_yaml(yaml_path)["train"]
    runs, states = [], {}
    for head in ("anchor", "anchor_free"):
        cfg = YoloConfig.from_size("s", num_classes=AF_NC, img_size=img,
                                   head_type=head)
        states[head] = YOLO(cfg).reset_parameters(
            torch.Generator().manual_seed(SEED)).state_dict()
        ds = YoloDataset(train, AF_NC, cfg.anchors_array, img,
                         backend="pil", head_type=head)
        for t in range(1 if head == "anchor" else UN_AF_TRIES):
            images, labels, counts = ds.load_batch_compact(
                range(t * SP_BATCH, (t + 1) * SP_BATCH), capacity=COMPACT_K)
            for dtype in ("float32", "bfloat16"):
                if dtype == "bfloat16" and (t or not bf16):
                    continue
                runs.append(dict(
                    name=(head, dtype, t), cfg=dict(
                        num_classes=AF_NC, img_size=img,
                        width_mult=cfg.width_mult, depth_mult=cfg.depth_mult,
                        head_type=head, compute_dtype=dtype),
                    images=images, targets=[labels, counts],
                    kw=dict(compact_targets=True),
                    fused=dtype == "bfloat16"))
    return runs, states


def phase_uneven_step(dev, workdir, yaml_path, card):
    """(a) `--spatial N` on P5 grids N does not divide, 's' nc=80 on
    compact labels, a global batch of SP_BATCH, ranks on the one card
    (`gloo` on CUDA tensors), the three meshes at once: 1 x 2 @608 (P5
    rows 10 / 9), 1 x 3 @640 (7 / 7 / 6) and 1 x 4 @96 (1 / 1 / 1 / 0).
    float32 TF32 off against one process on the same batch, both heads, at
    phase 22 (a)'s gradient and BatchNorm tolerances and the loss at
    UN_LOSS_RTOL, every rank's state bit-equal (the
    anchor-free head on the first batch whose foreground masks agree);
    then at 608 and 640 bf16 with K2 on against one process with K2: the
    loss within UN_BF16_LOSS_RTOL, K2's launches a rank held to the gated
    convs, the tiles K2 ran at. One process's steps run while the ranks
    do. Returns K2's launches summed over the ranks."""
    from yolo_from_scratch_tpu_torch.parallel.mesh import row_split

    started = {}
    for n, img in UN_MESHES:
        runs, states = _un_runs(yaml_path, img, (n, img) in UN_K2_MESHES)
        started[(n, img)] = (runs, states, _start_mesh_ranks(
            "space", n, runs, states, workdir, f"_un{n}_{img}", UN_ENV))
    singles = {}
    for (n, img), (runs, states, _) in started.items():
        for run in runs:
            conv_bwd.launches = 0
            single = _single_step(dev, run, states[run["cfg"]["head_type"]])
            singles[(n, img, run["name"])] = (single, conv_bwd.launches)
    k2_total, failed = 0, []
    for (n, img), (runs, states, st) in started.items():
        what = f"phase 25 (a) 1 x {n} @{img}"
        ranks, rank_s = _join_mesh_ranks("space", n, st, workdir, what,
                                         f"_un{n}_{img}")
        blocks = row_split(img // 32, n)
        for head in ("anchor", "anchor_free"):
            for t in range(1 if head == "anchor" else UN_AF_TRIES):
                name = (head, "float32", t)
                (loss, grads, state, fg), _ = singles[(n, img, name)]
                got = [r[name] for r in ranks]
                n_diff = 0 if fg is None else int((got[0]["fg"] != fg).sum())
                if n_diff == 0:
                    break
                log(f"{what} {head}: images {t * SP_BATCH}-"
                    f"{(t + 1) * SP_BATCH - 1}: {n_diff} of {int(fg.sum())} "
                    f"fg cells differ from one process's; the next batch")
            else:
                raise AssertionError(f"{what}: {head} fg masks differ on "
                                     f"all {UN_AF_TRIES} batches")
            total = sum(r["metrics"]["loss"] for r in got)
            rel_loss = abs(total - loss) / abs(loss)

            worst = _worst(got[0]["grads"], grads)
            bn_worst = _bn_worst(got[0]["state"], state)
            across = sorted({k for r in got[1:]
                             for k in _ranks_differ(got[0]["state"],
                                                    r["state"])})
            log(f"{what} {head}, P5 rows a rank {blocks} ({card}; gloo on "
                f"CUDA tensors; {rank_s:.1f} s for the ranks' steps with "
                f"start-up), 's' nc={AF_NC} compact labels, float32 TF32 "
                f"off, a global batch of {SP_BATCH} (images {t * SP_BATCH}-"
                f"{(t + 1) * SP_BATCH - 1}) vs one process: loss "
                f"{total:.7f} vs {loss:.7f} ({rel_loss:.2e} relative, tol "
                f"{UN_LOSS_RTOL}; phase 22's {SP_LOSS_RTOL[head]} met: "
                f"{rel_loss <= SP_LOSS_RTOL[head]}); worst gradient "
                f"{worst[0]:.2e} of its "
                f"tensor's max ({worst[1]}; tol {PARITY_GRAD_TOL}); BatchNorm "
                f"statistics worst {bn_worst[0]:.2e} of the tensor's max "
                f"({bn_worst[1]}; tol {SP_BN_TOL}); state tensors differing "
                f"between the ranks: {len(across)}")
            if (rel_loss > UN_LOSS_RTOL or worst[0] > PARITY_GRAD_TOL
                    or bn_worst[0] > SP_BN_TOL or across):
                failed.append(f"{what} {head}: the step differs from one "
                              f"process's")
            if (n, img) not in UN_K2_MESHES:
                continue
            name = (head, "bfloat16", 0)
            bf16 = [r[name] for r in ranks]
            (loss, _, _, _), single_k2 = singles[(n, img, name)]
            cfg = YoloConfig(**next(r["cfg"] for r in runs
                                    if r["name"] == name))
            want = sum(_gated_convs(cfg).values()) * conv_bwd.LAUNCHES_PER_CALL
            total = sum(r["metrics"]["loss"] for r in bf16)
            rel_loss = abs(total - loss) / abs(loss)
            tiles = [sorted({x[2:] for x, _, _ in r["k2_shapes"]})
                     for r in bf16]
            across = sorted({k for r in bf16[1:]
                             for k in _ranks_differ(bf16[0]["state"],
                                                    r["state"])})
            log(f"{what} {head} bf16, YOLO_FUSED_CONV_BWD=1 ({card}): K2 "
                f"launches a rank {[r['k2'] for r in bf16]} for one step "
                f"(want {want}; one process {single_k2}) at the haloed "
                f"tiles (H, W) a rank {tiles}; loss {total:.6f} vs one "
                f"process with K2 {loss:.6f} ({rel_loss:.2e} relative, tol "
                f"{UN_BF16_LOSS_RTOL}); state tensors differing between the "
                f"ranks: {len(across)}")
            if (any(r["k2"] != want for r in bf16) or single_k2 != want
                    or rel_loss > UN_BF16_LOSS_RTOL or across
                    or not np.isfinite(total)):
                failed.append(f"{what} {head} bf16: K2's launches, the "
                              f"ranks or the step")
            k2_total += sum(r["k2"] for r in bf16)
    if failed:
        raise AssertionError("; ".join(failed))
    return k2_total


def start_uneven_cli(workdir, yaml_path):
    """(c) start the CLI's `--distributed --data-parallel --spatial 2` in
    two processes a run, all at once, K2 on: both heads with
    `--compact-targets --img-size 608 --val-det` (one epoch of 2 steps),
    `--compact-targets --multi-scale` at 640 (3 epochs of one step: the
    buckets 480, 640 and 800, P5 rows 15, 20 and 25), and the anchor head
    with dense targets at 608. Returns the started runs."""
    repo = str(Path(__file__).resolve().parent)
    env = dict(UN_ENV, YOLO_FUSED_CONV_BWD="1", PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    common = [str(yaml_path), "--size", "s", "--data-parallel", "--spatial",
              "2"]
    runs = {
        "anchor": common + ["--epochs", "1", "--batch-size", "8",
                            "--img-size", str(UN_CLI_IMG), "--val-det",
                            "--compact-targets"],
        "anchor_free": common + ["--epochs", "1", "--batch-size", "8",
                                 "--img-size", str(UN_CLI_IMG), "--val-det",
                                 "--compact-targets", "--head",
                                 "anchor_free"],
        "multi_scale": common + ["--epochs", "3", "--batch-size", "16",
                                 "--img-size", str(UN_MS_IMG),
                                 "--multi-scale", "--compact-targets"],
        "dense": common + ["--epochs", "1", "--batch-size", "8",
                           "--img-size", str(UN_CLI_IMG)]}
    started = {}
    for name, args in runs.items():
        run_dir = workdir / f"un_cli_{name}"
        run_dir.mkdir()
        started[name] = (run_dir, _start_ranks(
            MESH_CLI_SCRIPT, lambda r, args=args: args, 2, run_dir, env))
    return started, time.perf_counter()


def check_uneven_cli(dev, card, started):
    """(c) join `start_uneven_cli`'s runs: every rank prints the 2-D
    banner and the same epoch lines; at 608 K1's launches rise on every
    rank and K2's equal the gated convs, rank 0's checkpoint (its head)
    serves one request through K1; the --multi-scale run names its
    buckets and trains each; the dense run exits 1 on both ranks with the
    corrected line before training. Returns (K1, K2) launches summed
    over the ranks and the requests."""
    runs, t0 = started
    k1_total = k2_total = 0
    banner = "2-D mesh: data=1 x space=2 over 2 process(es)"
    for name, (run_dir, procs) in runs.items():
        what = f"phase 25 (c) {name}"
        if name == "dense":
            outs = []
            for p in procs:
                out, err = p.communicate(timeout=SP_JOIN_S)
                outs.append(out)
                if p.returncode != 1:
                    raise AssertionError(f"{what}: exit {p.returncode}, not "
                                         f"1:\n{out[-2000:]}\n{err[-2000:]}")
            line = (f"ERROR: --spatial 2 needs the P5 grid (img_size / 32 = "
                    f"{UN_CLI_IMG // 32} rows at {UN_CLI_IMG}) to divide by 2 "
                    f"with dense targets")
            if any(line not in out or "Training YOLO model" in out
                   or "pads" in out for out in outs):
                raise AssertionError(f"{what}: not refused as JAX is:\n"
                                     f"{outs[0][-2000:]}")
            log(f"{what}: --img-size {UN_CLI_IMG} without --compact-targets "
                f"exits 1 on both ranks before training: "
                f"{next(ln for ln in outs[0].splitlines() if ln.startswith('ERROR'))}")
            continue
        outs = _join_ranks(procs, what)
        wall = time.perf_counter() - t0
        epochs, launches = [], []
        for r, out in enumerate(outs):
            lines = re.findall(r"Epoch \d+: .* \| LR: ", out)
            counts = re.search(r"LAUNCHES K1 (\d+) K2 (\d+)", out)
            if not lines or not counts or banner not in out.splitlines():
                raise AssertionError(f"{what} rank {r}:\n{out[-3000:]}")
            epochs.append(lines)
            launches.append((int(counts.group(1)), int(counts.group(2))))
        if len({tuple(e) for e in epochs}) != 1:
            raise AssertionError(f"{what}: the ranks' epoch lines differ")
        if name == "multi_scale":
            sizes = cli.multi_scale_sizes(UN_MS_IMG)
            rows = [s // 32 for s in sizes]
            if (f"Multi-scale buckets: {sizes} (epoch-rotated)" not in outs[0]
                    or len(epochs[0]) != 3):
                raise AssertionError(f"{what}: buckets or epochs:\n"
                                     f"{outs[0][-3000:]}")
            log(f"{what} CLI --distributed --spatial 2 --compact-targets "
                f"--multi-scale @{UN_MS_IMG} over 2 processes on one card "
                f"({card}): buckets {sizes} (P5 rows {rows}, a rank "
                f"{[_p5_split(r) for r in rows]}), one "
                f"bf16 step each, done {wall:.1f} s after the runs' start; "
                f"epoch lines equal on both ranks: {epochs[0]}; (K1, K2) "
                f"launches a rank {launches}")
            k2_total += sum(k2 for _, k2 in launches)
            continue
        cfg = YoloConfig.from_size("s", num_classes=AF_NC, img_size=UN_CLI_IMG,
                                   compute_dtype="bfloat16", head_type=name)
        want_k2 = (sum(_gated_convs(cfg).values()) * TRAIN_STEPS
                   * conv_bwd.LAUNCHES_PER_CALL)
        ckpt = sorted(run_dir.glob("yolo_*.ckpt"))
        if len(ckpt) != 1:
            raise AssertionError(f"{what}: checkpoints {ckpt}")
        sd, ckpt_cfg, _ = load_checkpoint(ckpt[0])
        img = np.random.default_rng(SEED).integers(
            0, 256, (UN_CLI_IMG, UN_CLI_IMG, 3), dtype=np.uint8)
        nms_cuda.launches = 0
        dets = Predictor(sd, ckpt_cfg, conf_threshold=1e-6, device=dev)(img)
        torch.cuda.synchronize()
        k1_request = nms_cuda.launches
        log(f"{what} CLI --distributed --spatial 2 --compact-targets "
            f"--img-size {UN_CLI_IMG} --val-det over 2 processes on one card "
            f"({card}), P5 rows a rank {_p5_split(UN_CLI_IMG // 32)}, 1 bf16 "
            f"epoch of {TRAIN_STEPS} steps, K2 on: done {wall:.1f} s after "
            f"the runs' start; epoch lines equal on both ranks "
            f"({epochs[0][0][:60]}...); (K1, K2) launches a rank {launches} "
            f"(K2 want {want_k2}); rank 0's checkpoint "
            f"({ckpt_cfg.head_type}) served {len(dets)} detections, K1 "
            f"launched {k1_request} times")
        if (" | Det: P " not in epochs[0][0] or ckpt_cfg.head_type != name
                or any(k1 < 1 or k2 != want_k2 for k1, k2 in launches)
                or not dets or k1_request < 1):
            raise AssertionError(f"{what}: a kernel's launches, the "
                                 f"checkpoint or the request")
        k1_total += sum(k1 for k1, _ in launches) + k1_request
        k2_total += sum(k2 for _, k2 in launches)
    return k1_total, k2_total


def _p5_split(grid):
    from yolo_from_scratch_tpu_torch.parallel.mesh import row_split

    return row_split(grid, 2)


def phase_tooling(dev, workdir, yaml_path, card, rates, stream_rates):
    """(d) the model roofline (`utils/roofline.py::summarize`) of the
    configurations phases 9 and 18 time, 's' @640 b8 bf16 (nc=1 and
    nc=80), with the MFU of their rates measured earlier in this run; then
    `utils/metrics_log.py::profiler_trace` around two training steps of
    phase 9's, K2 on: the trace file, its CUDA kernel events and K2's
    among them (the gated convs' launches). Returns K2's launches in the
    traced steps."""
    from yolo_from_scratch_tpu_torch.utils.metrics_log import profiler_trace

    measured = {
        (1, "phase 9 eager, K2 on"): statistics.mean(rates["1"]),
        (1, "phase 9 eager, K2 off"): statistics.mean(rates["0"]),
        **{(AF_NC, f"phase 18 {k}"): v for k, v in stream_rates.items()}}
    for nc in (1, AF_NC):
        cfg = YoloConfig.from_size("s", num_classes=nc, img_size=IMG_SIZE,
                                   compute_dtype="bfloat16")
        s = roofline.summarize(cfg, batch=8)
        mfu = {k: roofline.summarize(cfg, 8, v)["mfu"]
               for (c, k), v in measured.items() if c == nc}
        log(f"phase 25 (d) roofline 's' @{IMG_SIZE} nc={nc} b8 bf16 (H100 "
            f"data sheet {s['peak_flops'] / 1e12:.0f} TFLOP/s, "
            f"{roofline.H100_BYTES_PER_S / 1e12:.2f} TB/s; "
            f"{len(s['convs'])} convs): forward {s['fwd_flops'] / 1e9:.2f} "
            f"GFLOP, training-step floor {s['train_t_min_ms']:.4f} ms, "
            f"roofline {s['roofline_img_s']:.1f} img/s; MFU of this run's "
            f"rates: " + ", ".join(
                f"{k} {measured[(nc, k)]:.1f} img/s -> {v:.4%}"
                for k, v in mfu.items()) + f" ({card})")
    cfg = YoloConfig.from_size("s", num_classes=1, img_size=IMG_SIZE,
                               compute_dtype="bfloat16")
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    images, targets = _batch(yaml_path, "train", 8, dev)
    state = create_train_state(cfg, 1e-3, seed=SEED, device=dev)
    step = make_train_step(cfg, device=dev)
    step(state, images, targets)
    torch.cuda.synchronize()
    want = 2 * GATED_CONVS_BF16 * conv_bwd.LAUNCHES_PER_CALL
    for attempt in range(TRACE_ATTEMPTS):
        logdir = workdir / f"trace{attempt}"
        with profiler_trace(logdir):
            for _ in range(2):
                step(state, images, targets)
            torch.cuda.synchronize()
        path = logdir / "trace.json"
        events = json.loads(path.read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        k2 = sum("conv3x3_bwd" in e.get("name", "") for e in kernels)
        log(f"phase 25 (d) profiler_trace around 2 bf16 training steps, K2 "
            f"on ({card}): {path.name} {path.stat().st_size} bytes, "
            f"{len(events)} events, {len(kernels)} CUDA kernel events, K2's "
            f"{k2} (want {want}: {GATED_CONVS_BF16} gated convs x "
            f"{conv_bwd.LAUNCHES_PER_CALL} x 2 steps), attempt {attempt + 1}")
        if kernels and k2 == want:
            return k2
    raise AssertionError(f"phase 25 (d): no trace with K2's {want} "
                         f"launches in {TRACE_ATTEMPTS} attempts")


def _pk_cfg(head, layout=None, dtype="float32", nc=AF_NC):
    """'s' @IMG_SIZE, `layout` a key of PK_LAYOUTS or None (unpacked)."""
    return YoloConfig.from_size("s", num_classes=nc, img_size=IMG_SIZE,
                                compute_dtype=dtype, head_type=head,
                                **PK_LAYOUTS.get(layout, {}))


def _pk_pass(cfg, variables, x, dev):
    """cfg's model holding `variables`, float32 with TF32 off, on the NHWC
    batch x: (eval outputs, train-mode outputs, the BatchNorm statistics
    the train-mode pass moved, the gradients of sum(mean(out^2)))."""
    model = YOLO(cfg)
    model.load_state_dict(from_flax_variables(variables, model))
    model.to(dev)
    with tf32_disabled():
        with torch.no_grad():
            evals = [o.clone() for o in model(x, train=False)]
        outs = model(x, train=True)
        sum(o.square().mean() for o in outs).backward()
    torch.cuda.synchronize()
    return (evals, [o.detach() for o in outs],
            {k: b.detach().clone() for k, b in model.named_buffers()},
            {k: p.grad for k, p in model.named_parameters()})


def _pk_bf16(cfg, batches, dev, contiguous=False):
    """cfg's bf16 model from the seed's fresh weights (K2 on) on the pixel
    batches, packed on the card for a packed cfg: (the train-mode loss of
    each batch, K2's launches in one train step on the first batch, from
    the profiler). `contiguous`: the images in NCHW-contiguous memory
    instead of NHWC (the same math; cuDNN takes other kernels)."""
    state = create_train_state(cfg, 1e-3, seed=SEED, device=dev)

    def layout(images):
        x = pack_s2d(images) if cfg.packed_stem else images
        if contiguous:
            x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        return x

    loss_fn = make_loss_fn(cfg, device=dev)
    with torch.no_grad():
        losses = [loss_fn(state.model, layout(images), targets)[0].item()
                  for images, targets in batches]
    step = make_train_step(cfg, device=dev)
    counts = _launch_counts(lambda: step(state, layout(batches[0][0]),
                                         batches[0][1]))
    return np.array(losses), sum(n for k, (n, _) in counts.items()
                                 if "conv3x3_bwd" in k)


def _pk_batches(yaml_path, head, dev):
    """Phase 18's 64 train images (nc=80) as 8 batches of 8 with the
    head's dense targets, on the card."""
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    ds = YoloDataset(load_dataset_yaml(yaml_path)["train"], AF_NC,
                     YoloConfig().anchors_array, IMG_SIZE, head_type=head)
    out = []
    for i in range(0, STREAM_TRAIN, 8):
        images, targets = ds.load_batch(range(i, i + 8))
        out.append((torch.from_numpy(images).to(dev),
                    [torch.from_numpy(t).to(dev) for t in targets]))
    return out


def _pk_graph(dev, cache):
    """Phase 18's anchor recipe (sparse loss, device mosaic and augment)
    under packing p3: a graphed chunk of STREAM_N steps on the packed
    chunk against STREAM_N eager steps, bit for bit, deterministic."""
    from yolo_from_scratch_tpu_torch.train.steps import (
        make_train_step_multi_compact,
    )

    head, flags, wd, _ = STREAM_RECIPES[0]
    cfg = _stream_cfg(head).with_(**PK_LAYOUTS["p3"])
    chunk = _chunk(cache, STREAM_N, 0, dev)
    chunk[0] = pack_s2d(chunk[0])
    with _deterministic():
        eager = create_train_state(cfg, 1e-3, seed=SEED, device=dev,
                                   weight_decay=wd)
        step = make_train_step(cfg, device=dev, compact_targets=True,
                               augment_seed=SEED, **flags)
        for i in range(STREAM_N):
            eager, _ = step(eager, chunk[0][i], (chunk[1][i], chunk[2][i]))
        want = _state_tensors(eager)
        del eager, step
        state = create_train_state(cfg, 1e-3, seed=SEED, device=dev,
                                   weight_decay=wd)
        state, _ = make_train_step_multi_compact(
            cfg, device=dev, augment_seed=SEED, **flags)(state, *chunk)
        got = _state_tensors(state)
    torch.cuda.synchronize()
    diff = _differ("packed graph vs eager", got, want)
    log(f"phase 26 (a) packed p3 {head} ({' '.join(STREAM_FLAGS[head])}): "
        f"a graphed chunk of {STREAM_N} vs {STREAM_N} eager steps (packed "
        f"chunk {tuple(chunk[0].shape)}): {len(got) - len(diff)} / "
        f"{len(got)} state tensors bit-equal")
    if diff:
        raise AssertionError(f"packed graphed chunk differs from the eager "
                             f"steps: {sorted(diff.items())[:8]}")


def phase_packed_parity(dev, stream_yaml, cache, card):
    """(a) packed against unpacked on the card: float32 outputs, BatchNorm
    statistics and gradients, each layout, both heads; bf16 losses over
    phase 18's 64 images and K2's launches in a step; the packed graphed
    chunk against eager steps. Returns the K2 launches of the packed bf16
    steps."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 80)
    x = rng.random((PK_BATCH, IMG_SIZE, IMG_SIZE, 3)).astype(np.float32)
    xs = (torch.from_numpy(x).to(dev),
          torch.from_numpy(pack_s2d_host(x)).to(dev))
    for head in ("anchor", "anchor_free"):
        base = _pk_cfg(head)
        variables = random_variables(YOLO(base, device="meta"), seed=SEED)
        ref = _pk_pass(base, variables, xs[0], dev)
        for layout in PK_LAYOUTS:
            got = _pk_pass(_pk_cfg(head, layout), variables, xs[1], dev)
            ev, tr = (_worst(dict(enumerate(got[i])),
                             dict(enumerate(ref[i])))[0] for i in (0, 1))
            bn, gr = _worst(got[2], ref[2]), _worst(got[3], ref[3])
            log(f"phase 26 (a) {head} {layout} vs unpacked, float32 TF32 "
                f"off, b{PK_BATCH}: eval outputs {ev:.2e}, train outputs "
                f"{tr:.2e} of max (tol {PK_OUT_TOL}); BatchNorm statistics "
                f"{bn[0]:.2e} ({bn[1]}; tol {PK_BN_TOL}); gradients "
                f"{gr[0]:.2e} of the tensor's max ({gr[1]}; tol "
                f"{PK_GRAD_TOL})")
            if (ev > PK_OUT_TOL or tr > PK_OUT_TOL or bn[0] > PK_BN_TOL
                    or gr[0] > PK_GRAD_TOL):
                raise AssertionError(f"{head} {layout}: packed differs from "
                                     f"unpacked on the card")
        del ref, got
    torch.cuda.empty_cache()

    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    k2_packed = 0
    for head in ("anchor", "anchor_free"):
        batches = _pk_batches(stream_yaml, head, dev)
        base = _pk_cfg(head, dtype="bfloat16")
        ref, k2 = _pk_bf16(base, batches, dev)
        floor = _pk_bf16(base, batches, dev, contiguous=True)[0]
        row = [f"unpacked {ref.mean():.5f} (K2 {k2}); the noise floor, "
               f"unpacked on NCHW-contiguous images: "
               f"{abs(floor.mean() - ref.mean()) / ref.mean():.2e} "
               f"(a batch up to {(np.abs(floor - ref) / ref).max():.2e})"]
        want = PK_K2[head]
        bad = k2 != want[0]
        for layout in PK_LAYOUTS:
            cfg = _pk_cfg(head, layout, "bfloat16")
            got, k2 = _pk_bf16(cfg, batches, dev)
            rel = abs(got.mean() - ref.mean()) / ref.mean()
            k2_want = want[0] if layout == "stem" else want[1]
            row.append(f"{layout} {got.mean():.5f} ({rel:.2e} relative, a "
                       f"batch up to {(np.abs(got - ref) / ref).max():.2e}; "
                       f"K2 {k2})")
            bad |= (rel > PK_BF16_LOSS_RTOL or k2 != k2_want
                    or k2 != _k2_per_step(cfg))
            k2_packed += k2
        log(f"phase 26 (a) {head} bf16, K2 on: the mean train-mode loss "
            f"over {len(batches)} batches of 8: " + ", ".join(row)
            + f" (tol {PK_BF16_LOSS_RTOL} relative; K2 launches in a "
            f"step from the profiler, want {want[0]} unpacked and stem, "
            f"{want[1]} interior and p3)")
        if bad:
            raise AssertionError(f"{head}: packed bf16 differs")
    _pk_graph(dev, cache)
    log(f"phase 26 (a) took {time.perf_counter() - t0:.1f} s ({card})")
    return k2_packed


def phase_packed_cli(dev, workdir, yaml_path, af_yaml, stream_yaml, card):
    """(c) the CLI under packing: --packed p3 training with --val-det, both
    heads, and a request from each checkpoint; --packed p3 --stream from
    a packed cache; --packed stem --data-parallel at a world of one (the
    compositions with --int8, --export and the meshes run in phase 27
    (f)). Returns (K1 launches, K2 launches)."""
    t0 = time.perf_counter()
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    size = ["--size", "s", "--img-size", str(IMG_SIZE), "--batch-size", "8"]
    k1 = k2 = 0
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        ckpts = {}
        for head, y, nc in (("anchor", yaml_path, 1),
                            ("anchor_free", af_yaml, AF_NC)):
            want = (_k2_per_step(_pk_cfg(head, "p3", "bfloat16", nc))
                    * TRAIN_STEPS)
            conv_bwd.launches = nms_cuda.launches = 0
            rc, out = _cli([str(y), *size, "--epochs", "1", "--head", head,
                            "--packed", "p3", "--val-det"])
            launches = (nms_cuda.launches, conv_bwd.launches)
            epoch = EPOCH_LINE.search(out)
            if (rc != 0 or not epoch or " | Det: P " not in epoch.group(0)
                    or launches[0] < 1 or launches[1] != want):
                raise AssertionError(f"--packed p3 {head} training: rc {rc}, "
                                     f"launches (K1, K2) {launches}, want K2 "
                                     f"{want}, output:\n{out}")
            ckpts[head] = workdir / _saved(out, f"--packed p3 {head}")
            image = sorted((Path(y).parent / "val" / "images").glob(
                "*.jpg"))[0]
            nms_cuda.launches = 0
            rc, req = _cli([str(image), str(ckpts[head]), "--packed", "p3"])
            if rc != 0 or nms_cuda.launches != 1:
                raise AssertionError(f"--packed p3 {head} request: rc {rc}, "
                                     f"{nms_cuda.launches} NMS launches")
            k1 += launches[0] + 1
            k2 += launches[1]
            log(f"phase 26 (c) --packed p3 --head {head} --val-det: exit 0, "
                f"{epoch.group(1)} img/s, K2 {launches[1]} (= "
                f"{want // TRAIN_STEPS} a step x {TRAIN_STEPS}), K1 "
                f"{launches[0]}; its checkpoint served one request through "
                f"K1 ({card})")

        conv_bwd.launches = nms_cuda.launches = 0
        rc, out = _cli([str(stream_yaml), *size, "--epochs", "1", "--packed",
                        "p3", "--stream", "--stream-chunk", str(STREAM_N),
                        "--compact-targets", "--device-mosaic",
                        "--device-augment", "--sparse-loss"])
        cache = Path(cache_dir_for(str(Path(stream_yaml).parent / "train"
                                       / "images"), IMG_SIZE, COMPACT_K,
                                   packed=True))
        meta = (json.loads((cache / "meta.json").read_text())
                if (cache / "meta.json").exists() else {})
        if (rc != 0 or not meta.get("packed")
                or not EPOCH_LINE.search(out)):
            raise AssertionError(f"--packed p3 --stream: rc {rc}, cache "
                                 f"meta {meta}, output:\n{out}")
        k2 += conv_bwd.launches
        log(f"phase 26 (c) --packed p3 --stream: exit 0, "
            f"{EPOCH_LINE.search(out).group(1)} img/s, packed cache "
            f"{cache.name} {meta['image_shape']}, K2 {conv_bwd.launches} "
            f"wrapper calls (warm-up and capture) ({card})")

        conv_bwd.launches = 0
        rc, out = _cli([str(yaml_path), *size, "--epochs", "1",
                        "--packed-stem", "--data-parallel"])
        if rc != 0 or "Data-parallel mesh over 1 process(es)" not in out:
            raise AssertionError(f"--packed-stem --data-parallel: rc {rc}, "
                                 f"output:\n{out}")
        k2 += conv_bwd.launches
        log(f"phase 26 (c) --packed-stem --data-parallel (a world of one): "
            f"exit 0, K2 {conv_bwd.launches}")
    finally:
        os.chdir(cwd)
    log(f"phase 26 (c) took {time.perf_counter() - t0:.1f} s ({card})")
    return k1, k2


def phase_packed_times(dev, cache, card):
    """(d) packed p3 (and stem, interior where it differs) against
    unpacked on the card, 's' @640 nc=80 anchor head bf16, K2 on: the
    stem's and the forward's device ms at b8, an eager step's device and
    host-clock ms, the graphed chunk's img/s at N=4, a B=32
    BatchPredictor call's p50."""
    from yolo_from_scratch_tpu_torch.train.steps import (
        make_train_step_multi_compact,
    )

    t0 = time.perf_counter()
    os.environ["YOLO_FUSED_CONV_BWD"] = "1"
    head, flags, _, _ = STREAM_RECIPES[0]
    chunk = _chunk(cache, STREAM_N, 0, dev)
    images = chunk[0][0].float() * float(INV255)
    rows = {}
    layouts = (None, "stem", "interior", "p3")
    with torch.inference_mode():
        for layout in layouts:
            cfg = _stream_cfg(head).with_(**PK_LAYOUTS.get(layout, {}))
            model = cast_convs_(YOLO(cfg).reset_parameters(
                torch.Generator().manual_seed(SEED)).to(dev),
                torch.bfloat16).eval()
            x = pack_s2d(images) if layout else images
            xs = x.to(torch.bfloat16).permute(0, 3, 1, 2)
            rows[layout] = {
                "stem": device_ms(lambda: model.stem1(model.stem0(xs))),
                "forward": device_ms(lambda: model(x))}
            del model
    for layout in (None, "p3"):
        cfg = _stream_cfg(head).with_(**PK_LAYOUTS.get(layout, {}))
        state = create_train_state(cfg, 1e-3, seed=SEED, device=dev)
        step = make_train_step(cfg, device=dev, compact_targets=True,
                               augment_seed=SEED, **flags)
        ch = [pack_s2d(chunk[0]) if layout else chunk[0], *chunk[1:]]

        def one(i=0):
            step(state, ch[0][i], (ch[1][i], ch[2][i]))

        for _ in range(3):
            one()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(PK_TIMED):
            one(i % STREAM_N)
        torch.cuda.synchronize()
        rows[layout]["step"] = (time.perf_counter() - t1) / PK_TIMED * 1e3
        rows[layout]["step_busy"] = _busy_ms(one)
        trainer = make_train_step_multi_compact(cfg, device=dev,
                                                augment_seed=SEED, **flags)
        trainer(state, *ch)  # capture + one replay
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(PK_TIMED):
            trainer(state, *ch)
        torch.cuda.synchronize()
        rows[layout]["graph_img_s"] = (8 * STREAM_N * PK_TIMED
                                       / (time.perf_counter() - t1))
        sd = {k: v.detach().clone() for k, v in
              state.model.state_dict().items()}
        del trainer, step, state
        torch.cuda.empty_cache()
        predictor = BatchPredictor(sd, cfg, conf_threshold=CONF,
                                   iou_threshold=IOU, device=dev)
        rng = np.random.default_rng(SEED + 2)
        batch = [rng.integers(0, 256, (IMG_SIZE, IMG_SIZE, 3),
                              dtype=np.uint8) for _ in range(BATCH)]
        predictor(batch)
        torch.cuda.synchronize()
        lat = []
        for _ in range(PK_CALLS):
            t1 = time.perf_counter()
            predictor(batch)
            lat.append((time.perf_counter() - t1) * 1e3)
        rows[layout]["batch_p50"] = statistics.median(lat)
        del predictor
    for layout, r in rows.items():
        name = layout or "unpacked"
        more = ("" if "step" not in r else
                f"; eager step {r['step']:.2f} ms host clock ({PK_TIMED} "
                f"steps), {r['step_busy']:.2f} ms device (profiler); graphed "
                f"N={STREAM_N} {r['graph_img_s']:.1f} img/s ({PK_TIMED} "
                f"replays); B={BATCH} BatchPredictor p50 "
                f"{r['batch_p50']:.2f} ms ({PK_CALLS} calls, host clock)")
        log(f"phase 26 (d) {name}, 's' @{IMG_SIZE} nc={AF_NC} b8 bf16 "
            f"K2 on: stem {r['stem']:.4f} ms, forward {r['forward']:.4f} ms "
            f"device (profiler, eval){more}; {card}")
    log(f"phase 26 (d) took {time.perf_counter() - t0:.1f} s ({card})")
    return rows

# ------------------------------------------------------------- phase 27


def _packed_q2_shapes():
    """{(k, s, pad, cin, cout, h, w): [layouts]} of the packed 2x2 convs
    padded (1, 0) that Q2 runs at 's' @IMG_SIZE nc=80 under each layout
    (stem0, float, left out), packed channels, from a forward on the meta
    device."""
    shapes = collections.defaultdict(list)
    for layout in PK_LAYOUTS:
        model = YOLO(_pk_cfg("anchor", layout, "bfloat16"), device="meta")

        def pre_hook(mod, args, layout=layout):
            cout, cin, kp, _ = mod._index.shape
            if kp == 2:
                key = (kp, mod.s_packed, mod.pad[0], cin, cout,
                       *args[0].shape[2:])
                shapes[key].append(layout)

        for name, module in model.named_modules():
            if hasattr(module, "repack") and name != "stem0":
                module.register_forward_pre_hook(pre_hook)
        with torch.no_grad():
            model(torch.empty((1, IMG_SIZE, IMG_SIZE, 3), device="meta"))
    return shapes


def phase_packed_q2(dev, card):
    """27 (a): Q2 at the packed 2x2 (1, 0) convs of each layout, B=1 and
    B=32: Q1 and Q2 bit-equal to their plain versions (int8, the int32
    accumulator, bf16 and float32), two runs of Q2 bit-equal, its
    geometry; device ms of Q1 and Q2 beside the bound, and at B=32 the
    bf16 F.conv2d of the layer and torch._int_mm on its im2col. Returns
    ({shape: timings}, the largest bf16 error, Q2's launches here)."""
    shapes = _packed_q2_shapes()
    if len(shapes) != PC_Q2_SHAPES or any(k != 2 or s != 1 or pad != 1 for
                                          k, s, pad, *_ in shapes):
        raise AssertionError(f"packed 2x2 int8 shapes {dict(shapes)}")
    lib = load_library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    quant.conv_launches = 0
    out, max_err = {}, 0.0
    for i, ((k, s, pad, cin, cout, h, w), layouts) in enumerate(
            sorted(shapes.items())):
        for b in (1, INT8_BATCH):
            geom = _q2_geometry(lib, b, k, s, cin, cout, h, w, sms)
            x, q = _q_case(b, k, s, cin, cout, h, w, dev, SEED + 270 + i)
            xq, wp, sc, bi, err, _, _ = _q_check(x, q, k, s, dev)
            max_err = max(max_err, err)
            runs = [torch.ops.yolo_torch.int8_conv(xq, wp, sc, bi, k, s,
                                                   True)
                    for _ in range(2)]
            if not torch.equal(*runs):
                raise AssertionError(f"Q2 at {(k, s, cin, cout, h, w)}: two "
                                     f"runs differ")
            inv = quant.input_inverse(q["a_scale"], torch.bfloat16)

            def kernels():
                torch.ops.yolo_torch.int8_conv(
                    torch.ops.yolo_torch.quant_input(x, inv), wp, sc, bi, k,
                    s, True)

            per = kernel_ms(kernels, TIMING_RUNS)
            q1 = sum(v for n, v in per.items() if "quant_input" in n) / \
                TIMING_RUNS
            q2 = sum(v for n, v in per.items() if "int8_conv" in n) / \
                TIMING_RUNS
            bound = roofline.bound_ms(*roofline.int8_conv_work(
                b, h, w, cin, cout, k, s, 2), "int8")
            row = dict(q1=q1, q2=q2, bound=bound[0], bound_by=bound[1])
            line = (f"phase 27 (a) packed 2x2 (1, 0) int8 conv {cin}->{cout} "
                    f"@{h}x{w} ({', '.join(layouts)}) B={b}: Q1 {q1:.4f} ms, "
                    f"Q2 {q2:.4f} ms (bound {bound[0]:.4f}, {bound[1]}, "
                    f"{bound[0] / q2:.0%}); N {geom.nt}"
                    f"{' split' if geom.split else ''}, tile {geom.tile_h}x"
                    f"{geom.tile_w}, chunk {geom.chunk}, {geom.stages} "
                    f"stages, grid {geom.grid}; bit-equal to the plain "
                    f"version, two runs bit-equal")
            if b == INT8_BATCH:
                xp = torch.nn.functional.pad(xq.permute(0, 3, 1, 2).float(),
                                             (pad, k - 1 - pad) * 2)
                cols = torch.nn.functional.unfold(xp, k)
                a_mat = cols.permute(0, 2, 1).reshape(
                    -1, cols.shape[1]).to(torch.int8).contiguous()
                del cols, xp
                b_mat = torch.zeros((cout, a_mat.shape[1]), dtype=torch.int8,
                                    device=dev)
                row["int_mm"] = sum(kernel_ms(
                    lambda: torch._int_mm(a_mat, b_mat.t()),
                    TIMING_RUNS).values()) / TIMING_RUNS
                del a_mat
                wf = torch.from_numpy(q["w_int8"]).permute(3, 2, 0, 1).to(
                    dev, torch.bfloat16).contiguous(
                        memory_format=torch.channels_last)
                # the layer's input padded once, outside the timed call
                xpad = torch.nn.functional.pad(x, (pad, k - 1 - pad) * 2)
                row["conv_bf16"] = sum(kernel_ms(
                    lambda: torch.nn.functional.conv2d(xpad, wf),
                    TIMING_RUNS).values()) / TIMING_RUNS
                del xpad
                row["q2_plain"] = median_ms(lambda: quant.int8_conv_plain(
                    xq, wp, sc, bi, k, s, True), runs=3, warmup=1)
                line += (f"; yardsticks: bf16 F.conv2d {row['conv_bf16']:.4f}"
                         f" ms, torch._int_mm on the im2col "
                         f"{row['int_mm']:.4f} ms (profiler); plain Q2 "
                         f"{row['q2_plain']:.3f} ms (CUDA events)")
            out[(b, cin, cout, h, w)] = row
            log(line + f"; {card}")
            del x, xq
        torch.cuda.empty_cache()
    return out, max_err, quant.conv_launches


def _kernel_counts(fn):
    """(Q1, Q2, K1 mask passes) launched in one call of fn, from a trace
    that `utils/timing.py::kernel_trace` holds whole."""
    trace = kernel_trace(fn, 1)

    def n(name):
        return sum(c for k, (c, _) in trace.items() if name in k)

    return (n("quant_input_kernel"), n("int8_conv_tma_kernel"),
            n("nms_mask_pass"))


def phase_packed_int8(dev, ckpts, yaml_path, card):
    """27 (b): `--packed p3 --int8` serving of both heads on phase 17's
    checkpoints ('s' @640 nc=80 bf16): the CLI's request and one B=32
    int8 `BatchPredictor` call with the counts at 0 before them, the
    kernels of one call from the profiler; the raw outputs of the B=32
    batch bit-equal to the same model's with plain Q1 and Q2 on the card
    (each of them is bit-equal to its plain version, so a wrong repack,
    tiling or padding of a packed conv shows here even where the
    probabilities sit at a prior); the probabilities against the unpacked
    int8 path and the packed float path; request p50 and the B=32 call's
    card time beside the unpacked int8 path's. Returns {head: (Q1, Q2, K1)
    launches}."""
    from torch.utils._pytree import tree_leaves

    from yolo_from_scratch_tpu_torch.infer.quantize import set_plain
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    config = load_dataset_yaml(str(yaml_path))
    val_img = str(sorted(Path(config["val"]).glob("*.jpg"))[0])
    rng = np.random.default_rng(SEED + 27)
    images = [rng.integers(0, 256, (IMG_SIZE, IMG_SIZE, 3), dtype=np.uint8)
              for _ in range(INT8_BATCH)]
    counts = {}
    for head in ("anchor", "anchor_free"):
        state, cfg, _ = load_checkpoint(ckpts[head])
        cfg = cfg.with_(compute_dtype="bfloat16")
        pcfg = cfg.with_(**PK_LAYOUTS["p3"])
        calib = cli._train_calibration_images(config, cfg)
        n_quant = _int8_shapes(cfg)[1]
        conf = CONF if head == "anchor" else AF_CKPT_CONF
        kw = dict(conf_threshold=conf, iou_threshold=IOU,
                  max_outputs=MAX_OUTPUTS, device=dev)
        quant.quant_launches = quant.conv_launches = nms_cuda.launches = 0
        rc, out = _cli([val_img, str(ckpts[head]), "--packed", "p3", "--int8",
                        "--dtype", "bfloat16"])
        if rc != 0 or "Running inference on" not in out:
            raise AssertionError(f"--packed p3 --int8 ({head}): rc {rc}:\n"
                                 f"{out}")
        qp = BatchPredictor(state, pcfg, quantize_calib=calib, **kw)
        results = qp(images)
        torch.cuda.synchronize()
        counts[head] = (quant.quant_launches, quant.conv_launches,
                        nms_cuda.launches)
        if counts[head] != (2 * n_quant, 2 * n_quant, 2):
            raise AssertionError(f"{head} packed int8 main path: (Q1, Q2, K1)"
                                 f" launches {counts[head]}, want "
                                 f"({2 * n_quant}, {2 * n_quant}, 2)")
        _finite_nonempty(results, f"{head} packed int8 batch image")
        prof = _kernel_counts(lambda: qp(images))
        if prof != (n_quant, n_quant, 1):
            raise AssertionError(f"{head} packed int8 B={INT8_BATCH} call: "
                                 f"profiler (Q1, Q2, K1) {prof}")
        args_p = qp.stage(images)
        with torch.no_grad():
            raw_k = tree_leaves(qp.model(args_p[0]))
            set_plain(qp.model, True)
            raw_p = tree_leaves(qp.model(args_p[0]))
            set_plain(qp.model, False)
        if len(raw_k) != len(raw_p) or not all(
                torch.equal(a, b) for a, b in zip(raw_k, raw_p)):
            raise AssertionError(f"{head} packed int8: the raw outputs differ "
                                 f"from plain Q1 / Q2's on the card")
        spread = [(t.float().max() - t.float().min()).item() for t in raw_k]
        qu = BatchPredictor(state, cfg, quantize_calib=calib, **kw)
        fp = BatchPredictor(state, pcfg, **kw)
        args_u = qu.stage(images)
        _, obj_q, cls_q, _ = qp.postprocess.decode(*args_p)
        _, obj_u, cls_u, _ = qu.postprocess.decode(*args_u)
        _, obj_f, cls_f, _ = fp.postprocess.decode(*args_p)
        err_u = max((obj_q - obj_u).abs().max().item(),
                    (cls_q - cls_u).abs().max().item())
        err_f = max((obj_q - obj_f).abs().max().item(),
                    (cls_q - cls_f).abs().max().item())
        if max(err_u, err_f) > INT8_PROB_TOL:
            raise AssertionError(f"{head} packed int8: probabilities differ "
                                 f"from unpacked int8 by {err_u}, from "
                                 f"packed float by {err_f}")
        times = {}
        for name, c, bp in (("packed p3 int8", pcfg, qp),
                            ("unpacked int8", cfg, qu)):
            single = Predictor(state, c, quantize_calib=[val_img], **kw)
            single(val_img)
            lat = []
            for _ in range(PC_REQUESTS):
                t0 = time.perf_counter()
                single(val_img)
                lat.append((time.perf_counter() - t0) * 1e3)
            times[name] = (statistics.median(lat),
                           _busy_ms(lambda: single(val_img)),
                           _busy_ms(lambda: bp(images)))
            del single
        log(f"phase 27 (b) {head} --packed p3 --int8: the CLI's request "
            f"({out.strip().splitlines()[-1].strip()}) and one B="
            f"{INT8_BATCH} call launched (Q1, Q2, K1) {counts[head]} times "
            f"({n_quant} quantized convs a forward); one B={INT8_BATCH} call "
            f"in the profiler (Q1, Q2, K1 mask pass) {prof}; the raw "
            f"outputs ({len(raw_k)} tensors, {sum(t.numel() for t in raw_k)} "
            f"values spanning {min(spread):.3g}-{max(spread):.3g} a tensor) "
            f"bit-equal to plain Q1 / Q2's on the card; probabilities "
            f"vs unpacked int8 {err_u:.3e}, vs packed float {err_f:.3e} over "
            f"{obj_q.numel()} predictions (tol {INT8_PROB_TOL}); "
            + "; ".join(f"{n}: request p50 {t[0]:.3f} ms (host clock, "
                        f"{PC_REQUESTS} requests), card {t[1]:.3f} ms; B="
                        f"{INT8_BATCH} call card {t[2]:.3f} ms (profiler)"
                        for n, t in times.items()) + f"; {card}")
        del qp, qu, fp
        torch.cuda.empty_cache()
    return counts


def _pc_runs(yaml_path):
    """27 (d), (e): the dense anchor head's step on phase 22's first batch
    of SP_BATCH images, host-packed, under packing p3: float32, and bf16
    with K2 on; the seeded weights."""
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    cfg = _pk_cfg("anchor", "p3")
    ds = YoloDataset(load_dataset_yaml(yaml_path)["train"], AF_NC,
                     cfg.anchors_array, IMG_SIZE, backend="pil")
    images, targets = ds.load_batch(range(SP_BATCH))
    state = YOLO(cfg).reset_parameters(
        torch.Generator().manual_seed(SEED)).state_dict()
    runs = [dict(name=("anchor", dtype, 0), cfg=dict(
        num_classes=AF_NC, img_size=IMG_SIZE, width_mult=cfg.width_mult,
        depth_mult=cfg.depth_mult, head_type="anchor", compute_dtype=dtype,
        **PK_LAYOUTS["p3"]), images=pack_s2d_host(images), targets=targets,
        kw={}, fused=dtype == "bfloat16") for dtype in ("float32",
                                                         "bfloat16")]
    return runs, {"anchor": state}


def start_packed_mesh(workdir, yaml_path):
    """27 (d), (e), (f): start the packed p3 steps' ranks on the card
    (`--spatial` at 640 / 2 and 640 / 3, `--model-parallel 2`) and the
    CLI's two mesh compositions in two processes each, all at once."""
    runs, states = _pc_runs(yaml_path)
    started = {"runs": (runs, states), "t0": time.perf_counter()}
    for n, _ in PC_SPACE:
        started[("space", n)] = _start_mesh_ranks(
            "space", n, runs, states, workdir, f"_pc{n}", UN_ENV)
    tp_runs = [dict(r, fused=True) for r in runs]
    started["tp_runs"] = tp_runs
    started[("model", TP_MODEL)] = _start_mesh_ranks(
        "model", TP_MODEL, tp_runs, states, workdir, "_pc", UN_ENV)
    repo = str(Path(__file__).resolve().parent)
    env = dict(UN_ENV, YOLO_FUSED_CONV_BWD="1", PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    for name, flags in PC_CLI_MESH.items():
        run_dir = workdir / f"pc_cli_{name}"
        run_dir.mkdir()
        args = [str(yaml_path), "--size", "s", "--epochs", "1",
                "--batch-size", "8", "--data-parallel", *flags]
        started[name] = (run_dir, _start_ranks(
            MESH_CLI_SCRIPT, lambda r, args=args: args, 2, run_dir, env))
    return started


def check_packed_spatial(dev, workdir, card, started):
    """27 (d): join the `--spatial` ranks: float32 against one process at
    phase 22's tolerances at 640 / 2 and phase 25's at 640 / 3 (unequal
    blocks), the ranks' weights bit for bit; bf16 with K2 on: K2's
    launches a rank held to the gated convs (the packed C3a convs on their
    haloed tiles). Returns K2's launches summed over the ranks."""
    runs, states = started["runs"]
    run32, run16 = runs
    conv_bwd.launches = 0
    loss, grads, state, _ = _single_step(dev, run32, states["anchor"])
    cfg16 = YoloConfig(**run16["cfg"])
    gated = sum(_gated_convs(cfg16).values())
    want = gated * conv_bwd.LAUNCHES_PER_CALL
    k2 = 0
    for n, img in PC_SPACE:
        what = f"phase 27 (d) packed p3 --spatial {n}"
        ranks, rank_s = _join_mesh_ranks("space", n, started[("space", n)],
                                         workdir, what, f"_pc{n}")
        got = [r[run32["name"]] for r in ranks]
        total = sum(r["metrics"]["loss"] for r in got)
        rel = abs(total - loss) / abs(loss)
        tol = SP_LOSS_RTOL["anchor"] if IMG_SIZE // 32 % n == 0 else \
            UN_LOSS_RTOL
        worst = _worst(got[0]["grads"], grads)
        bn = _bn_worst(got[0]["state"], state)
        across = [k for r in got[1:] for k in _ranks_differ(got[0]["state"],
                                                             r["state"])]
        bf16 = [r[run16["name"]] for r in ranks]
        log(f"{what} @{img} (P5 rows {_rows_of(img, n)}), {n} gloo ranks on "
            f"one card ({rank_s:.1f} s with start-up), float32 TF32 off, a "
            f"global batch of {SP_BATCH} vs one process: loss {total:.7f} vs "
            f"{loss:.7f} ({rel:.2e} relative, tol {tol}); worst gradient "
            f"{worst[0]:.2e} of its max ({worst[1]}; tol {PARITY_GRAD_TOL}); "
            f"BatchNorm statistics {bn[0]:.2e} ({bn[1]}; tol {SP_BN_TOL}); "
            f"state tensors differing between the ranks: {len(across)}; bf16 "
            f"K2 on: K2 launches a rank {[r['k2'] for r in bf16]} (want "
            f"{gated} gated convs x {conv_bwd.LAUNCHES_PER_CALL}), losses "
            f"{[round(r['metrics']['loss'], 6) for r in bf16]}; {card}")
        if (rel > tol or worst[0] > PARITY_GRAD_TOL or bn[0] > SP_BN_TOL
                or across or any(r["k2"] != want for r in bf16)):
            raise AssertionError(f"{what}: the packed spatial step differs "
                                 f"from one process's, or K2's launches")
        k2 += sum(r["k2"] for r in bf16)
    return k2


def _rows_of(img, n):
    """The P5 rows of each rank of `--spatial n` at image size img."""
    g = img // 32
    return "/".join(str(g // n + (s < g % n)) for s in range(n))


def check_packed_tp(dev, workdir, card, started):
    """27 (e): join the `--model-parallel 2` ranks: float32 (K2 on)
    against one process at phase 23's tolerances, the gathered and the
    replicated leaves equal on both ranks, K2's launches (the packed C3a
    convs, replicated, at their global shapes) a rank as one process's;
    the parameters and Adam moments a rank holds. Returns K2's launches
    summed over the ranks."""
    runs, states = started["tp_runs"], started["runs"][1]
    run32 = runs[0]
    conv_bwd.launches = 0
    loss, grads, state, _ = _single_step(dev, run32, states["anchor"])
    single_k2 = conv_bwd.launches
    what = "phase 27 (e) packed p3 --model-parallel 2"
    ranks, rank_s = _join_mesh_ranks("model", TP_MODEL,
                                     started[("model", TP_MODEL)], workdir,
                                     what, "_pc")
    got = [r[run32["name"]] for r in ranks]
    rel = abs(got[0]["metrics"]["loss"] - loss) / abs(loss)
    worst = _worst(got[0]["grads"], grads)
    bn = _bn_worst(got[0]["state"], state)
    across = _ranks_differ(got[0]["state"], got[1]["state"])
    replicated = [k for k in _ranks_differ(got[0]["local"], got[1]["local"])
                  if k not in got[0]["keys"]]
    full_bytes = 3 * 4 * sum(p.numel() for p in YOLO(
        YoloConfig(**run32["cfg"]), device="meta").parameters())
    shares = [r["held_bytes"] / full_bytes for r in got]
    shapes = {s for r in got for s in r["k2_shapes"]}
    bf16 = [r[runs[1]["name"]] for r in ranks]
    # bf16: the gated convs (the packed C3a convs, replicated, among them);
    # float32 takes the 40x40 ones only (the gate's float32 bound)
    want16 = (sum(_gated_convs(YoloConfig(**runs[1]["cfg"])).values())
              * conv_bwd.LAUNCHES_PER_CALL)
    log(f"{what}, 1 x {TP_MODEL} on one card ({rank_s:.1f} s with start-up),"
        f" float32 TF32 off K2 on vs one process: loss "
        f"{got[0]['metrics']['loss']:.7f} vs {loss:.7f} ({rel:.2e} relative, "
        f"tol {PARITY_LOSS_TOL}); worst gathered gradient {worst[0]:.2e} "
        f"({worst[1]}; tol {PARITY_GRAD_TOL}); BatchNorm statistics "
        f"{bn[0]:.2e} ({bn[1]}; tol {SP_BN_TOL}); gathered state tensors "
        f"differing between the ranks {len(across)}, replicated ones "
        f"{len(replicated)}; K2 launches a rank {[r['k2'] for r in got]} "
        f"(one process {single_k2}) at (x, dy, w) {sorted(shapes)}; bf16 "
        f"K2 {[r['k2'] for r in bf16]} (want {want16}), losses "
        f"{[round(r['metrics']['loss'], 6) for r in bf16]}; parameters + "
        f"Adam moments a rank holds {', '.join(f'{x:.4f}x' for x in shares)}"
        f" of one process's (at most {TP_MEMORY_SHARE}x); {card}")
    if (rel > PARITY_LOSS_TOL or worst[0] > PARITY_GRAD_TOL
            or bn[0] > SP_BN_TOL or across or replicated
            or any(r["k2"] != single_k2 for r in got)
            or any(r["k2"] != want16 for r in bf16)
            or max(shares) > TP_MEMORY_SHARE
            or any(w != (64, 64, 3, 3) for _, _, w in shapes)):
        raise AssertionError(f"{what}: the packed model-parallel step "
                             f"differs from one process's")
    return sum(r["k2"] for r in got + bf16)


def phase_packed_comp_cli(dev, workdir, yaml_path, ckpts, card, started):
    """27 (f): the four compositions through the CLI, each exit 0: the
    `--packed p3 --int8` request ran in (b); `--packed-stem --export` of a
    served checkpoint, the artifact serving one image through the CLI;
    `--packed-interior --data-parallel --model-parallel 2` and `--packed
    stem --data-parallel --spatial 2`, two processes on the card each:
    their banners and one epoch line, the same on both ranks. Returns
    (K1, K2) launches."""
    ckpt = _served_checkpoint(ckpts["anchor"], "anchor",
                              workdir / "pc_served.ckpt")
    art = workdir / "pc_stem.yexp"
    rc, out = _cli([str(ckpt), "--packed-stem", "--export", str(art),
                    "--dtype", "bfloat16"])
    if rc != 0 or not out.strip().splitlines()[-2].startswith("Exported"):
        raise AssertionError(f"--packed-stem --export: rc {rc}:\n{out}")
    from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

    image = str(sorted(Path(load_dataset_yaml(str(yaml_path))["val"]).glob(
        "*.jpg"))[0])
    nms_cuda.launches = 0
    rc, served = _cli([image, str(art)])
    k1 = nms_cuda.launches
    if rc != 0 or "Serving artifact" not in served or k1 != 1:
        raise AssertionError(f"the --packed-stem artifact: rc {rc}, K1 {k1}"
                             f":\n{served}")
    log(f"phase 27 (f) --packed-stem --export: exit 0, "
        f"{out.strip().splitlines()[-1].strip()}; served one image through "
        f"the CLI (K1 {k1}): {served.strip().splitlines()[-1]}")
    k2 = 0
    for name, flags in PC_CLI_MESH.items():
        run_dir, procs = started[name]
        outs = _join_ranks(procs, f"phase 27 (f) {name}")
        banner = ("model=2" if "--model-parallel" in flags else "space=2")
        epochs = [EPOCH_LINE.search(o) for o in outs]
        if not all(epochs) or any(banner not in o for o in outs) or len(
                {e.group(0).rsplit("|", 1)[0] for e in epochs}) != 1:
            raise AssertionError(f"phase 27 (f) {' '.join(flags)}: outputs:"
                                 f"\n{outs[0][-2000:]}\n{outs[1][-2000:]}")
        for o in outs:
            m = re.search(r"LAUNCHES K1 (\d+) K2 (\d+)", o)
            k1, k2 = k1 + int(m.group(1)), k2 + int(m.group(2))
        log(f"phase 27 (f) {' '.join(flags)} --data-parallel in two "
            f"processes: exit 0 on both, the 2-D mesh banner, the same "
            f"epoch line ({epochs[0].group(0)[:60]}...); {card}")
    return k1, k2


def phase_packed_compositions(dev, workdir, yaml_path, ckpts, card):
    """27: (a), (b), K2 at (d)'s packed haloed tiles and (c)'s exports,
    timed with the card to itself; then the rest of (c)-(f), which time
    nothing: (c)'s artifacts served beside the mesh ranks and CLI runs of
    (d)-(f). Returns what the kernels' record takes."""
    t0 = time.perf_counter()
    q2_rows, q2_err, q2_cmp = phase_packed_q2(dev, card)
    int8_counts = phase_packed_int8(dev, ckpts, yaml_path, card)
    k2_err, k2_times = phase_mesh_k2(dev, card, PC_K2_CASES, SEED + 90,
                                     "phase 27 (d) K2 at the packed C3a "
                                     "conv's haloed tile")
    (workdir / "exp").mkdir()
    exports = start_export(ckpts, yaml_path, workdir / "exp", layout="p3",
                           heads=("anchor",))
    started = start_packed_mesh(workdir, yaml_path)
    art_counts = check_export(dev, exports)
    sp_k2 = check_packed_spatial(dev, workdir, card, started)
    tp_k2 = check_packed_tp(dev, workdir, card, started)
    cli_k1, cli_k2 = phase_packed_comp_cli(dev, workdir, yaml_path, ckpts,
                                           card, started)
    log(f"phase 27 took {time.perf_counter() - t0:.1f} s ({card})")
    return dict(q2_rows=q2_rows, q2_err=q2_err, q2_cmp=q2_cmp,
                int8=int8_counts, artifacts=art_counts, sp_k2=sp_k2,
                tp_k2=tp_k2, cli_k1=cli_k1, cli_k2=cli_k2, k2_err=k2_err,
                k2_times=k2_times)


def _span_ms(fn, names, runs=5):
    """Mean host-clock ms a call inside each span of `names` over `runs`
    calls of fn, after one (the spans' counters)."""
    fn()
    torch.cuda.synchronize()
    before = metrics_log.counters()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    after = metrics_log.counters()
    return [(after[n]["ns"] - before[n]["ns"]) / 1e6
            / (after[n]["calls"] - before[n]["calls"]) for n in names]


def _host_ms(fn, runs=5):
    """Median host-clock ms of `runs` calls of fn, after one."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_letterbox_kernel(dev):
    """28: L1 (`csrc/letterbox.cu`) against PIL (`letterbox_image`) and its
    plain version on the card, bit for bit, at L1_GRID in one batch, in
    the pixel and the packed layout, with its launch and resample counts;
    then at B=32 on each of L1_TIMED: L1's device ms (profiler) beside its
    bound (the frames' bytes read once and the output written once at
    3.35 TB/s), the plain version's ms on the card (CUDA events), the
    host's staging and upload ms (host clock, the spans' means) and the
    host PIL path it replaced (`letterbox_input` and `np.stack`). Returns
    {name: timings}."""
    from PIL import Image

    rng = np.random.default_rng(SEED)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for w, h in L1_GRID]
    staging = letterbox_cuda.Staging(dev)
    resized = sum(max(w, h) != IMG_SIZE for w, h in L1_GRID)
    for packed in (False, True):
        launches, resampled = (letterbox_cuda.launches,
                               letterbox_cuda.resampled)
        imgs, *params = staging.letterbox(frames, IMG_SIZE, packed)
        torch.cuda.synchronize()
        if (letterbox_cuda.launches != launches + 1
                or letterbox_cuda.resampled != resampled + resized):
            raise AssertionError("L1: a launch of the batch, its resized "
                                 "images counted")
        plain = letterbox_cuda.letterbox_plain(staging.buffer, len(frames),
                                               IMG_SIZE, packed)
        if not torch.equal(imgs, plain[0]) or not all(
                torch.equal(a, b) for a, b in zip(params, plain[1:])):
            raise AssertionError(f"L1 differs from its plain version on the "
                                 f"card (packed={packed})")
        for i, f in enumerate(frames):
            want = letterbox_image(Image.fromarray(f), IMG_SIZE)[0]
            want = pack_s2d_host(want) if packed else want
            got = imgs[i].cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"L1 differs from PIL at {L1_GRID[i]} (packed={packed}):"
                    f" {int((got != want).sum())} bytes")
    log(f"L1 == PIL == plain bit for bit at {len(L1_GRID)} sizes "
        f"{L1_GRID} in one batch, pixel and packed layouts; {resized} "
        f"resampled a launch")
    out = {}
    for name, shapes in L1_TIMED:
        batch = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                 for w, h in (shapes[i % len(shapes)]
                              for i in range(L1_BATCH))]
        pack_ms, upload_ms = _span_ms(
            lambda: staging.letterbox(batch, IMG_SIZE),
            ("serve.letterbox", "serve.upload"))
        used = metrics_log.counters()["serve.upload"]
        used = used["bytes"] // used["calls"]
        frame_bytes = sum(f.nbytes for f in batch)
        row = {"frame_bytes": frame_bytes, "staged_bytes": used,
               "pack_ms": pack_ms, "upload_ms": upload_ms,
               "upload_gb_s": used / upload_ms / 1e6,
               "pil_ms": _host_ms(lambda: np.stack(
                   [letterbox_input(f, IMG_SIZE)[0] for f in batch]),
                   runs=3)}
        for packed in (False, True):
            tag = "packed_" if packed else ""
            imgs = staging.letterbox(batch, IMG_SIZE, packed)[0]
            per = kernel_ms(lambda: staging.letterbox(batch, IMG_SIZE,
                                                      packed), TIMING_RUNS)
            ms = sum(v for k, v in per.items()
                     if any(e in k for e in LETTERBOX_ENTRIES)) / TIMING_RUNS
            bound = (frame_bytes + imgs.numel()) / 3.35e12 * 1e3
            row.update({f"{tag}ms": ms, f"{tag}bound_ms": bound,
                        f"{tag}share": bound / ms})
        row["plain_ms"] = median_ms(lambda: letterbox_cuda.letterbox_plain(
            staging.buffer, L1_BATCH, IMG_SIZE), runs=3, warmup=1)
        out[name] = row
        log(f"L1 B={L1_BATCH} {name}: {row['ms']:.4f} ms (bound "
            f"{row['bound_ms']:.4f}, bytes, {row['share']:.0%}), packed "
            f"{row['packed_ms']:.4f} ms ({row['packed_share']:.0%}); plain "
            f"{row['plain_ms']:.3f} ms (CUDA events); host staging "
            f"{pack_ms:.2f} ms for {frame_bytes / 1e6:.1f} MB of frames, "
            f"upload {upload_ms:.2f} ms ({row['upload_gb_s']:.1f} GB/s, "
            f"{used / 1e6:.1f} MB), the host PIL path it replaced "
            f"{row['pil_ms']:.1f} ms; {_smi('name,power.limit')}")
    return out


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
    checked = [e for e in spills if any(
        k in e for k in CONV_BWD_ENTRIES + NMS_ENTRIES + INT8_ENTRIES
        + LETTERBOX_ENTRIES)]
    log(f"ptxas: spill bytes (stores + loads) {spills or 'none'}")
    if checked:
        raise AssertionError(f"ptxas spilled in conv backward, NMS, int8 or "
                             f"letterbox kernels {checked} (log above)")
    log("ptxas: no spills in the conv backward kernels (K2-K5), the NMS "
        "kernel's two passes (K1), the int8 kernels (Q1, Q2) or the "
        "letterbox (L1)")
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
        batch_launches, batch_l1_launches, (batch_ms, batch_bound) = \
            phase_batch(state, cfg, dev)
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
        compact_k1, compact_k2, compact_ckpts = phase_compact_train(
            dev, Path(tmp), af_yaml)
        phase_compact_throughput(dev, af_yaml)
        log(f"compact path's kernel launches: NMS {compact_k1} (--val-det "
            f"both heads + --map), conv backward {compact_k2}")
        done(17)

        # 18. --stream: the cache, graphed chunks against eager steps,
        # capturable Adam, throughput, K2 in a replay, the CLI
        stream_yaml, cache = phase_stream_setup(Path(tmp))
        stream_k2 = phase_stream_graph(dev, cache)
        phase_stream_capturable(dev, cache)
        stream_rates = phase_stream_throughput(dev, cache)
        stream_k1, stream_k2_calls = phase_stream_cli(Path(tmp), stream_yaml)
        log(f"stream path's kernel launches: NMS {stream_k1} (--val-det, "
            f"both CLI runs); conv backward in one replay of {STREAM_N} "
            f"steps {stream_k2} (profiler), {stream_k2_calls} wrapper calls "
            f"at the CLI's warm-ups and captures")
        done(18)

        # 19. the trainer's recipe: --ema and --resume through the CLI, a
        # resume bit for bit, the knobs in a graph, --multi-scale,
        # --augment and accumulation, throughput
        ema_k2, ema_k1 = phase_ema_resume_cli(dev, Path(tmp), af_yaml)
        phase_resume_bitwise(dev, Path(tmp), af_yaml)
        recipe_k2 = phase_recipe_graph(dev, af_yaml)
        ms_k2, ms_err, ms_sizes = phase_multiscale(dev, Path(tmp), af_yaml)
        accum_k2 = phase_other_paths(dev, Path(tmp), af_yaml)
        phase_recipe_throughput(dev, af_yaml)
        log(f"recipe paths' kernel launches: NMS {ema_k1} (--ema --val-det "
            f"and a request); conv backward {ema_k2} (--ema, --resume), "
            f"{[ms_k2[s] for s in ms_sizes]} (--multi-scale buckets "
            f"{ms_sizes}), {accum_k2} (accumulation), {recipe_k2} (one "
            f"replay of the recipe graph, profiler)")
        done(19)

        # 20. int8 serving and the frozen serving artifacts, both heads, on
        # phase 17's checkpoints: Q1 and Q2 against their plain versions,
        # --int8 and a B=32 int8 call (the main path), --export float and
        # int8 served from fresh interpreters
        q_err, q_sums, _ = phase_int8_kernels(dev)
        int8_counts = phase_int8_serving(dev, compact_ckpts, af_yaml)
        artifact_counts = check_export(dev, start_export(
            compact_ckpts, af_yaml, Path(tmp)))
        log(f"int8 and artifact paths' kernel launches: (Q1, Q2, K1) "
            f"{int8_counts} (--int8 request + B={INT8_BATCH} call); in one "
            f"call of each artifact (profiler) {artifact_counts}")
        done(20)

        # 21. data parallelism: a world of one over NCCL through the CLI
        # bit for bit, two gloo ranks on the card against one process
        dp1 = phase_dp_world1(dev, Path(tmp), af_yaml)
        dp2 = phase_dp_two_ranks(dev, Path(tmp), af_yaml)
        log(f"data-parallel paths' kernel launches: NMS {dp1[0]} (world 1, "
            f"--val-det) + {dp2[0]} (two ranks, --val-det); conv backward "
            f"{dp1[1]} (world 1) + {dp2[1]} (two ranks, one step each)")
        done(21)

        # 22. spatial partitioning: two ranks' row blocks on the card
        # against one process, K2 on the haloed tiles, the CLI's
        # --spatial 2 in two and four processes
        card = _smi("name,power.limit")
        t22 = time.perf_counter()
        # (c)'s CLI runs beside (a)'s ranks; (b) times K2 once both are
        # joined
        cli22 = start_mesh_cli(Path(tmp), af_yaml, "space")
        sp_k2_step = phase_spatial_step(dev, Path(tmp), af_yaml, card)
        sp_k1, sp_k2_cli = check_mesh_cli(dev, card, cli22, "space",
                                          "phase 22 (c)")
        sp_err, sp_times = phase_mesh_k2(
            dev, card, SP_K2_CASES, SEED + 40,
            "phase 22 (b) K2 at the haloed tile")
        log(f"spatial paths' kernel launches: NMS {sp_k1} (--val-det, every "
            f"rank of the three CLI runs, and their checkpoints' requests); "
            f"conv backward {sp_k2_step} (one "
            f"bf16 step a rank, both heads) + {sp_k2_cli} (the CLI runs); "
            f"phase 22 took {time.perf_counter() - t22:.1f} s ({card})")
        done(22)

        # 23. model parallelism: two ranks' channel slices on the card
        # against one process, K2 at the global shapes, the memory a rank
        # holds, the CLI's --model-parallel 2 in two and four processes
        t23 = time.perf_counter()
        cli23 = start_mesh_cli(Path(tmp), af_yaml, "model")
        tp_k2_step = phase_tp_step(dev, Path(tmp), af_yaml, card)
        tp_k1, tp_k2_cli = check_mesh_cli(dev, card, cli23, "model",
                                          "phase 23 (c)")
        tp_err, tp_times = phase_mesh_k2(
            dev, card, TP_K2_CASES, SEED + 50,
            "phase 23 (a) K2 at the global shape")
        log(f"model-parallel paths' kernel launches: NMS {tp_k1} (--val-det, "
            f"every rank of the three CLI runs, and their checkpoints' "
            f"requests); conv backward {tp_k2_step} (one bf16 step a rank, "
            f"both heads) + {tp_k2_cli} (the CLI runs); phase 23 took "
            f"{time.perf_counter() - t23:.1f} s ({card})")
        done(23)

        # 24. the compositions of a world larger than one: the device
        # mosaic under every mesh, the chunk with collectives in it (NCCL
        # captured at a world of one, gloo eager at two), --multi-scale
        # across ranks (its CLI runs start first and are joined last)
        t24 = time.perf_counter()
        ms_runs = start_world_multiscale(Path(tmp) / "p24_ms", af_yaml)
        wc_k2_mosaic = phase_world_mosaic(dev, Path(tmp) / "p24_mosaic",
                                          af_yaml, card)
        stream_ranks = start_world_stream(Path(tmp) / "p24_stream", af_yaml)
        wc_k2_replay = phase_nccl_world1(dev, af_yaml, card)
        phase_stream_cli_world1(Path(tmp) / "p24_cli", af_yaml, card)
        wc_k2_ranks = check_world_stream(dev, card, stream_ranks)
        wc_ms_k1, wc_ms_k2 = check_world_multiscale(dev, card, ms_runs)
        wc_err, wc_times = phase_mesh_k2(
            dev, card, WC_K2_CASES, SEED + 60,
            "phase 24 (c) K2 at the haloed tile of the bucket "
            f"{cli.multi_scale_sizes(WC_SPATIAL_IMG)[0]}")
        log(f"world compositions' kernel launches: conv backward "
            f"{wc_k2_mosaic} (the mosaic steps, every rank of the three "
            f"meshes) + {wc_k2_replay} (one NCCL replay, profiler) + "
            f"{wc_k2_ranks} (two gloo ranks' eager chunk) + {wc_ms_k2} "
            f"(--multi-scale runs); NMS {wc_ms_k1} (--multi-scale --val-det "
            f"on every rank, and the checkpoints' requests); phase 24 took "
            f"{time.perf_counter() - t24:.1f} s ({card})")
        done(24)

        # 25. --spatial N on P5 grids N does not divide: unequal row blocks
        # on the card against one process, K2 at their haloed tiles, the
        # CLI (compact runs train, a dense one exits 1); the model roofline
        # with the MFU of phases 9 and 18, profiler_trace around two steps
        t25 = time.perf_counter()
        for sub in ("p25", "p25_cli", "p25_trace"):
            (Path(tmp) / sub).mkdir()
        un_cli = start_uneven_cli(Path(tmp) / "p25_cli", af_yaml)
        un_k2_step = phase_uneven_step(dev, Path(tmp) / "p25", af_yaml, card)
        un_k1, un_k2_cli = check_uneven_cli(dev, card, un_cli)
        un_err, un_times = phase_mesh_k2(
            dev, card, UN_K2_CASES, SEED + 70,
            "phase 25 (b) K2 at the unequal blocks' haloed tile")
        un_k2_trace = phase_tooling(dev, Path(tmp) / "p25_trace", yaml_path,
                                    card, rates, stream_rates)
        log(f"unequal blocks' kernel launches: conv backward {un_k2_step} "
            f"(one bf16 step a rank, both heads, @608 / 2 and @640 / 3) + "
            f"{un_k2_cli} (the CLI runs) + {un_k2_trace} (the traced "
            f"steps); NMS {un_k1} (--val-det on every rank of the two 608 "
            f"runs, and their checkpoints' requests); phase 25 took "
            f"{time.perf_counter() - t25:.1f} s ({card})")
        done(25)

        # 26. the packed layouts: packed against unpacked on the card
        # (float32 parity, a bf16 step with K2, the graphed chunk), K2 at
        # the packed C3a conv, the CLI under --packed, the card's times
        t26 = time.perf_counter()
        pk_k2_step = phase_packed_parity(dev, stream_yaml, cache, card)
        pk_err, pk_times = phase_mesh_k2(
            dev, card, (PK_K2_CASE,), SEED + 80,
            "phase 26 (b) K2 at the packed C3a conv")
        (Path(tmp) / "p26").mkdir()
        pk_k1, pk_k2_cli = phase_packed_cli(dev, Path(tmp) / "p26",
                                            yaml_path, af_yaml, stream_yaml,
                                            card)
        phase_packed_times(dev, cache, card)
        log(f"packed paths' kernel launches: conv backward {pk_k2_step} "
            f"(the packed bf16 steps of (a)) + {pk_k2_cli} (the CLI runs); "
            f"NMS {pk_k1} (--val-det and a request, both heads); phase 26 "
            f"took {time.perf_counter() - t26:.1f} s ({card})")
        done(26)

        # 27. the packed layouts' compositions: Q2 at the packed 2x2 (1, 0)
        # convs, --packed p3 --int8 serving, packed artifacts, the packed
        # step on row blocks and on a model mesh, the CLI's four
        # compositions
        (Path(tmp) / "p27").mkdir()
        pc = phase_packed_compositions(dev, Path(tmp) / "p27", af_yaml,
                                       compact_ckpts, card)
        pc_q1 = sum(c[0] for c in pc["int8"].values())
        pc_q2 = sum(c[1] for c in pc["int8"].values())
        pc_k1 = sum(c[2] for c in pc["int8"].values())
        log(f"packed compositions' kernel launches: (Q1, Q2, K1) "
            f"{pc['int8']} (--packed p3 --int8 request + B={INT8_BATCH} "
            f"call); in one call of each packed artifact (profiler) "
            f"{pc['artifacts']}; conv backward {pc['sp_k2']} (--spatial "
            f"bf16 steps) + {pc['tp_k2']} (--model-parallel steps) + "
            f"{pc['cli_k2']} (the CLI's mesh runs); NMS {pc['cli_k1']} (the "
            f"--packed-stem artifact's request and the CLI's mesh runs); Q2 "
            f"launches made to compare it with its plain version in (a): "
            f"{pc['q2_cmp']}")
        done(27)

    # 28. L1, the letterbox on the card, against PIL; its time at B=32
    l1 = phase_letterbox_kernel(dev)
    done(28)

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
        "ema_val_det_launches": ema_k1,
        "int8_launches": sum(c[2] for c in int8_counts.values()),
        "artifact_launches": sum(c["mask"] for c in
                                 artifact_counts.values()),
        "dp_launches": dp1[0] + dp2[0],
        "spatial_launches": sp_k1,
        "model_parallel_launches": tp_k1,
        "multiscale_world_launches": wc_ms_k1,
        "uneven_launches": un_k1,
        "packed_launches": pk_k1,
        "packed_int8_launches": pc_k1,
        "packed_artifact_launches": sum(c["mask"] for c in
                                        pc["artifacts"].values()),
        "packed_mesh_launches": pc["cli_k1"],
    }, {
        "name": "conv_bwd_3x3",
        "route": "cuda",
        "source": "yolo_from_scratch_tpu_torch/csrc/conv_bwd.cu",
        "replaces": "yolo_from_scratch_tpu/ops/conv_bwd.py:89",
        "launches": k2_launches,
        "max_abs_err": max(k2_err, ms_err, sp_err, tp_err, wc_err, un_err,
                           pk_err, pc["k2_err"]),
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": k2_lib_ms,
        "af_launches": af_k2_launches,
        "compact_launches": compact_k2,
        "stream_launches": stream_k2["anchor"],
        "stream_af_launches": stream_k2["anchor_free"],
        "ema_launches": ema_k2,
        "multiscale_launches": [ms_k2[s] for s in ms_sizes],
        "accum_launches": accum_k2,
        "recipe_graph_launches": recipe_k2,
        "dp_launches": dp1[1] + dp2[1],
        "spatial_launches": sp_k2_step + sp_k2_cli,
        # K2 at the haloed tiles of --spatial 2 (phase 22 (b))
        "spatial_tiles": [{"shape": [b, h, w, 64], "ms": t[0],
                           "plain_ms": t[1], "library_ms": t[2],
                           "bound_ms": t[3]}
                          for (b, h, w), t in sp_times.items()],
        "model_parallel_launches": tp_k2_step + tp_k2_cli,
        # K2 at the global shapes of --model-parallel 2 (phase 23 (a))
        "model_parallel_shapes": [{"shape": [b, h, w, 64], "ms": t[0],
                                   "plain_ms": t[1], "library_ms": t[2],
                                   "bound_ms": t[3]}
                                  for (b, h, w), t in tp_times.items()],
        "mosaic_launches": wc_k2_mosaic,
        "stream_world_launches": wc_k2_replay + wc_k2_ranks,
        "multiscale_world_launches": wc_ms_k2,
        # K2 at the haloed tiles of --spatial 2 --multi-scale's first
        # bucket (phase 24 (c))
        "multiscale_world_tiles": [{"shape": [b, h, w, 64], "ms": t[0],
                                    "plain_ms": t[1], "library_ms": t[2],
                                    "bound_ms": t[3]}
                                   for (b, h, w), t in wc_times.items()],
        "uneven_launches": un_k2_step + un_k2_cli + un_k2_trace,
        # K2 at the haloed tiles of unequal row blocks (phase 25 (b))
        "uneven_tiles": [{"shape": [b, h, w, 64], "ms": t[0],
                          "plain_ms": t[1], "library_ms": t[2],
                          "bound_ms": t[3]}
                         for (b, h, w), t in un_times.items()],
        "packed_launches": pk_k2_step + pk_k2_cli,
        # K2 at the packed C3a bottleneck conv (phase 26 (b))
        "packed_c3a": [{"shape": [b, h, w, 64], "ms": t[0],
                        "plain_ms": t[1], "library_ms": t[2],
                        "bound_ms": t[3]}
                       for (b, h, w), t in pk_times.items()],
        "packed_mesh_launches": pc["sp_k2"] + pc["tp_k2"] + pc["cli_k2"],
        # K2 at the packed C3a conv's haloed tiles of --spatial 2 and 3
        # (phase 27 (d))
        "packed_spatial_tiles": [{"shape": [b, h, w, 64], "ms": t[0],
                                  "plain_ms": t[1], "library_ms": t[2],
                                  "bound_ms": t[3]}
                                 for (b, h, w), t in pc["k2_times"].items()],
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
         roofline.chain_bwd_bound_ms(8, 40, 40, "bfloat16")[1]))), {
        # Q1 and Q2: device ms, bounds and yardsticks summed over the 24
        # distinct quantized convs at B=32 (phase 20 (a))
        "name": "quant_input",
        "route": "cuda",
        "source": "yolo_from_scratch_tpu_torch/csrc/int8_conv.cu",
        "replaces": "yolo_from_scratch_tpu/infer/quantize.py:166",
        "launches": sum(c[0] for c in int8_counts.values()),
        "max_abs_err": 0.0,
        "ms": q_sums["q1"],
        "plain_ms": q_sums["q1_plain"],
        "bound_ms": q_sums["q1_bound"],
        "bound_by": "bytes",
        "library_ms": None,
        "artifact_launches": sum(c["q1"] for c in artifact_counts.values()),
        "packed_int8_launches": pc_q1,
        "packed_artifact_launches": sum(c["q1"] for c in
                                        pc["artifacts"].values()),
    }, {
        "name": "int8_conv",
        "route": "cuda",
        "source": "yolo_from_scratch_tpu_torch/csrc/int8_conv.cu",
        "replaces": "yolo_from_scratch_tpu/infer/quantize.py:173",
        "launches": sum(c[1] for c in int8_counts.values()),
        "max_abs_err": q_err,
        "ms": q_sums["q2"],
        "plain_ms": q_sums["q2_plain"],
        "bound_ms": q_sums["q2_bound"],
        "bound_by": ("bytes" if q_sums["q2_bound_bytes"]
                     >= q_sums["q2_bound_operations"] else "operations"),
        "library_ms": q_sums["int_mm"],
        "conv_bf16_ms": q_sums["conv_bf16"],
        "b1_ms": q_sums["b1_q2"],
        "b1_bound_ms": q_sums["b1_q2_bound"],
        "ms_1x1": q_sums["q2_1x1"],
        "int_mm_1x1_ms": q_sums["int_mm_1x1"],
        "b1_ms_1x1": q_sums["b1_q2_1x1"],
        "b1_int_mm_1x1_ms": q_sums["b1_int_mm_1x1"],
        "artifact_launches": sum(c["q2"] for c in artifact_counts.values()),
        "packed_int8_launches": pc_q2,
        "packed_artifact_launches": sum(c["q2"] for c in
                                        pc["artifacts"].values()),
        "packed_max_abs_err": pc["q2_err"],
        # Q2 at the packed 2x2 (1, 0) convs (phase 27 (a)): device ms
        # beside the bound and the yardsticks, by (B, cin, cout, h, w)
        "packed_2x2": [{"shape": list(key), "ms": r["q2"], "q1_ms": r["q1"],
                        "bound_ms": r["bound"], "bound_by": r["bound_by"],
                        "plain_ms": r.get("q2_plain"),
                        "library_ms": r.get("int_mm"),
                        "conv_bf16_ms": r.get("conv_bf16")}
                       for key, r in pc["q2_rows"].items()],
    }, {
        "name": "letterbox",
        "route": "cuda",
        "source": "yolo_from_scratch_tpu_torch/csrc/letterbox.cu",
        "replaces": None,
        # the main path's launches: phase 13's timed BatchPredictor calls
        "launches": batch_l1_launches,
        "max_abs_err": 0,
        "ms": l1["640x480"]["ms"],
        "plain_ms": l1["640x480"]["plain_ms"],
        "bound_ms": l1["640x480"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "timed": l1,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
