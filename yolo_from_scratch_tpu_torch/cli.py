"""Command line of the port (counterpart of `yolo_from_scratch_tpu/cli.py`),
dispatching on the positional files' extensions as the JAX CLI does.

  Training:        python -m yolo_from_scratch_tpu_torch data.yaml [OPTIONS]
  Evaluation:      python -m yolo_from_scratch_tpu_torch data.yaml model.ckpt
  Inference:       python -m yolo_from_scratch_tpu_torch image.jpg model.ckpt
  Inspect:         python -m yolo_from_scratch_tpu_torch model.ckpt
  Compute Anchors: python -m yolo_from_scratch_tpu_torch data.yaml \
                       --compute-anchors
  Export:          python -m yolo_from_scratch_tpu_torch [data.yaml] \
                       model.ckpt --export out.yexp [--int8]
  Artifact:        python -m yolo_from_scratch_tpu_torch [image.jpg] \
                       model.yexp

(`python train_torch.py ...` is the same command line.) Each prints the
JAX CLI's stdout lines. Training runs either head (`--head anchor` or
`anchor_free`) with dense host targets, or with `--compact-targets [K]`
from compact labels expanded on the device (`--sparse-loss`,
`--device-mosaic`, `--device-augment [full|flip]`); `--weight-decay W`
makes the optimizer AdamW; `--stream` trains from a one-time on-disk cache
through the scanned trainers, N steps (`--stream-chunk`) a CUDA graph
replay, from double-buffered chunks or a device-resident pool
(`--stream-pool P`). `--resume CKPT` goes on from a checkpoint of either
package (its config governs; weights, optimizer state, step and epoch are
restored, and the file is written again in place), `--ema` evaluates and
saves an EMA of the weights (decay 0.9999, tau 2000), `--multi-scale`
rotates 0.75x / 1x / 1.25x resolution buckets per epoch and `--augment`
adds the host's mosaic, flip and jitter at load time, as the JAX CLI
does. Evaluation, inference and inspect take the
head from the checkpoint; `--dtype auto` is bfloat16 on the card and
float32 on the CPU.
`--val-det` adds the detection-level P/R/F1 to each epoch, `--map` adds
mAP to evaluation (both through `BatchPredictor`, one NMS launch a batch),
`--device-letterbox` resizes and pads on the device for inference and
`--map`. `--int8` serves the post-training int8 model (`infer/
quantize.py`) for inference (calibrated on the image) and `--map`
(calibrated on 16 train-split images); `--export OUT.yexp` freezes the
batched serving program with its weights (`infer/export.py`, one platform:
`--export-platforms cuda` or `cpu`, by default `--device`'s), and a
`.yexp` alone is inspected, beside an image served.
`--data-parallel` trains over the processes of a `torch.distributed`
group (`parallel/`): `--distributed` connects this process first, through
`--coordinator HOST:PORT --num-processes N --process-id I` or torchrun's
environment (`nccl` on the card, `gloo` on the CPU); `--batch-size` is
then per process, and each step is the JAX package's data-parallel step
over the global batch. Without a process group `--data-parallel` is a
world of one. `--spatial N` makes the mesh 2-D, `data x space` (JAX's
layout: rank r holds rows r % N of data shard r // N): every image's
rows are split N ways over the ranks of a space group, for training and
evaluation, both heads; the JAX CLI's rules hold (exit 1 without
`--data-parallel`, with `--model-parallel` or with `--stream`). Where N
does not divide the P5 grid (img_size / 32) the blocks differ by a P5
row (`parallel/mesh.py::row_split`; ranks past the grid hold none) for
compact labels, which the JAX CLI trains there too; dense targets exit 1
before training, where the JAX CLI's `device_put` of them exits 1. `--model-parallel N` makes it
`data x model` (rank r is model index r % N of data shard r // N): the
large convs' output channels, their BatchNorm and Adam moments are split
N ways over the ranks of a model group (`parallel/tensor.py`), for
training, both heads; the eval mode takes the mesh with whole weights and
batches on the data axis; inference ignores the flag; the JAX CLI's rules
hold (exit 1 without `--data-parallel`, with `--spatial`, with `--stream`,
or on a world that N does not divide). `--stream-pool` with a mesh exits
1, as the JAX CLI's does. Under every mesh `--compact-targets
--device-mosaic` draws its partners from the global batch (gathered over
the ranks) and `--multi-scale` takes one step and one sharded loader a
bucket (under `--spatial N` with dense targets every bucket's P5 grid
must divide by N).
`--stream --distributed` runs when every process is on one host: the
port's counterpart of the JAX CLI's `--stream --data-parallel` over one
host's chips, `--batch-size` per process, each chunk's collectives in its
CUDA graph with NCCL (eager steps with `gloo`); ranks on several hosts
exit 1 with the JAX CLI's line.
`--packed {auto,none,stem,interior,p3}` (or the aliases `--packed-stem`,
`--packed-interior`, `--packed-p3`) runs the model in a space-to-depth
packed layout (`models/packed.py`) in every mode: training (eager,
graphed, `--stream`, `--resume` with the flag's layout, the data-parallel
loaders), evaluation, inference, `--val-det` and `--map`; the loaders,
the stream cache and the predictors pack the images on the host. It is a
runtime knob: checkpoints hold no layout, and either layout loads the
other's. `auto` is `none` here, on the card and on the CPU: the JAX CLI's
`auto` is `p3` on any accelerator, where packing fills the MXU's lanes;
which layout pays on the H100 is for the benchmark to decide. A conflicting
`--packed` and alias exit 1 with the JAX CLI's message. Packing with
`--int8`, `--export`, `--spatial` or `--model-parallel` is not ported yet
(ROADMAP A10b): it exits 2 and names both flags, as does any mode the port
does not have.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from yolo_from_scratch_tpu_torch.config import (
    YOLO_SIZES,
    YoloConfig,
    auto_fast_layout,
)

CKPT_EXTS = (".ckpt", ".msgpack")
IMG_EXTS = (".jpg", ".png", ".jpeg")
YAML_EXTS = (".yaml", ".yml")
ART_EXTS = (".yexp",)  # frozen serving artifacts (infer/export.py)

# --packed's levels, and the packed_* config fields each one sets
PACKED_LEVELS = {"none": (), "stem": ("packed_stem",),
                 "interior": ("packed_stem", "packed_interior"),
                 "p3": ("packed_stem", "packed_interior", "packed_p3")}
# the secondary mesh axes, which --stream refuses (exit 1); _train
# refuses --augment, --ema, --multi-scale and --distributed over several
# hosts
STREAM_EXCLUSIVE = ("--spatial", "--model-parallel")
# the P5 grid's stride: --spatial N splits it N ways
P5_STRIDE = 32
# --multi-scale's resolution factors, each rounded to a multiple of 32
MULTI_SCALE_FACTORS = (0.75, 1.0, 1.25)
# --ema's decay (fit's default, as the JAX CLI leaves it)
EMA_DECAY = 0.9999


def build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m yolo_from_scratch_tpu_torch",
        description="YOLO training/inference (PyTorch + CUDA port)")
    parser.add_argument("files", nargs="*",
                        help="YAML config, .ckpt model, or image file")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="device to run on (default: cuda; no fallback)")
    parser.add_argument("--size", default="s", choices=list(YOLO_SIZES),
                        help="model size (default: s)")
    parser.add_argument("--img-size", type=int, default=640,
                        help="input image size (default: 640)")
    parser.add_argument("--lr", type=float, default=1e-2,
                        help="initial learning rate (default: 0.01)")
    parser.add_argument("--warmup-epochs", type=int, default=3,
                        help="number of warmup epochs (default: 3)")
    parser.add_argument("--min-lr", type=float, default=1e-4,
                        help="minimum learning rate (default: 0.0001)")
    parser.add_argument("--epochs", type=int, default=100,
                        help="total training epochs (default: 100)")
    parser.add_argument("--batch-size", type=int, default=8,
                        help="batch size (default: 8)")
    parser.add_argument("--dtype", default="auto",
                        choices=["auto", "float32", "bfloat16"],
                        help="conv compute dtype. 'auto' (default): "
                             "training bfloat16 on the card, float32 on the "
                             "CPU; evaluation and inference the "
                             "checkpoint's")
    parser.add_argument("--head", default="anchor",
                        choices=["anchor", "anchor_free"],
                        help="detection head family: 'anchor' (the "
                             "reference's 3-anchor heads) or 'anchor_free' "
                             "(the YOLOv8-style decoupled head)")
    parser.add_argument("--packed", default="auto",
                        choices=["auto", *PACKED_LEVELS],
                        help="space-to-depth packed conv layout level "
                             "(models/packed.py): numerically equivalent, "
                             "checkpoint-interchangeable. 'auto' (default) "
                             "= 'none' on the card and on the CPU (the JAX "
                             "CLI's 'auto' is 'p3' on an accelerator, where "
                             "packing fills MXU lanes; which level pays on "
                             "the H100 is not measured yet); an explicit "
                             "level always wins")
    parser.add_argument("--packed-stem", action="store_true",
                        help="alias for --packed stem")
    parser.add_argument("--packed-interior", action="store_true",
                        help="alias for --packed interior")
    parser.add_argument("--packed-p3", action="store_true",
                        help="alias for --packed p3")
    parser.add_argument("--compact-targets", nargs="?", const=64, type=int,
                        default=0, metavar="K",
                        help="stream compact labels (up to K boxes an "
                             "image, default 64) and build the targets on "
                             "the device inside the step "
                             "(data/assign_device.py): ~1.3 KB an image "
                             "over the host link instead of ~8.6 MB at "
                             "nc=80 @640. Evaluation: anchor head only")
    parser.add_argument("--sparse-loss", action="store_true",
                        help="with --compact-targets (anchor head): no "
                             "dense target maps at all; the gather-based "
                             "loss (ops/losses_sparse.py) reads only the "
                             "<=K winner cells an image plus one "
                             "objectness reduction. Same loss to "
                             "summation order; augmentation moves to "
                             "label level")
    parser.add_argument("--device-mosaic", action="store_true",
                        help="with --compact-targets: 4-image mosaic "
                             "composed on the device inside the step "
                             "(fixed-centre 2x2, partners from the batch, "
                             "p=0.5; ops/mosaic_device.py)")
    parser.add_argument("--device-augment", nargs="?", const="full",
                        default=False, choices=["full", "flip"],
                        help="augmentation on the device inside the train "
                             "step. Bare/'full' = hflip + colour jitter; "
                             "'flip' = hflip only (use when class identity "
                             "is colour-coded)")
    parser.add_argument("--stream", action="store_true",
                        help="train from a one-time on-disk cache "
                             "(pre-letterboxed uint8 + compact labels, "
                             "data/cache.py): epochs stream through a "
                             "double-buffered chunk ring into the scanned "
                             "trainer, N steps a CUDA graph replay; no "
                             "per-epoch decode, O(chunk) device memory for "
                             "any dataset size. Implies compact targets")
    parser.add_argument("--stream-pool", type=int, default=0, metavar="P",
                        help="with --stream: keep a P-image sample pool "
                             "resident on the card, refreshed from disk in "
                             "the background (shuffle buffer with data "
                             "echoing); the fresh-data ingest rate is "
                             "reported each epoch beside img/s")
    parser.add_argument("--stream-chunk", type=int, default=16, metavar="N",
                        help="with --stream: optimizer steps a dispatch "
                             "(one CUDA graph replay; default 16)")
    parser.add_argument("--cache-dir", type=str, default=None,
                        help="with --stream: cache location (default: a "
                             ".yolo_tpu_cache_* dir next to the images)")
    parser.add_argument("--resume", type=str, default=None, metavar="CKPT",
                        help="resume training from a checkpoint of either "
                             "package: weights (the raw ones of an --ema "
                             "checkpoint), optimizer state, step and "
                             "epoch; its config (size, img-size, head, "
                             "nc) governs, and the file is written again "
                             "in place")
    parser.add_argument("--ema", action="store_true",
                        help="keep an EMA of the weights and BatchNorm "
                             "statistics (decay 0.9999, tau 2000): "
                             "evaluation, --val-det and the checkpoint's "
                             "model use it, the raw weights ride in the "
                             "checkpoint for --resume")
    parser.add_argument("--multi-scale", action="store_true",
                        help="YOLOv5-style multi-scale training: epochs "
                             "rotate through 0.75x/1x/1.25x resolution "
                             "buckets (rounded to /32; one train step and "
                             "loader a bucket); evaluation and the "
                             "checkpoint stay at --img-size")
    parser.add_argument("--augment", action="store_true",
                        help="host augmentation at load time: a 4-image "
                             "mosaic (p=0.5), hflip (p=0.5) and "
                             "brightness/contrast jitter (the reference "
                             "has none)")
    parser.add_argument("--data-parallel", action="store_true",
                        help="Shard batches over the processes of the "
                             "torch.distributed group (one process a "
                             "rank; without a group a world of one)")
    parser.add_argument("--spatial", type=int, default=1, metavar="N",
                        help="With --data-parallel: split each image's "
                             "rows N ways over the ranks (2-D data x space "
                             "mesh; spatial partitioning for high "
                             "resolutions). The P5 grid (--img-size / 32) "
                             "must divide by N")
    parser.add_argument("--model-parallel", type=int, default=1,
                        metavar="N",
                        help="With --data-parallel: channel-shard the "
                             "large conv kernels + BN params + Adam "
                             "moments N ways (2-D data x model mesh, "
                             "tensor parallelism; for l/x variants where "
                             "params+moments press per-chip HBM). "
                             "Mutually exclusive with --spatial")
    parser.add_argument("--distributed", action="store_true",
                        help="Multi-process training: connect this process "
                             "via torch.distributed before building the "
                             "mesh (torchrun's environment when nothing "
                             "else is given; otherwise give --coordinator/"
                             "--num-processes/--process-id). --batch-size "
                             "is PER PROCESS; implies --data-parallel")
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="With --distributed outside torchrun: the "
                             "coordinator address")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="With --distributed: total process count")
    parser.add_argument("--process-id", type=int, default=None,
                        help="With --distributed: this process's id")
    parser.add_argument("--weight-decay", type=float, default=0.0,
                        metavar="W",
                        help="AdamW decoupled weight decay (default 0 = "
                             "plain Adam, the reference optimizer); every "
                             "parameter is decayed")
    parser.add_argument("--reference-quirks", action="store_true",
                        help="replicate the reference's 640-denominator "
                             "decode in loss/eval at non-640 resolutions")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--metrics-jsonl", default=None,
                        help="write per-epoch metrics to this JSONL file")
    parser.add_argument("--compute-anchors", action="store_true",
                        help="compute optimal anchors for the dataset with "
                             "k-means")
    parser.add_argument("--map", action="store_true",
                        help="evaluation: also COCO-style mAP@0.5 and "
                             "mAP@[.5:.95] over the NMS inference path")
    parser.add_argument("--val-det", action="store_true",
                        help="training: also detection-level P/R/F1 at "
                             "conf 0.5 (NMS output vs GT) on the val split "
                             "every epoch; the honest per-epoch metric for "
                             "--head anchor_free, whose cell-aligned grid "
                             "P/R/F1 understates TAL-trained models")
    parser.add_argument("--device-letterbox", action="store_true",
                        help="inference / --map: resize and pad on the "
                             "device (the host only decodes)")
    parser.add_argument("--int8", action="store_true",
                        help="inference / --map / --export: serve the "
                             "post-training int8 model (BN folded into "
                             "per-channel int8 conv weights, per-tensor "
                             "activation scales calibrated on the image, or "
                             "on 16 train images for --map and --export); "
                             "its convs run the int8 kernels Q1 and Q2 on "
                             "the card")
    parser.add_argument("--export", type=str, default=None,
                        metavar="OUT.yexp",
                        help="with a .ckpt: freeze the batched serving "
                             "program (weights baked in) to a serving "
                             "artifact via torch.export; serve it with "
                             "`train_torch.py image.jpg model.yexp`")
    parser.add_argument("--export-batch", type=int, default=8,
                        help="frozen batch size for --export (default: 8)")
    parser.add_argument("--export-platforms", type=str, default=None,
                        metavar="P",
                        help="the one platform of the --export program, "
                             "'cuda' (kernels through the registered ops) "
                             "or 'cpu' (their plain versions); default: "
                             "--device's")
    return parser


def _resolve_packing(args):
    """Resolve --packed and its aliases into `args.packed` (the level) and
    `args.layout` (the packed_* config fields to set), as the JAX CLI
    resolves them, but with 'auto' = 'none' (`config.py::
    auto_fast_layout`). Returns an exit status on a conflict or an
    unported composition, else None."""
    level = args.packed
    alias = ("p3" if args.packed_p3 else
             "interior" if args.packed_interior else
             "stem" if args.packed_stem else None)
    if alias is not None:
        if level not in ("auto", alias):
            # '--packed p3 --packed-stem' must not silently downgrade
            print(f"conflicting packing flags: --packed {level} vs the "
                  f"--packed-{alias} alias", file=sys.stderr)
            return 1
        level = alias
    if level == "auto":
        auto = auto_fast_layout(args.device)
        level = next(lvl for lvl in ("p3", "interior", "stem", "none")
                     if all(auto[k] for k in PACKED_LEVELS[lvl]))
    flag = f"--packed-{alias}" if alias else f"--packed {level}"
    args.packed = level
    args.layout = {k: k in PACKED_LEVELS[level] for k in PACKED_LEVELS["p3"]}
    for other, on in (("--int8", args.int8), ("--export", args.export),
                      ("--spatial", args.spatial > 1),
                      ("--model-parallel", args.model_parallel > 1)):
        if on and level != "none":
            print(f"ERROR: {flag} with {other} is not ported yet (ROADMAP "
                  f"A10b); use `python train.py` for it")
            return 2
    return None


def _param_tree_items(params, prefix=""):
    for key in sorted(params.keys()):
        val = params[key]
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict):
            yield from _param_tree_items(val, name)
        else:
            yield name, val


def _device(name):
    import torch

    from yolo_from_scratch_tpu_torch.device import cuda_device

    return cuda_device() if name == "cuda" else torch.device("cpu")


def _inspect(ckpt_file):
    from yolo_from_scratch_tpu_torch.utils.checkpoint import (
        config_from_payload,
        read_payload,
    )

    payload = read_payload(ckpt_file)
    cfg = config_from_payload(payload)
    print(f"Model loaded from {ckpt_file}")
    print(f"Number of classes: {cfg.num_classes}")
    print(f"Image size: {cfg.img_size}")
    print(f"Width multiplier: {cfg.width_mult}")
    print(f"Depth multiplier: {cfg.depth_mult}")
    if cfg.head_type != "anchor":
        print(f"Head type: {cfg.head_type}")
    print("\nModel architecture:")
    total = 0
    for name, p in _param_tree_items(payload["model"]["params"]):
        n = int(np.prod(p.shape))
        total += n
        print(f"  {name}: {list(p.shape)}, {n} parameters")
    print(f"\nTotal parameters: {total:,}")


def _infer(args, image_file, ckpt_file):
    from yolo_from_scratch_tpu_torch.infer.predict import Predictor
    from yolo_from_scratch_tpu_torch.utils.checkpoint import load_checkpoint

    device = _device(args.device)
    state_dict, cfg, _ = load_checkpoint(ckpt_file)
    if args.dtype != "auto":
        cfg = cfg.with_(compute_dtype=args.dtype)
    cfg = cfg.with_(**args.layout)  # a runtime knob; weights interchangeable
    print(f"Running inference on {image_file}")
    print(f"Model: {ckpt_file}, Classes: {cfg.num_classes}, "
          f"Image size: {cfg.img_size}")
    detections = Predictor(
        state_dict, cfg, device=device,
        device_letterbox=args.device_letterbox,
        quantize_calib=[image_file] if args.int8 else None)(image_file)
    _print_detections(detections)


def _print_detections(detections):
    if len(detections) == 0:
        print("No objects detected.")
    else:
        print(f"\nDetected {len(detections)} object(s):")
        for i, (x1, y1, x2, y2, conf, class_id) in enumerate(detections):
            print(f"  {i + 1}. Box: ({x1:.1f}, {y1:.1f}, {x2:.1f}, "
                  f"{y2:.1f}), Confidence: {conf:.3f}, "
                  f"Class: {int(class_id)}")


def _train_calibration_images(config, cfg):
    """--int8's calibration images for --map and --export: the first 16 of
    the train split (never the split being scored)."""
    from yolo_from_scratch_tpu_torch.data import YoloDataset

    return YoloDataset(config["train"], cfg.num_classes, cfg.anchors_array,
                       cfg.img_size, head_type=cfg.head_type).imgs[:16]


def _artifact(artifact_file, image_file):
    """Inspect a serving artifact, or serve `image_file` from it."""
    from yolo_from_scratch_tpu_torch.infer.artifact import (
        load_serving_artifact,
    )

    art = load_serving_artifact(artifact_file)
    if not image_file:
        print(f"Serving artifact: {artifact_file}")
        for key, val in sorted(art.meta.items()):
            print(f"  {key}: {val}")
        return
    m = art.meta
    print(f"Serving artifact: {artifact_file} (batch {m['batch_size']}, "
          f"img {m['img_size']}, classes {m['num_classes']}, "
          f"platforms {','.join(m['platforms'])})")
    print(f"Running inference on {image_file}")
    _print_detections(art([image_file])[0])


def _export(args, config, ckpt_file):
    import os

    from yolo_from_scratch_tpu_torch.infer.export import (
        check_platforms,
        save_serving_artifact,
    )
    from yolo_from_scratch_tpu_torch.utils.checkpoint import load_checkpoint

    platforms = (args.export_platforms.split(",") if args.export_platforms
                 else [args.device])
    try:
        check_platforms(platforms)
    except ValueError as e:
        print(f"ERROR: --export-platforms: {e}")
        return 1
    state_dict, cfg, _ = load_checkpoint(ckpt_file)
    if args.dtype != "auto":
        cfg = cfg.with_(compute_dtype=args.dtype)
    calib = None
    if args.int8:
        if config is None:
            print("ERROR: --export --int8 needs a dataset YAML for "
                  "calibration images (train.py data.yaml model.ckpt "
                  "--export out.yexp --int8)")
            return 1
        calib = _train_calibration_images(config, cfg)
    header = save_serving_artifact(args.export, state_dict, cfg,
                                   args.export_batch, platforms=platforms,
                                   quantize_calib=calib)
    print(f"Exported {ckpt_file} -> {args.export} "
          f"({os.path.getsize(args.export):,} bytes)")
    print(f"  batch {header['batch_size']}, img {header['img_size']}, "
          f"classes {header['num_classes']}, "
          f"platforms {','.join(header['platforms'])}, "
          f"nms {'cuda' if header['cuda_nms'] else 'plain'}"
          + (", int8" if header["int8"] else ""))
    return 0


def _compute_anchors(args, yaml_file):
    if not yaml_file:
        print("ERROR: --compute-anchors requires a dataset YAML file")
        print("Usage: python train_torch.py dataset.yaml --compute-anchors "
              "[--img-size SIZE]")
        return 1
    from yolo_from_scratch_tpu_torch.utils.anchors import (
        compute_optimal_anchors,
    )

    print(f"Computing optimal anchors for {yaml_file} at "
          f"img_size={args.img_size}...")
    compute_optimal_anchors(yaml_file, img_size=args.img_size,
                            device=_device(args.device))
    return 0


def _loader(config, split, cfg, batch_size, shuffle=False, seed=0,
            compact=0, augment=False, process_shard=None, pad_shard=True):
    from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset

    return DataLoader(YoloDataset(config[split], cfg.num_classes,
                                  cfg.anchors_array, cfg.img_size,
                                  head_type=cfg.head_type, augment=augment,
                                  seed=seed),
                      batch_size=batch_size, shuffle=shuffle, seed=seed,
                      compact=compact, process_shard=process_shard,
                      pad_shard=pad_shard, pack_images=cfg.packed_stem)


def multi_scale_sizes(img_size):
    """--multi-scale's buckets: 0.75x / 1x / 1.25x of img_size rounded to
    multiples of 32 (at least 32), sorted, as the JAX CLI computes them."""
    return sorted({max(32, round(img_size * f / 32) * 32)
                   for f in MULTI_SCALE_FACTORS})


def _run_mesh(args, device):
    """--data-parallel's mesh, 2-D with --spatial N or --model-parallel N,
    and its banner, as the JAX CLI prints it: (mesh, None), or (None, exit
    status) for a world that does not divide by N or --stream-pool."""
    from yolo_from_scratch_tpu_torch.parallel.mesh import (
        make_mesh,
        make_mesh_2d,
        make_mesh_dm,
    )

    if args.spatial > 1 or args.model_parallel > 1:
        axis, n = (("space", args.spatial) if args.spatial > 1
                   else ("model", args.model_parallel))
        try:
            mesh = (make_mesh_2d if axis == "space" else make_mesh_dm)(
                n, device)
        except ValueError as e:
            print(f"ERROR: {e}")
            return None, 1
        print(f"2-D mesh: data={mesh.n_data} x {axis}={n} over "
              f"{mesh.size} process(es)")
    else:
        mesh = make_mesh(device)
        print(f"Data-parallel mesh over {mesh.size} process(es)"
              + ("" if mesh.group is not None else
                 " (no process group: a world of one)"))
    if args.stream and args.stream_pool:
        # the JAX CLI refuses it with any mesh, before "not ported"
        print("ERROR: --stream-pool is single-device (the pool gather does "
              "not shard); use --stream with --data-parallel instead")
        return None, 1
    return mesh, None


def _spatial_refused(args, cfg, dense, what=""):
    """True (after the message) when --spatial N would split cfg's P5
    grid (`what`: which size, when not --img-size's) into unequal row
    blocks for `dense` host targets. The JAX CLI exits 1 there (its
    `device_put` cannot shard the dense maps on `space`); compact labels
    it trains, and so does the port, on the block plan of
    `parallel/mesh.py`."""
    rows = cfg.img_size // P5_STRIDE
    if dense and args.spatial > 1 and rows % args.spatial:
        print(f"ERROR: --spatial {args.spatial} needs the P5 grid{what} "
              f"(img_size / {P5_STRIDE} = {rows} rows at {cfg.img_size}) to "
              f"divide by {args.spatial} with dense targets, as the JAX CLI "
              f"does (its dense targets do not shard on such a grid); "
              f"--compact-targets splits the rows unequally")
        return True
    return False


def _data_shard(mesh):
    """A loader's process_shard: the data shard of this rank (the ranks of
    a space or model group load the same images), None for one data
    shard."""
    if mesh is None or mesh.n_data == 1:
        return None
    return (mesh.data_index, mesh.n_data)


def _evaluate(args, config, ckpt_file):
    from yolo_from_scratch_tpu_torch.models.yolo import YOLO
    from yolo_from_scratch_tpu_torch.train.loop import eval_epoch
    from yolo_from_scratch_tpu_torch.train.steps import make_eval_step
    from yolo_from_scratch_tpu_torch.utils.checkpoint import load_checkpoint

    device = _device(args.device)
    mesh = None
    if args.data_parallel:
        mesh, rc = _run_mesh(args, device)
        if mesh is None:
            return rc
        device = mesh.device
    state_dict, cfg, _ = load_checkpoint(ckpt_file)
    if args.dtype != "auto":
        cfg = cfg.with_(compute_dtype=args.dtype)
    cfg = cfg.with_(**args.layout)
    compact = args.compact_targets if cfg.head_type == "anchor" else 0
    if _spatial_refused(args, cfg, dense=not compact):
        return 1
    print(f"Evaluating model from {ckpt_file}")
    print(f"Number of classes: {cfg.num_classes}")
    print(f"Image size: {cfg.img_size}")
    print(f"Width multiplier: {cfg.width_mult}")
    print(f"Depth multiplier: {cfg.depth_mult}")
    model = YOLO(cfg)
    model.load_state_dict(state_dict)
    model.to(device)
    if args.compact_targets and not compact:
        print("NOTE: --compact-targets ignored (anchor head only)")
    eval_step = make_eval_step(cfg, quirk_640=args.reference_quirks,
                               device=device, compact_targets=bool(compact),
                               mesh=mesh)
    predictor = None
    if args.map:
        from yolo_from_scratch_tpu_torch.infer.predict import BatchPredictor

        # low threshold: mAP integrates the whole PR curve, so the
        # low-confidence tail must not be cut
        # --int8: scales calibrated on train-split images
        predictor = BatchPredictor(
            state_dict, cfg, conf_threshold=1e-3, max_outputs=300,
            device_letterbox=args.device_letterbox, device=device,
            quantize_calib=(_train_calibration_images(config, cfg)
                            if args.int8 else None))
    # several processes: each counts its data shard's unpadded slice of
    # each split, the ranks of a space group their rows of it; on a model
    # mesh the weights stay whole and model index 0 counts the slice
    for title, split in (("Training", "train"), ("Validation", "val")):
        loader = _loader(config, split, cfg, args.batch_size,
                         compact=compact, process_shard=_data_shard(mesh),
                         pad_shard=False)
        loss, p, r, f1 = eval_epoch(eval_step, model, loader, device, mesh)
        print(f"\n{title} Set:")
        print(f"  Loss: {loss:.4f}")
        print(f"  Precision: {p:.2f}%")
        print(f"  Recall: {r:.2f}%")
        print(f"  F1 Score: {f1:.2f}%")
        if predictor is not None:
            _print_map(predictor, loader.dataset, cfg, config)
    return 0


def _print_map(predictor, dataset, cfg, config):
    from yolo_from_scratch_tpu_torch.train.map_eval import evaluate_map

    m = evaluate_map(predictor, dataset, num_classes=cfg.num_classes)
    print(f"  mAP@0.5: {m['map50'] * 100:.2f}%")
    print(f"  mAP@[.5:.95]: {m['map'] * 100:.2f}%")
    print(f"  Detection P/R/F1 @conf0.5: {m['det_precision']:.2f}% / "
          f"{m['det_recall']:.2f}% / {m['det_f1']:.2f}%")
    if cfg.num_classes > 1 and m.get("per_class_ap50"):
        names = config.get("names") or []
        print("  Per-class AP@0.5:")
        for c, ap in sorted(m["per_class_ap50"].items()):
            label = names[c] if c < len(names) else f"class {c}"
            print(f"    {label}: {ap * 100:.2f}%")


def _det_eval(cfg, model, dataset, device, mesh=None):
    """fit()'s `det_eval`: one BatchPredictor at conf 0.5 with a model of
    its own, into which each epoch copies the live float32 master weights
    (the predictor casts its convs to the compute dtype; the training
    model's must stay float32). With a `mesh` of several processes each
    rank scores its unpadded strided slice of the split, idx[rank::size],
    and the counts are summed over the ranks: they equal one process's
    (the JAX CLI wrap-pads the slices and counts up to size - 1 images
    twice). A model cut for a model mesh is served at full size, its
    weights gathered over the model group on every rank first."""
    from yolo_from_scratch_tpu_torch.infer.predict import BatchPredictor
    from yolo_from_scratch_tpu_torch.parallel.distributed import (
        global_eval_reduce,
    )
    from yolo_from_scratch_tpu_torch.parallel.tensor import full_state_dict
    from yolo_from_scratch_tpu_torch.train.map_eval import (
        evaluate_det_counts,
    )
    from yolo_from_scratch_tpu_torch.train.metrics import prf1

    predictor = BatchPredictor(full_state_dict(model), cfg,
                               conf_threshold=0.5, device=device)
    sharded = mesh is not None and mesh.size > 1
    indices = (list(range(len(dataset)))[mesh.rank::mesh.size] if sharded
               else None)

    def det_eval(live_model):
        predictor.load_weights(full_state_dict(live_model))
        counts = ((0, 0, 0) if indices == [] else
                  evaluate_det_counts(predictor, dataset, indices=indices))
        if sharded:
            counts = global_eval_reduce(*counts, 0.0, 0)[:3]
        return prf1(*counts)

    return det_eval


def _train(args, config):
    from yolo_from_scratch_tpu_torch.parallel.distributed import (
        host_barrier,
        host_names,
    )
    from yolo_from_scratch_tpu_torch.train.loop import (
        fit,
        restore_train_state,
    )
    from yolo_from_scratch_tpu_torch.train.steps import (
        chunk_path,
        create_train_state,
        make_eval_step,
        make_train_step,
        make_train_step_multi_compact,
        make_train_step_multi_pool,
    )

    device = _device(args.device)
    mesh = None
    if args.data_parallel:
        mesh, rc = _run_mesh(args, device)
        if mesh is None:
            return rc
        device = mesh.device
    dtype = args.dtype
    if dtype == "auto":
        dtype = auto_fast_layout(device.type)["compute_dtype"]
    state = resume_ema = save_path = None
    start_epoch = 0
    if args.resume:
        # the checkpoint's config governs the model, the loss and the data
        state, cfg, start_epoch, resume_ema = restore_train_state(
            args.resume, args.lr, device=device,
            weight_decay=args.weight_decay, compute_dtype=dtype, mesh=mesh,
            layout=args.layout)
        save_path = args.resume
        print(f"Resuming from {args.resume} at epoch {start_epoch + 1}")
        for flag, passed, kept, shown in (
                ("--size", YOLO_SIZES[args.size]["width_mult"],
                 cfg.width_mult, args.size),
                ("--img-size", args.img_size, cfg.img_size, args.img_size),
                ("--head", args.head, cfg.head_type, args.head)):
            if passed != kept:
                print(f"WARNING: {flag} {shown!r} ignored on --resume; "
                      f"checkpoint uses {kept!r}")
    else:
        cfg = YoloConfig.from_size(args.size,
                                   num_classes=config.get("nc", 1),
                                   img_size=args.img_size,
                                   compute_dtype=dtype, head_type=args.head,
                                   **args.layout)
    dense = not args.compact_targets
    if _spatial_refused(args, cfg, dense):
        return 1
    sizes = multi_scale_sizes(cfg.img_size) if args.multi_scale else []
    for size in sizes:
        if _spatial_refused(args, cfg.with_(img_size=size), dense,
                            f" of the --multi-scale bucket {size}"):
            return 1
    if args.stream:
        # the JAX CLI streams over one host's chips only: here, the ranks
        # of one host (one all_gather_object of the host names)
        hosts = host_names() if args.distributed else []
        for flag, bad in (("--augment", args.augment), ("--ema", args.ema),
                          ("--multi-scale", args.multi_scale),
                          ("--distributed", len(set(hosts)) > 1)):
            if bad:
                print(f"ERROR: --stream does not compose with {flag}; use "
                      f"--device-augment/--device-mosaic for augmentation "
                      f"on the stream path")
                return 1
    elif args.stream_pool or args.cache_dir:
        print("ERROR: --stream-pool/--cache-dir require --stream")
        return 1
    if args.compact_targets and args.augment:
        print("ERROR: --compact-targets streams raw labels — host-side "
              "--augment (mosaic) is unsupported; use --device-augment / "
              "--device-mosaic instead")
        return 1
    if args.device_mosaic and not args.compact_targets:
        print("ERROR: --device-mosaic requires --compact-targets "
              "(it transforms raw labels, not dense maps)")
        return 1
    if args.sparse_loss and not args.compact_targets:
        print("ERROR: --sparse-loss requires --compact-targets "
              "(it gathers from raw labels, not dense maps)")
        return 1
    if args.sparse_loss and cfg.head_type == "anchor_free":
        print("NOTE: --sparse-loss ignored (anchor-free TAL is "
              "already dense-transport-free)")
    if state is None:
        state = create_train_state(cfg, args.lr, seed=args.seed,
                                   device=device,
                                   weight_decay=args.weight_decay, mesh=mesh)
    if mesh is not None and mesh.n_model > 1:
        from yolo_from_scratch_tpu_torch.parallel.tensor import (
            sharded_fraction,
        )

        print(f"Model-parallel: {sharded_fraction(state.model):.0%} of "
              f"params channel-sharded {mesh.n_model}-way")
    # several processes: each data shard loads its strided slice of every
    # epoch permutation (identical shuffle seed on every rank keeps the
    # slices disjoint, and a space group's ranks on the same images, drawn
    # alike by --augment); --batch-size is per data shard. The val slices
    # are not padded: no collective spans the data shards in evaluation
    shard = _data_shard(mesh)
    # both heads build their eval targets on the device from compact
    # labels (anchor: data/assign_device.py; anchor-free:
    # models/anchor_free.py::assign_targets_anchor_free_device_batch)
    train_loader = _loader(config, "train", cfg, args.batch_size,
                           shuffle=True, seed=args.seed,
                           compact=args.compact_targets,
                           augment=args.augment, process_shard=shard)
    val_loader = _loader(config, "val", cfg, args.batch_size,
                         compact=args.compact_targets, process_shard=shard,
                         pad_shard=False)
    if len(train_loader.dataset) == 0:
        print(f"ERROR: no images found in {config['train']} "
              f"(expected *.jpg / *.jpeg / *.png)")
        return 1
    print("Training YOLO model")
    print(f"Number of classes: {cfg.num_classes}")
    print(f"Training images: {len(train_loader.dataset)}")
    print(f"Validation images: {len(val_loader.dataset)}")
    print(f"Device: {device.type}")
    print("\nLearning Rate Schedule:")
    print(f"  Initial LR: {args.lr}")
    print(f"  Minimum LR: {args.min_lr}")
    print(f"  Warmup epochs: {args.warmup_epochs}")
    print(f"  Total epochs: {args.epochs}")
    det_eval = (_det_eval(cfg, state.model, val_loader.dataset, device,
                          mesh) if args.val_det else None)
    step_kw = dict(device_augment=args.device_augment,
                   augment_seed=args.seed,
                   compact_targets=bool(args.compact_targets),
                   device_mosaic=args.device_mosaic,
                   sparse_loss=args.sparse_loss)
    train_step = make_train_step(cfg, args.reference_quirks, device,
                                 mesh=mesh, **step_kw)
    eval_step = make_eval_step(cfg, quirk_640=args.reference_quirks,
                               device=device,
                               compact_targets=bool(args.compact_targets),
                               mesh=mesh)
    stream = None
    if args.stream:
        from yolo_from_scratch_tpu_torch.data.cache import ensure_cache
        from yolo_from_scratch_tpu_torch.data.stream import (
            ChunkStream,
            PoolStream,
        )

        # without --compact-targets: K=64 for the cache, a dense val
        # loader; process 0 writes the one cache, the others open it after
        cache = ensure_cache(train_loader.dataset,
                             capacity=args.compact_targets or 64,
                             packed=cfg.packed_stem,
                             cache_dir=args.cache_dir,
                             rank=mesh.rank if mesh else 0,
                             wait=host_barrier())
        multi = dict(device_augment=args.device_augment,
                     augment_seed=args.seed, device_mosaic=args.device_mosaic,
                     sparse_loss=args.sparse_loss)
        if args.stream_pool:
            stream = PoolStream(cache, pool_size=args.stream_pool,
                                batch_size=args.batch_size,
                                steps_per_chunk=args.stream_chunk,
                                seed=args.seed, device=device)
            train_step = make_train_step_multi_pool(
                cfg, args.reference_quirks, device, **multi)
            print(f"Streaming from cache ({len(cache)} images) via a "
                  f"{stream.pool_size}-image HBM pool, {args.stream_chunk} "
                  f"steps/dispatch")
        else:
            # --batch-size a process: every rank walks one permutation in
            # global steps of batch x world and takes its columns
            stream = ChunkStream(cache, batch_size=args.batch_size,
                                 steps_per_chunk=args.stream_chunk,
                                 shuffle=True, seed=args.seed, device=device,
                                 process_shard=_data_shard(mesh))
            train_step = make_train_step_multi_compact(
                cfg, args.reference_quirks, device, mesh=mesh, **multi)
            print(f"Streaming from cache ({len(cache)} images), "
                  f"double-buffered chunks of {args.stream_chunk} steps; "
                  f"chunks: {chunk_path(device, mesh)}")
    multi_scale = None
    if args.multi_scale:
        # one step and loader a bucket; the model is fully convolutional,
        # so the one state serves every size; each bucket's loader is
        # sharded as the main one, its step made for the mesh
        print(f"Multi-scale buckets: {sizes} (epoch-rotated)")
        multi_scale = []
        for size in sizes:
            if size == cfg.img_size:
                multi_scale.append((train_step, train_loader))
                continue
            cfg_s = cfg.with_(img_size=size)
            multi_scale.append((
                make_train_step(cfg_s, args.reference_quirks, device,
                                mesh=mesh, **step_kw),
                _loader(config, "train", cfg_s, args.batch_size,
                        shuffle=True, seed=args.seed,
                        compact=args.compact_targets,
                        augment=args.augment, process_shard=shard)))
    state, save_path = fit(
        state, train_step, eval_step,
        train_loader, val_loader, cfg, device=device, epochs=args.epochs,
        initial_lr=args.lr, min_lr=args.min_lr,
        warmup_epochs=args.warmup_epochs, metrics_path=args.metrics_jsonl,
        det_eval=det_eval, stream=stream, start_epoch=start_epoch,
        save_path=save_path, use_ema=args.ema, ema_decay=EMA_DECAY,
        initial_ema=resume_ema, multi_scale=multi_scale, mesh=mesh)
    print(f"\nTraining complete. Model saved to {save_path}")
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    names = {arg.split("=", 1)[0] for arg in argv}
    axes = [f for f in STREAM_EXCLUSIVE if f in names]
    if axes and "--stream" in names:
        print(f"ERROR: --stream does not compose with {axes[0]}; use "
              f"--device-augment/--device-mosaic for augmentation on the "
              f"stream path")
        return 1
    args = build_parser().parse_args(argv)
    rc = _resolve_packing(args)
    if rc is not None:
        return rc
    if not args.distributed:
        return _run(args)
    # before any mode: afterwards the group spans every process
    from yolo_from_scratch_tpu_torch.parallel.distributed import (
        init_distributed,
        shutdown,
    )

    try:
        pi, pc = init_distributed(args.coordinator, args.num_processes,
                                  args.process_id, device=args.device)
    except ValueError as e:
        print(f"ERROR: {e}")
        return 1
    import torch.distributed as dist

    print(f"Distributed: process {pi}/{pc}, backend {dist.get_backend()}")
    args.data_parallel = True
    try:
        return _run(args)
    finally:
        shutdown()


def _run(args):
    """main() after the flags are parsed (and the process group made)."""
    if args.img_size % 32 != 0:
        print(f"ERROR: --img-size must be divisible by 32, got "
              f"{args.img_size}")
        return 1
    yaml_file = next((a for a in args.files if a.endswith(YAML_EXTS)), None)
    ckpt_file = next((a for a in args.files if a.endswith(CKPT_EXTS)), None)
    image_file = next((a for a in args.files if a.endswith(IMG_EXTS)), None)
    artifact_file = next((a for a in args.files if a.endswith(ART_EXTS)),
                         None)
    if args.compute_anchors:
        return _compute_anchors(args, yaml_file)
    others = [a for a in args.files
              if a not in (yaml_file, ckpt_file, image_file, artifact_file)]

    if others or not (yaml_file or ckpt_file or artifact_file):
        print("This mode is not ported yet: the PyTorch port runs training "
              "(data.yaml), evaluation (data.yaml model.ckpt), inference "
              "(image.jpg model.ckpt), inspect (model.ckpt), export "
              "(model.ckpt --export out.yexp), the artifact modes "
              "(model.yexp, image.jpg model.yexp) and --compute-anchors "
              "(data.yaml). Use `python train.py` for the other modes.")
        return 2
    if artifact_file:
        _artifact(artifact_file, image_file)
        return 0
    if ckpt_file and args.export:
        from yolo_from_scratch_tpu_torch.utils.yaml_cfg import (
            load_dataset_yaml,
        )

        size_cfg = YOLO_SIZES[args.size]
        print(f"Creating YOLOv5{args.size.upper()} "
              f"(width={size_cfg['width_mult']}, "
              f"depth={size_cfg['depth_mult']})")
        return _export(args, load_dataset_yaml(yaml_file) if yaml_file
                       else None, ckpt_file)
    if ckpt_file and not yaml_file and not image_file:
        _inspect(ckpt_file)
        return 0
    if image_file and ckpt_file and not yaml_file:
        _infer(args, image_file, ckpt_file)
        return 0
    if yaml_file and not image_file:
        from yolo_from_scratch_tpu_torch.utils.yaml_cfg import (
            load_dataset_yaml,
        )

        # the JAX CLI's rules of the secondary mesh axes (training and
        # evaluation; inference ignores the flags)
        if not args.data_parallel and (args.spatial > 1
                                       or args.model_parallel > 1):
            print("ERROR: --spatial/--model-parallel require --data-parallel "
                  "(they are secondary mesh axes)")
            return 1
        if args.spatial > 1 and args.model_parallel > 1:
            print("ERROR: --spatial and --model-parallel are mutually "
                  "exclusive (pick one secondary mesh axis)")
            return 1
        config = load_dataset_yaml(yaml_file)
        size_cfg = YOLO_SIZES[args.size]
        print(f"Creating YOLOv5{args.size.upper()} "
              f"(width={size_cfg['width_mult']}, "
              f"depth={size_cfg['depth_mult']})")
        if ckpt_file:
            return _evaluate(args, config, ckpt_file)
        return _train(args, config)
    print("This mode is not ported yet: use `python train.py` for it.")
    return 2


if __name__ == "__main__":
    sys.exit(main())
