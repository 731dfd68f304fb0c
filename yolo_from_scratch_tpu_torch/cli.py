"""Command line of the port (counterpart of `yolo_from_scratch_tpu/cli.py`),
dispatching on the positional files' extensions as the JAX CLI does.

  Training:        python -m yolo_from_scratch_tpu_torch data.yaml [OPTIONS]
  Evaluation:      python -m yolo_from_scratch_tpu_torch data.yaml model.ckpt
  Inference:       python -m yolo_from_scratch_tpu_torch image.jpg model.ckpt
  Inspect:         python -m yolo_from_scratch_tpu_torch model.ckpt
  Compute Anchors: python -m yolo_from_scratch_tpu_torch data.yaml \
                       --compute-anchors

(`python train_torch.py ...` is the same command line.) Each prints the
JAX CLI's stdout lines. Training runs either head (`--head anchor` or
`anchor_free`) with dense host targets, or with `--compact-targets [K]`
from compact labels expanded on the device (`--sparse-loss`,
`--device-mosaic`, `--device-augment [full|flip]`); `--weight-decay W`
makes the optimizer AdamW; `--stream` trains from a one-time on-disk cache
through the scanned trainers, N steps (`--stream-chunk`) a CUDA graph
replay, from double-buffered chunks or a device-resident pool
(`--stream-pool P`). Evaluation, inference and inspect take the
head from the checkpoint; `--dtype auto` is bfloat16 on the card and
float32 on the CPU.
`--val-det` adds the detection-level P/R/F1 to each epoch, `--map` adds
mAP to evaluation (both through `BatchPredictor`, one NMS launch a batch),
`--device-letterbox` resizes and pads on the device for inference and
`--map`. A JAX-CLI flag the port does not have yet exits with status 2
and names the flag, as does any other mode.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from yolo_from_scratch_tpu_torch.config import YOLO_SIZES, YoloConfig

CKPT_EXTS = (".ckpt", ".msgpack")
IMG_EXTS = (".jpg", ".png", ".jpeg")
YAML_EXTS = (".yaml", ".yml")

# JAX-CLI flags with no port yet
UNPORTED_FLAGS = (
    "--resume", "--ema", "--multi-scale", "--augment", "--data-parallel",
    "--spatial", "--model-parallel", "--distributed", "--coordinator",
    "--num-processes", "--process-id", "--int8", "--export",
    "--export-batch", "--export-platforms",
)
UNPORTED_PREFIXES = ("--packed",)
# the JAX CLI's flags that --stream refuses (exit 1, before "not ported")
STREAM_EXCLUSIVE = ("--augment", "--ema", "--multi-scale", "--distributed",
                    "--spatial", "--model-parallel")


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
    return parser


def _unported_flag(argv):
    for arg in argv:
        name = arg.split("=", 1)[0]
        if name in UNPORTED_FLAGS or name.startswith(UNPORTED_PREFIXES):
            return name
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
    print(f"Running inference on {image_file}")
    print(f"Model: {ckpt_file}, Classes: {cfg.num_classes}, "
          f"Image size: {cfg.img_size}")
    detections = Predictor(state_dict, cfg, device=device,
                           device_letterbox=args.device_letterbox)(image_file)
    if len(detections) == 0:
        print("No objects detected.")
    else:
        print(f"\nDetected {len(detections)} object(s):")
        for i, (x1, y1, x2, y2, conf, class_id) in enumerate(detections):
            print(f"  {i + 1}. Box: ({x1:.1f}, {y1:.1f}, {x2:.1f}, "
                  f"{y2:.1f}), Confidence: {conf:.3f}, "
                  f"Class: {int(class_id)}")


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
            compact=0):
    from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset

    return DataLoader(YoloDataset(config[split], cfg.num_classes,
                                  cfg.anchors_array, cfg.img_size,
                                  head_type=cfg.head_type),
                      batch_size=batch_size, shuffle=shuffle, seed=seed,
                      compact=compact)


def _evaluate(args, config, ckpt_file):
    from yolo_from_scratch_tpu_torch.models.yolo import YOLO
    from yolo_from_scratch_tpu_torch.train.loop import eval_epoch
    from yolo_from_scratch_tpu_torch.train.steps import make_eval_step
    from yolo_from_scratch_tpu_torch.utils.checkpoint import load_checkpoint

    device = _device(args.device)
    state_dict, cfg, _ = load_checkpoint(ckpt_file)
    if args.dtype != "auto":
        cfg = cfg.with_(compute_dtype=args.dtype)
    print(f"Evaluating model from {ckpt_file}")
    print(f"Number of classes: {cfg.num_classes}")
    print(f"Image size: {cfg.img_size}")
    print(f"Width multiplier: {cfg.width_mult}")
    print(f"Depth multiplier: {cfg.depth_mult}")
    model = YOLO(cfg)
    model.load_state_dict(state_dict)
    model.to(device)
    compact = args.compact_targets if cfg.head_type == "anchor" else 0
    if args.compact_targets and not compact:
        print("NOTE: --compact-targets ignored (anchor head only)")
    eval_step = make_eval_step(cfg, quirk_640=args.reference_quirks,
                               device=device, compact_targets=bool(compact))
    predictor = None
    if args.map:
        from yolo_from_scratch_tpu_torch.infer.predict import BatchPredictor

        # low threshold: mAP integrates the whole PR curve, so the
        # low-confidence tail must not be cut
        predictor = BatchPredictor(state_dict, cfg, conf_threshold=1e-3,
                                   max_outputs=300,
                                   device_letterbox=args.device_letterbox,
                                   device=device)
    for title, split in (("Training", "train"), ("Validation", "val")):
        loader = _loader(config, split, cfg, args.batch_size,
                         compact=compact)
        loss, p, r, f1 = eval_epoch(eval_step, model, loader, device)
        print(f"\n{title} Set:")
        print(f"  Loss: {loss:.4f}")
        print(f"  Precision: {p:.2f}%")
        print(f"  Recall: {r:.2f}%")
        print(f"  F1 Score: {f1:.2f}%")
        if predictor is not None:
            _print_map(predictor, loader.dataset, cfg, config)


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


def _det_eval(cfg, model, dataset, device):
    """fit()'s `det_eval`: one BatchPredictor at conf 0.5 with a model of
    its own, into which each epoch copies the live float32 master weights
    (the predictor casts its convs to the compute dtype; the training
    model's must stay float32)."""
    from yolo_from_scratch_tpu_torch.infer.predict import BatchPredictor
    from yolo_from_scratch_tpu_torch.train.map_eval import (
        evaluate_det_counts,
    )
    from yolo_from_scratch_tpu_torch.train.metrics import prf1

    predictor = BatchPredictor(model.state_dict(), cfg, conf_threshold=0.5,
                               device=device)

    def det_eval(live_model):
        predictor.load_weights(live_model.state_dict())
        return prf1(*evaluate_det_counts(predictor, dataset))

    return det_eval


def _train(args, config):
    from yolo_from_scratch_tpu_torch.train.loop import fit
    from yolo_from_scratch_tpu_torch.train.steps import (
        create_train_state,
        make_eval_step,
        make_train_step,
        make_train_step_multi_compact,
        make_train_step_multi_pool,
    )

    device = _device(args.device)
    dtype = args.dtype
    if dtype == "auto":
        dtype = "bfloat16" if device.type == "cuda" else "float32"
    cfg = YoloConfig.from_size(args.size,
                               num_classes=config.get("nc", 1),
                               img_size=args.img_size, compute_dtype=dtype,
                               head_type=args.head)
    if not args.stream and (args.stream_pool or args.cache_dir):
        print("ERROR: --stream-pool/--cache-dir require --stream")
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
    state = create_train_state(cfg, args.lr, seed=args.seed, device=device,
                               weight_decay=args.weight_decay)
    # both heads build their eval targets on the device from compact
    # labels (anchor: data/assign_device.py; anchor-free:
    # models/anchor_free.py::assign_targets_anchor_free_device_batch)
    train_loader = _loader(config, "train", cfg, args.batch_size,
                           shuffle=True, seed=args.seed,
                           compact=args.compact_targets)
    val_loader = _loader(config, "val", cfg, args.batch_size,
                         compact=args.compact_targets)
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
    det_eval = (_det_eval(cfg, state.model, val_loader.dataset, device)
                if args.val_det else None)
    train_step = make_train_step(
        cfg, args.reference_quirks, device,
        device_augment=args.device_augment, augment_seed=args.seed,
        compact_targets=bool(args.compact_targets),
        device_mosaic=args.device_mosaic, sparse_loss=args.sparse_loss)
    eval_step = make_eval_step(cfg, quirk_640=args.reference_quirks,
                               device=device,
                               compact_targets=bool(args.compact_targets))
    stream = None
    if args.stream:
        from yolo_from_scratch_tpu_torch.data.cache import ensure_cache
        from yolo_from_scratch_tpu_torch.data.stream import (
            ChunkStream,
            PoolStream,
        )

        # without --compact-targets: K=64 for the cache, a dense val loader
        cache = ensure_cache(train_loader.dataset,
                             capacity=args.compact_targets or 64,
                             cache_dir=args.cache_dir)
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
            stream = ChunkStream(cache, batch_size=args.batch_size,
                                 steps_per_chunk=args.stream_chunk,
                                 shuffle=True, seed=args.seed, device=device)
            train_step = make_train_step_multi_compact(
                cfg, args.reference_quirks, device, **multi)
            print(f"Streaming from cache ({len(cache)} images), "
                  f"double-buffered chunks of {args.stream_chunk} steps")
    state, save_path = fit(
        state, train_step, eval_step,
        train_loader, val_loader, cfg, device=device, epochs=args.epochs,
        initial_lr=args.lr, min_lr=args.min_lr,
        warmup_epochs=args.warmup_epochs, metrics_path=args.metrics_jsonl,
        det_eval=det_eval, stream=stream)
    print(f"\nTraining complete. Model saved to {save_path}")
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    flag = _unported_flag(argv)
    if flag in STREAM_EXCLUSIVE and "--stream" in argv:
        print(f"ERROR: --stream does not compose with {flag}; use "
              f"--device-augment/--device-mosaic for augmentation on the "
              f"stream path")
        return 1
    if flag:
        print(f"ERROR: {flag} is not ported yet; use `python train.py` "
              f"for it")
        return 2
    args = build_parser().parse_args(argv)
    if args.img_size % 32 != 0:
        print(f"ERROR: --img-size must be divisible by 32, got "
              f"{args.img_size}")
        return 1
    yaml_file = next((a for a in args.files if a.endswith(YAML_EXTS)), None)
    ckpt_file = next((a for a in args.files if a.endswith(CKPT_EXTS)), None)
    image_file = next((a for a in args.files if a.endswith(IMG_EXTS)), None)
    if args.compute_anchors:
        return _compute_anchors(args, yaml_file)
    others = [a for a in args.files
              if a not in (yaml_file, ckpt_file, image_file)]

    if others or not (yaml_file or ckpt_file):
        print("This mode is not ported yet: the PyTorch port runs training "
              "(data.yaml), evaluation (data.yaml model.ckpt), inference "
              "(image.jpg model.ckpt), inspect (model.ckpt) and "
              "--compute-anchors (data.yaml). Use `python train.py` for the "
              "other modes.")
        return 2
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

        config = load_dataset_yaml(yaml_file)
        size_cfg = YOLO_SIZES[args.size]
        print(f"Creating YOLOv5{args.size.upper()} "
              f"(width={size_cfg['width_mult']}, "
              f"depth={size_cfg['depth_mult']})")
        if ckpt_file:
            _evaluate(args, config, ckpt_file)
            return 0
        return _train(args, config)
    print("This mode is not ported yet: use `python train.py` for it.")
    return 2


if __name__ == "__main__":
    sys.exit(main())
