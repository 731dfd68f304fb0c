"""Command line of the port (counterpart of `yolo_from_scratch_tpu/cli.py`),
dispatching on the positional files' extensions as the JAX CLI does.

  Training:   python -m yolo_from_scratch_tpu_torch data.yaml [OPTIONS]
  Evaluation: python -m yolo_from_scratch_tpu_torch data.yaml model.ckpt
  Inference:  python -m yolo_from_scratch_tpu_torch image.jpg model.ckpt
  Inspect:    python -m yolo_from_scratch_tpu_torch model.ckpt

Each prints the JAX CLI's stdout lines. Training runs the anchor head with
dense host targets; `--dtype auto` is bfloat16 on the card and float32 on
the CPU. A JAX-CLI flag the port does not have yet exits with status 2 and
names the flag, as does any other mode.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from yolo_from_scratch_tpu_torch.config import YOLO_SIZES, YoloConfig

CKPT_EXTS = (".ckpt", ".msgpack")
IMG_EXTS = (".jpg", ".png", ".jpeg")
YAML_EXTS = (".yaml", ".yml")

# JAX-CLI flags with no port yet (`--head anchor_free` is checked apart)
UNPORTED_FLAGS = (
    "--resume", "--ema", "--compact-targets", "--sparse-loss",
    "--multi-scale", "--augment", "--data-parallel", "--spatial",
    "--model-parallel", "--distributed", "--coordinator", "--num-processes",
    "--process-id", "--val-det", "--map", "--compute-anchors",
    "--weight-decay", "--cache-dir", "--int8", "--export", "--export-batch",
    "--export-platforms",
)
UNPORTED_PREFIXES = ("--stream", "--device-", "--packed")


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
                        help="detection head (only 'anchor' is ported)")
    parser.add_argument("--reference-quirks", action="store_true",
                        help="replicate the reference's 640-denominator "
                             "decode in loss/eval at non-640 resolutions")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--metrics-jsonl", default=None,
                        help="write per-epoch metrics to this JSONL file")
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
    detections = Predictor(state_dict, cfg, device=device)(image_file)
    if len(detections) == 0:
        print("No objects detected.")
    else:
        print(f"\nDetected {len(detections)} object(s):")
        for i, (x1, y1, x2, y2, conf, class_id) in enumerate(detections):
            print(f"  {i + 1}. Box: ({x1:.1f}, {y1:.1f}, {x2:.1f}, "
                  f"{y2:.1f}), Confidence: {conf:.3f}, "
                  f"Class: {int(class_id)}")


def _loader(config, split, cfg, batch_size, shuffle=False, seed=0):
    from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset

    return DataLoader(YoloDataset(config[split], cfg.num_classes,
                                  cfg.anchors_array, cfg.img_size),
                      batch_size=batch_size, shuffle=shuffle, seed=seed)


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
    eval_step = make_eval_step(cfg, quirk_640=args.reference_quirks,
                               device=device)
    for title, split in (("Training", "train"), ("Validation", "val")):
        loss, p, r, f1 = eval_epoch(
            eval_step, model, _loader(config, split, cfg, args.batch_size),
            device)
        print(f"\n{title} Set:")
        print(f"  Loss: {loss:.4f}")
        print(f"  Precision: {p:.2f}%")
        print(f"  Recall: {r:.2f}%")
        print(f"  F1 Score: {f1:.2f}%")


def _train(args, config):
    from yolo_from_scratch_tpu_torch.train.loop import fit
    from yolo_from_scratch_tpu_torch.train.steps import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    device = _device(args.device)
    dtype = args.dtype
    if dtype == "auto":
        dtype = "bfloat16" if device.type == "cuda" else "float32"
    cfg = YoloConfig.from_size(args.size,
                               num_classes=config.get("nc", 1),
                               img_size=args.img_size, compute_dtype=dtype)
    state = create_train_state(cfg, args.lr, seed=args.seed, device=device)
    train_loader = _loader(config, "train", cfg, args.batch_size,
                           shuffle=True, seed=args.seed)
    val_loader = _loader(config, "val", cfg, args.batch_size)
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
    state, save_path = fit(
        state, make_train_step(cfg, args.reference_quirks, device),
        make_eval_step(cfg, quirk_640=args.reference_quirks, device=device),
        train_loader, val_loader, cfg, device=device, epochs=args.epochs,
        initial_lr=args.lr, min_lr=args.min_lr,
        warmup_epochs=args.warmup_epochs, metrics_path=args.metrics_jsonl)
    print(f"\nTraining complete. Model saved to {save_path}")
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    flag = _unported_flag(argv)
    if flag:
        print(f"ERROR: {flag} is not ported yet; use `python train.py` "
              f"for it")
        return 2
    args = build_parser().parse_args(argv)
    if args.head != "anchor":
        print(f"ERROR: --head {args.head} is not ported yet; use "
              f"`python train.py` for it")
        return 2
    if args.img_size % 32 != 0:
        print(f"ERROR: --img-size must be divisible by 32, got "
              f"{args.img_size}")
        return 1
    yaml_file = next((a for a in args.files if a.endswith(YAML_EXTS)), None)
    ckpt_file = next((a for a in args.files if a.endswith(CKPT_EXTS)), None)
    image_file = next((a for a in args.files if a.endswith(IMG_EXTS)), None)
    others = [a for a in args.files
              if a not in (yaml_file, ckpt_file, image_file)]

    if others or not (yaml_file or ckpt_file):
        print("This mode is not ported yet: the PyTorch port runs training "
              "(data.yaml), evaluation (data.yaml model.ckpt), inference "
              "(image.jpg model.ckpt) and inspect (model.ckpt). Use "
              "`python train.py` for the other modes.")
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
