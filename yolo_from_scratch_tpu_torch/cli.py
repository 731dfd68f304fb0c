"""Command line of the port (counterpart of `yolo_from_scratch_tpu/cli.py`),
dispatching on the positional files' extensions as the JAX CLI does.

  Inference:  python -m yolo_from_scratch_tpu_torch image.jpg model.ckpt
  Inspect:    python -m yolo_from_scratch_tpu_torch model.ckpt

Both print the JAX CLI's stdout lines. Training, evaluation and the other
modes are not ported yet: they print so and exit with status 2.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

CKPT_EXTS = (".ckpt", ".msgpack")
IMG_EXTS = (".jpg", ".png", ".jpeg")


def build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m yolo_from_scratch_tpu_torch",
        description="YOLO inference (PyTorch + CUDA port)")
    parser.add_argument("files", nargs="*", help=".ckpt model and/or image")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="device to run on (default: cuda; no fallback)")
    parser.add_argument("--dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="conv compute dtype (default: the checkpoint's)")
    return parser


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


def main(argv=None):
    args = build_parser().parse_args(argv)
    ckpt_file = next((a for a in args.files if a.endswith(CKPT_EXTS)), None)
    image_file = next((a for a in args.files if a.endswith(IMG_EXTS)), None)
    others = [a for a in args.files if a not in (ckpt_file, image_file)]

    if ckpt_file and not image_file and not others:
        # ----- Inspect mode -----
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
        return 0

    if image_file and ckpt_file and not others:
        # ----- Inference mode -----
        from yolo_from_scratch_tpu_torch.infer.predict import Predictor
        from yolo_from_scratch_tpu_torch.utils.checkpoint import (
            load_checkpoint,
        )

        device = _device(args.device)
        state_dict, cfg, _ = load_checkpoint(ckpt_file)
        if args.dtype:
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
        return 0

    print("This mode is not ported yet: the PyTorch port runs inference "
          "(image.jpg model.ckpt) and inspect (model.ckpt). Use "
          "`python train.py` for training, evaluation and the other modes.")
    return 2


if __name__ == "__main__":
    sys.exit(main())
