#!/usr/bin/env python
"""Interactive detection viewer on the PyTorch port (counterpart of the
root `eval.py`, which runs the JAX package).

Usage: python eval_torch.py model.ckpt dataset.yaml [--device cpu]

Iterates train + val images, drawing ground truth (green) and model
predictions (red) with an info panel and keyboard navigation:
A/D or arrow keys to navigate, S to screenshot, Q/ESC to quit.

Host-side tooling: rendering stays on the CPU with OpenCV (imported only
where a frame is drawn or shown); inference runs through the port's
`Predictor`, on the card unless `--device cpu` is given. The drawing
functions are `eval.py`'s, pixel for pixel.
"""

from __future__ import annotations

import glob
import sys
from pathlib import Path

from yolo_from_scratch_tpu_torch.infer.predict import Predictor
from yolo_from_scratch_tpu_torch.utils.checkpoint import load_checkpoint
from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml

GT_COLOR = (0, 255, 0)  # green (BGR)
PRED_COLOR = (0, 0, 255)  # red


def load_ground_truth(label_path, img_w, img_h):
    """Parse YOLO label txt -> [(class_id, x1, y1, x2, y2) px]
    (reference: eval.py:11-27)."""
    boxes = []
    p = Path(label_path)
    if p.exists():
        with open(p, encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) == 5:
                    cls = int(float(parts[0]))
                    cx, cy, w, h = (float(v) for v in parts[1:])
                    x1 = (cx - w / 2) * img_w
                    y1 = (cy - h / 2) * img_h
                    x2 = (cx + w / 2) * img_w
                    y2 = (cy + h / 2) * img_h
                    boxes.append((cls, x1, y1, x2, y2))
    return boxes


def draw_boxes(img, gt_boxes, detections, names):
    """Draw GT (green) and predictions (red) (reference: eval.py:30-92)."""
    import cv2

    for cls, x1, y1, x2, y2 in gt_boxes:
        cv2.rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)), GT_COLOR, 2)
        label = names[cls] if cls < len(names) else str(cls)
        cv2.putText(img, f"GT: {label}", (int(x1), max(int(y1) - 5, 12)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, GT_COLOR, 1)
    for x1, y1, x2, y2, conf, cls in detections:
        cv2.rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)), PRED_COLOR, 2)
        label = names[int(cls)] if int(cls) < len(names) else str(int(cls))
        cv2.putText(img, f"{label} {conf:.2f}",
                    (int(x1), min(int(y2) + 15, img.shape[0] - 5)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, PRED_COLOR, 1)
    return img


PANEL_HEIGHT = 80
LEGEND_HEIGHT = 60
PANEL_BG = (40, 40, 40)


def compose_frame(img, gt_boxes, detections, names, idx, total, split,
                  filename):
    """Boxes + info panel (top) + GT/pred color legend (bottom)
    (reference: eval.py:176-212). Headless — returns the frame array."""
    import cv2
    import numpy as np

    img = draw_boxes(img, gt_boxes, detections, names)

    panel = np.zeros((PANEL_HEIGHT, img.shape[1], 3), np.uint8)
    panel[:] = PANEL_BG
    info_text = [
        f"Image {idx + 1}/{total} ({split} set)",
        f"File: {filename}",
        f"GT boxes: {len(gt_boxes)}, Predictions: {len(detections)}",
    ]
    y = 20
    for text in info_text:
        cv2.putText(panel, text, (10, y), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                    (255, 255, 255), 1)
        y += 25

    legend = np.zeros((LEGEND_HEIGHT, img.shape[1], 3), np.uint8)
    legend[:] = PANEL_BG
    cv2.rectangle(legend, (10, 15), (30, 35), GT_COLOR, 2)
    cv2.putText(legend, "Ground Truth", (40, 30), cv2.FONT_HERSHEY_SIMPLEX,
                0.6, GT_COLOR, 2)
    cv2.rectangle(legend, (200, 15), (220, 35), PRED_COLOR, 2)
    cv2.putText(legend, "Prediction", (230, 30), cv2.FONT_HERSHEY_SIMPLEX,
                0.6, PRED_COLOR, 2)

    return np.vstack([panel, img, legend])


def main():
    import cv2

    import torch

    from yolo_from_scratch_tpu_torch.device import cuda_device

    argv = sys.argv[1:]
    device = "cuda"
    if argv[-2:-1] == ["--device"] and argv[-1] in ("cuda", "cpu"):
        device, argv = argv[-1], argv[:-2]
    if len(argv) != 2:
        print("Usage: python eval_torch.py model.ckpt dataset.yaml "
              "[--device cpu]")
        sys.exit(1)
    ckpt_path, yaml_path = argv
    if yaml_path.endswith((".ckpt", ".msgpack")):
        ckpt_path, yaml_path = yaml_path, ckpt_path

    state_dict, cfg, meta = load_checkpoint(ckpt_path)
    config = load_dataset_yaml(yaml_path)
    names = config.get("names", [str(i) for i in range(cfg.num_classes)])
    print(f"Loaded model from {ckpt_path} (img_size={cfg.img_size}, "
          f"nc={cfg.num_classes})")

    predictor = Predictor(state_dict, cfg, conf_threshold=0.25,
                          iou_threshold=0.4,
                          device=(cuda_device() if device == "cuda"
                                  else torch.device("cpu")))

    images = []
    for split in ("train", "val"):
        d = config.get(split)
        if d:
            images += [
                (p, split)
                for p in sorted(glob.glob(f"{d}/*.jpg")
                                + glob.glob(f"{d}/*.png"))
            ]
    if not images:
        print("No images found in dataset")
        sys.exit(1)
    print(f"{len(images)} images; A/D or arrows to navigate, S screenshot, "
          f"Q quit")

    idx = 0
    while True:
        path, split = images[idx]
        img = cv2.imread(path)
        if img is None:  # unreadable/corrupt file: skip instead of crashing
            print(f"WARNING: could not read {path}, skipping")
            idx = (idx + 1) % len(images)
            continue
        h, w = img.shape[:2]
        label_path = Path(path).parent.parent / "labels" / f"{Path(path).stem}.txt"
        gt = load_ground_truth(label_path, w, h)
        dets = predictor(path)
        frame = compose_frame(img, gt, dets, names, idx, len(images), split,
                              Path(path).name)
        cv2.imshow("yolo-torch eval", frame)

        key = cv2.waitKey(0) & 0xFF
        if key in (ord("q"), 27):
            break
        elif key in (ord("d"), 83):  # next
            idx = (idx + 1) % len(images)
        elif key in (ord("a"), 81):  # prev
            idx = (idx - 1) % len(images)
        elif key == ord("s"):
            out = f"screenshot_{Path(path).stem}.png"
            cv2.imwrite(out, frame)
            print(f"Saved {out}")
    cv2.destroyAllWindows()


if __name__ == "__main__":
    main()
