"""Synthetic "cone" detection dataset, color mode (a copy of
`yolo_from_scratch_tpu/utils/synth.py::make_dataset` with
`class_mode="color"`: importing the JAX package's `utils` loads flax).

Orange cone-colored boxes on noisy gray backgrounds, 1-3 objects per image,
YOLO-format labels; the same seed writes the same files as the JAX
package's generator.

    python -m yolo_from_scratch_tpu_torch.utils.synth /tmp/cones \\
        --train 128 --val 24 --img-size 640 --seed 0
"""

from __future__ import annotations

import colorsys
from pathlib import Path

import numpy as np

CONE_COLOR = (230, 110, 32)
BG_GRAY = 87


def class_color(c: int):
    """Distinct color per class id on an HSV grid (class 0 is the cone
    orange)."""
    if c == 0:
        return CONE_COLOR
    hue = ((c % 20) / 20.0 + 0.025) % 1.0
    sat, val = ((1.0, 1.0), (1.0, 0.55), (0.50, 1.0), (1.0, 0.78))[
        (c // 20) % 4]
    r, g, b = colorsys.hsv_to_rgb(hue, sat, val)
    return (int(r * 255), int(g * 255), int(b * 255))


def make_image(rng, img_size, n_min=1, n_max=3, num_classes=1,
               box_range=(0.08, 0.35)):
    """One image + its label rows [(cls, cx, cy, w, h)]: colored blocks at
    non-overlapping random places."""
    img = np.clip(rng.normal(BG_GRAY, 12, (img_size, img_size, 3)), 0,
                  255).astype(np.uint8)
    rows, placed = [], []
    lo, hi = box_range
    for _ in range(int(rng.integers(n_min, n_max + 1))):
        c = int(rng.integers(0, num_classes))
        for _attempt in range(20):
            w = rng.uniform(lo, hi)
            h = rng.uniform(lo, hi)
            cx = rng.uniform(w / 2, 1 - w / 2)
            cy = rng.uniform(h / 2, 1 - h / 2)
            x1 = int((cx - w / 2) * img_size)
            y1 = int((cy - h / 2) * img_size)
            x2 = int((cx + w / 2) * img_size)
            y2 = int((cy + h / 2) * img_size)
            if x2 <= x1 or y2 <= y1:
                continue  # sub-pixel box at this resolution
            if any(x1 < px2 and px1 < x2 and y1 < py2 and py1 < y2
                   for px1, py1, px2, py2 in placed):
                continue  # an overlap would hide an earlier box
            block = np.asarray(class_color(c), np.float32) + rng.normal(
                0, 10, (y2 - y1, x2 - x1, 3))
            img[y1:y2, x1:x2] = np.clip(block, 0, 255).astype(np.uint8)
            placed.append((x1, y1, x2, y2))
            rows.append((c, cx, cy, w, h))
            break
    return img, rows


def make_dataset(root, n_train=128, n_val=24, img_size=640, seed=0,
                 num_classes=1, n_min=1, n_max=3, box_range=(0.08, 0.35)):
    """Write train/ and val/ splits (JPEG images, YOLO labels) and
    data.yaml under `root`. Returns the yaml path."""
    import yaml
    from PIL import Image

    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / split / "images").mkdir(parents=True, exist_ok=True)
        (root / split / "labels").mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img, rows = make_image(rng, img_size, n_min, n_max, num_classes,
                                   box_range)
            Image.fromarray(img).save(
                root / split / "images" / f"{i:04d}.jpg", quality=92)
            (root / split / "labels" / f"{i:04d}.txt").write_text(
                "".join(f"{c} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}\n"
                        for c, cx, cy, w, h in rows))
    yaml_path = root / "data.yaml"
    names = (["cone"] if num_classes == 1
             else [f"class_{i}" for i in range(num_classes)])
    yaml_path.write_text(yaml.safe_dump({
        "nc": num_classes, "names": names,
        "train": str(root / "train" / "images"),
        "val": str(root / "val" / "images"),
    }))
    return yaml_path


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--train", type=int, default=128)
    ap.add_argument("--val", type=int, default=24)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nc", type=int, default=1)
    a = ap.parse_args()
    path = make_dataset(a.root, a.train, a.val, a.img_size, a.seed,
                        num_classes=a.nc)
    print(f"wrote {path}")
