"""Synthetic detection datasets (a copy of
`yolo_from_scratch_tpu/utils/synth.py`: importing the JAX package's
`utils` loads flax).

Color mode: orange cone-colored boxes (one colour a class) on noisy gray
backgrounds, 1-3 objects per image, YOLO-format labels. Shape mode
(`class_mode="shape"`): the class is a shape x texture pair with a random
colour per instance, up to 80 classes, with optional unlabeled distractors
(`n_distract`). The same seed writes the same files as the JAX package's
generator, in either mode.

    python -m yolo_from_scratch_tpu_torch.utils.synth /tmp/cones \\
        --train 128 --val 24 --img-size 640 --seed 0 [--class-mode shape]
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


N_SHAPES, N_TEXTURES = 8, 10


def _shape_mask(shape_id: int, h: int, w: int) -> np.ndarray:
    """Boolean footprint of shape family `shape_id` on an h x w patch."""
    yy, xx = np.mgrid[0:h, 0:w]
    u = (xx + 0.5) / w * 2 - 1  # [-1, 1]
    v = (yy + 0.5) / h * 2 - 1
    if shape_id == 0:       # filled rectangle
        return np.ones((h, w), bool)
    if shape_id == 1:       # ellipse
        return u * u + v * v <= 1.0
    if shape_id == 2:       # triangle (point up)
        return (v >= -1) & (np.abs(u) <= (v + 1) / 2)
    if shape_id == 3:       # diamond
        return np.abs(u) + np.abs(v) <= 1.0
    if shape_id == 4:       # plus
        return (np.abs(u) <= 0.34) | (np.abs(v) <= 0.34)
    if shape_id == 5:       # ring
        r2 = u * u + v * v
        return (r2 <= 1.0) & (r2 >= 0.30)
    if shape_id == 6:       # hollow rectangle (frame)
        return (np.abs(u) >= 0.48) | (np.abs(v) >= 0.48)
    # 7: X (two diagonal bars)
    return (np.abs(u - v) <= 0.40) | (np.abs(u + v) <= 0.40)


def _texture_mask(tex_id: int, h: int, w: int, phase: int = 0) -> np.ndarray:
    """Boolean two-tone pattern of texture family `tex_id` (True = primary
    tone). `phase` shifts periodic patterns so texture is not tied to a
    pixel position."""
    yy, xx = np.mgrid[0:h, 0:w]
    ph = max(4, h // 6)
    pw = max(4, w // 6)
    if tex_id == 0:         # solid
        return np.ones((h, w), bool)
    if tex_id == 1:         # horizontal stripes
        return ((yy + phase) // ph) % 2 == 0
    if tex_id == 2:         # vertical stripes
        return ((xx + phase) // pw) % 2 == 0
    if tex_id == 3:         # checker
        return (((yy + phase) // ph) + ((xx + phase) // pw)) % 2 == 0
    if tex_id == 4:         # dots (secondary-tone dots on primary)
        return ~((((yy + phase) % ph) < ph // 2)
                 & (((xx + phase) % pw) < pw // 2))
    if tex_id == 5:         # diagonal stripes
        return ((xx + yy + phase) // pw) % 2 == 0
    if tex_id == 6:         # grid lines
        return (((yy + phase) % ph) >= ph // 3) \
            & (((xx + phase) % pw) >= pw // 3)
    if tex_id == 7:         # horizontal half split
        return yy < h // 2
    if tex_id == 8:         # vertical half split
        return xx < w // 2
    # 9: border band (primary interior, secondary margin)
    my, mx = max(1, h // 5), max(1, w // 5)
    return (yy >= my) & (yy < h - my) & (xx >= mx) & (xx < w - mx)


def render_class_patch(c: int, h: int, w: int, color, rng=None):
    """Shape/texture-coded class rendering: class identity is
    (shape = c % N_SHAPES, texture = c // N_SHAPES), COLOR-INVARIANT —
    `color` is the per-instance primary tone (secondary = 0.40x), so
    photometric augmentation cannot erase class information. Returns
    (patch float32 (h, w, 3), footprint bool (h, w))."""
    shape = _shape_mask(c % N_SHAPES, h, w)
    phase = int(rng.integers(0, max(h, w))) if rng is not None else 0
    tex = _texture_mask((c // N_SHAPES) % N_TEXTURES, h, w, phase)
    c1 = np.asarray(color, np.float32)
    c2 = c1 * 0.40
    patch = np.where(tex[..., None], c1, c2)
    return patch, shape


def make_image(rng, img_size, n_min=1, n_max=3, num_classes=1,
               box_range=(0.08, 0.35), class_mode="color",
               n_distract=0):
    """One synthetic image + its YOLO label rows [(cls, cx, cy, w, h)].

    `n_distract` (shape mode, num_classes < N_SHAPES*N_TEXTURES only):
    up to that many UNLABELED distractor objects per image, drawn from
    shape x texture combos outside the class set — true hard negatives
    (some share a class's shape with a different texture and vice
    versa), so detection stops being "any blob on gray background" and
    the saturated single-class regimes get a discriminative
    axis that isn't classification."""
    img = np.clip(
        rng.normal(BG_GRAY, 12, (img_size, img_size, 3)), 0, 255
    ).astype(np.uint8)
    rows = []
    placed = []  # pixel boxes already drawn, for overlap rejection
    lo, hi = box_range
    n_obj = int(rng.integers(n_min, n_max + 1))
    n_neg = int(rng.integers(0, n_distract + 1)) if n_distract else 0
    if n_distract:
        if class_mode != "shape":
            raise ValueError("distractors require class_mode='shape' "
                             "(color mode has no negative combos)")
        if num_classes >= N_SHAPES * N_TEXTURES:
            raise ValueError("no free shape x texture combos left for "
                             "distractors")
    for i in range(n_obj + n_neg):
        distract = i >= n_obj
        c = (int(rng.integers(num_classes, N_SHAPES * N_TEXTURES))
             if distract else int(rng.integers(0, num_classes)))
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
            # reject placements overlapping an earlier box: later draws
            # would overwrite its pixels and leave an invisible GT that
            # caps recall by construction
            if any(x1 < px2 and px1 < x2 and y1 < py2 and py1 < y2
                   for px1, py1, px2, py2 in placed):
                continue
            if class_mode == "shape":
                # class-coded structure, random per-instance colour: the
                # only class signal is shape/texture, so photometric
                # augmentation cannot leak labels
                color = rng.uniform(90, 255, 3)
                patch, mask = render_class_patch(
                    c, y2 - y1, x2 - x1, color, rng)
                patch = patch + rng.normal(0, 10, patch.shape)
                region = img[y1:y2, x1:x2]
                img[y1:y2, x1:x2] = np.where(
                    mask[..., None],
                    np.clip(patch, 0, 255).astype(np.uint8), region)
            else:
                block = np.asarray(class_color(c), np.float32) + rng.normal(
                    0, 10, (y2 - y1, x2 - x1, 3)
                )
                img[y1:y2, x1:x2] = np.clip(block, 0, 255).astype(np.uint8)
            placed.append((x1, y1, x2, y2))
            if not distract:
                rows.append((c, cx, cy, w, h))
            break
    return img, rows


def make_dataset(root, n_train=128, n_val=24, img_size=640, seed=0,
                 num_classes=1, n_min=1, n_max=3, box_range=(0.08, 0.35),
                 class_mode="color", n_distract=0):
    """Write the dataset + dataset.yaml. Returns the yaml path.

    `num_classes` > 1 draws each box's class uniformly with a distinct
    color; `box_range` in image fractions sets the object scale (a
    small-object regime uses e.g. (0.015, 0.06)).
    `class_mode="shape"` encodes class identity as shape x texture with
    random per-instance colors (color-invariant: supports up to
    N_SHAPES * N_TEXTURES = 80 classes). `n_distract`: up to that many
    unlabeled out-of-class-set hard negatives per image (shape mode;
    see make_image).
    """
    if class_mode == "shape" and num_classes > N_SHAPES * N_TEXTURES:
        raise ValueError(
            f"shape mode encodes at most {N_SHAPES * N_TEXTURES} classes")
    import yaml
    from PIL import Image

    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / split / "images").mkdir(parents=True, exist_ok=True)
        (root / split / "labels").mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img, rows = make_image(rng, img_size, n_min, n_max, num_classes,
                                   box_range, class_mode,
                                   n_distract=n_distract)
            Image.fromarray(img).save(
                root / split / "images" / f"{i:04d}.jpg", quality=92
            )
            (root / split / "labels" / f"{i:04d}.txt").write_text(
                "".join(f"{c} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}\n"
                        for c, cx, cy, w, h in rows)
            )
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
    ap.add_argument("--class-mode", default="color",
                    choices=("color", "shape"))
    a = ap.parse_args()
    path = make_dataset(a.root, a.train, a.val, a.img_size, a.seed,
                        num_classes=a.nc, class_mode=a.class_mode)
    print(f"wrote {path}")
