"""K-means anchor optimization (counterpart of
`yolo_from_scratch_tpu/utils/anchors.py`; reference: train.py:1252-1343).

Lloyd's algorithm as tensor ops on the device given: k-means++ seeding from
an explicit seeded `torch.Generator` on that device, `n_init` restarts,
the best by inertia. The output contract is the reference's: 9 centers
sorted by area, split 3/3/3 into P3/P4/P5, rounded to ints, with the same
stdout lines as the JAX package.

The JAX package seeds from `jax.random.PRNGKey(seed)`, whose stream torch
cannot replay, so the two packages start from different centers. Lloyd's
iterations from the same centers agree (argmin ties to the first index,
empty clusters stay where they were), and on well-separated clusters both
converge to the same rounded anchors.
"""

from __future__ import annotations

import glob
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from yolo_from_scratch_tpu_torch.device import tf32_disabled
from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml


def _sq_dists(points, centers):
    """(N, K) squared distances of (N, D) points to (K, D) centers."""
    return ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)


def _kmeans_plus_plus_init(generator, points, k):
    """k-means++ seeding: the first center uniform, each next one drawn
    with probability proportional to the squared distance to the nearest
    center so far (inverse CDF, as `jax.random.choice(p=...)` draws).
    `generator` is a seeded `torch.Generator` on `points`' device."""
    n = points.shape[0]
    device = points.device
    first = torch.randint(n, (1,), generator=generator, device=device)
    centers = points[first].repeat(k, 1)
    for i in range(1, k):
        d2 = _sq_dists(points, centers[:i]).amin(dim=1)
        probs = d2 / torch.clamp(d2.sum(), min=1e-12)
        cum = torch.cumsum(probs, dim=0)
        u = torch.rand((1,), generator=generator, device=device)
        idx = torch.searchsorted(cum, cum[-1:] * (1 - u))
        centers[i] = points[idx.clamp(max=n - 1)][0]
    return centers


def _lloyd(points, centers, iters=50):
    """`iters` Lloyd steps from `centers`: argmin assignment (ties to the
    first index), each center the mean of its points, an empty cluster
    left where it was. Returns (centers, inertia)."""
    k = centers.shape[0]
    with tf32_disabled():
        for _ in range(iters):
            assign = _sq_dists(points, centers).argmin(dim=1)
            onehot = F.one_hot(assign, k).to(points.dtype)
            members = onehot.sum(0)
            means = (onehot.T @ points) / torch.clamp(members, min=1.0)[:, None]
            centers = torch.where((members > 0)[:, None], means, centers)
    inertia = _sq_dists(points, centers).amin(dim=1).sum()
    return centers, inertia


def kmeans(points: np.ndarray, k: int, n_init: int = 10, iters: int = 50,
           seed: int = 0, *, device) -> np.ndarray:
    """Best-of-`n_init` k-means on `device`. Returns (k, dim) float32
    centers; the same seed on the same device gives the same centers."""
    device = torch.device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    runs = [_lloyd(pts, _kmeans_plus_plus_init(generator, pts, k), iters)
            for _ in range(n_init)]
    inertias = torch.stack([inertia for _, inertia in runs])
    best = int(inertias.argmin())
    return runs[best][0].cpu().numpy()


def collect_dataset_wh(dataset_yaml, img_size=640):
    """All GT (w, h) in pixels at img_size from the train split's labels
    (reference: train.py:1277-1299, incl. the images->labels dir mapping)."""
    config = load_dataset_yaml(dataset_yaml)
    img_dir = config["train"]
    label_dir = img_dir.replace("/images/", "/labels/").replace("/images", "/labels")
    label_files = sorted(glob.glob(f"{label_dir}/*.txt"))

    boxes = []
    for label_file in label_files:
        if Path(label_file).exists():
            with open(label_file, encoding="utf-8") as f:
                for line in f:
                    parts = line.strip().split()
                    if len(parts) == 5:
                        boxes.append(
                            [float(parts[3]) * img_size, float(parts[4]) * img_size]
                        )
    return np.asarray(boxes, np.float32), label_files


def compute_optimal_anchors(dataset_yaml, img_size=640, num_anchors=9, *,
                            device):
    """K-means anchors on `device`; prints the reference-format
    recommendation and returns [anchors_p3, anchors_p4, anchors_p5] (or
    None if no boxes)."""
    all_boxes, label_files = collect_dataset_wh(dataset_yaml, img_size)
    if len(all_boxes) == 0:
        config = load_dataset_yaml(dataset_yaml)
        img_dir = config["train"]
        label_dir = img_dir.replace("/images/", "/labels/").replace(
            "/images", "/labels"
        )
        print(f"ERROR: No boxes found in {label_dir}")
        return None

    print(f"Loaded {len(all_boxes)} boxes from {len(label_files)} images")
    print(
        f"Box size range: width [{all_boxes[:, 0].min():.1f}, "
        f"{all_boxes[:, 0].max():.1f}], height [{all_boxes[:, 1].min():.1f}, "
        f"{all_boxes[:, 1].max():.1f}]"
    )

    print(f"\nRunning k-means clustering with k={num_anchors}...")
    centers = kmeans(all_boxes, num_anchors, device=device)
    centers = centers[np.argsort(centers[:, 0] * centers[:, 1])]  # sort by area

    print("\nOptimal anchors (sorted by area):")
    for i, (w, h) in enumerate(centers):
        print(f"  Anchor {i+1}: [{w:.1f}, {h:.1f}] (area: {w * h:.0f})")

    anchors_p3 = centers[0:3].round().astype(int).tolist()
    anchors_p4 = centers[3:6].round().astype(int).tolist()
    anchors_p5 = centers[6:9].round().astype(int).tolist()

    print("\n" + "=" * 60)
    print("Recommended anchor configuration:")
    print("=" * 60)
    print(f"P3 (small objects):  {anchors_p3}")
    print(f"P4 (medium objects): {anchors_p4}")
    print(f"P5 (large objects):  {anchors_p5}")
    print("\nTo use these anchors, pass them to the model and dataset:")
    print(f"  anchors = [{anchors_p3}, {anchors_p4}, {anchors_p5}]")
    print("=" * 60)

    return [anchors_p3, anchors_p4, anchors_p5]
