"""The numbers that decide `correct`, each held to the limit that the cell's
file gives it (`limits`), and how they are worked out.

Training, over the window's first chunk of N steps, the reference
following the program step by step from the same weights on the same
rows of the cache (`core/train.py::follow`):
- `rows_unmatched`: the chunk's images that are no row of the cache, or
  a row met twice; the reference follows only a chunk of distinct rows;
- `loss_gap`: |the chunk's mean loss - the reference's| / |reference|;
- `grad_diff`: over the chunk's steps, the largest median leaf's norm of
  the difference between the gradient Adam took (clipped) and the
  reference's at the same parameters, over the larger of the reference
  leaf's norm and the median leaf's;
- `grad_diff_mean`: the mean of the same over the steps;
- `grad_gap`: over the steps, the worst leaf's gap between the norms of
  the two gradients, over the same;
- `step_gap`: the worst leaf's gap of the norms of the parameters'
  change over the chunk, the program's against the reference's Adam
  driven by the program's own gradients, over the same.
The last three leave out the leaves whose reference gradient at the
first step is under a thousandth of the median leaf's: a conv bias
before train-mode BatchNorm has a gradient of nought, rounding aside,
and Adam moves it by the rounding alone.

Serving, over a sample of the window's calls drawn from the seed:
- `det_gap`: the mean over every detection served of its gap to the
  reference prediction that explains it best: for a prediction, the
  largest of 1 - IoU of the boxes (each widened by a pixel a side), the
  relative gap of the scores (the reference's score of the served
  class), and how far the served class's probability lies below the
  reference's best class there; a reference detection that has no
  served one beside it (a list shorter than the reference's) counts 1;
- `rank_gap`: the mean over images of the mean over ranks of the gap
  between the k-th best score served and the reference's k-th best
  detection, over the larger of the two (a missing one counts 1);
- `miss_share`: the share of the reference's `check_top` best detections
  of each image that have no served detection of their class with an
  IoU of 0.5 or more.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from portbench.reference.serve import iou_matrix


def _norms(tensors: dict) -> dict:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def leaf_gaps(prog: dict, ref: dict, keys=None) -> dict:
    """{leaf: |prog - ref| / max(ref, median(ref))} of norms."""
    keys = list(ref) if keys is None else list(keys)
    median = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in keys}


def diff_gaps(prog: dict, ref: dict, keys) -> dict:
    """{leaf: |prog - ref| (the norm of the difference of the two
    tensors) over max(|ref|, the median leaf's |ref|)}."""
    norms = _norms(ref)
    median = statistics.median(norms.values())
    return {k: float((prog[k].to(ref[k].device, ref[k].dtype)
                      - ref[k]).norm()) / max(norms[k], median, 1e-30)
            for k in keys}


def moved_leaves(grads: dict) -> list:
    """The leaves whose reference gradient is a thousandth of the median
    leaf's or more."""
    norms = _norms(grads)
    median = statistics.median(norms.values())
    return [k for k, g in norms.items() if g >= 1e-3 * median]


def grad_step(prog: dict, ref: dict, top: int = 2) -> dict:
    """One step's gradients compared: the median leaf's difference gap
    (`diff`), the worst leaf's gap of norms (`gap`), the leaves it was
    taken over (`moved`) and the `top` worst leaves (`worst`: leaf, size,
    gap, program and reference norms over the median leaf's, the share of
    elements whose sign differs)."""
    moved = moved_leaves(ref)
    ref_n = _norms(ref)
    gaps = leaf_gaps(_norms(prog), ref_n, moved)
    median = statistics.median(ref_n.values())
    worst = []
    for k in sorted(gaps, key=lambda k: -gaps[k])[:top]:
        a, b = prog[k].float().cpu(), ref[k].float().cpu()
        worst.append((k, a.numel(), gaps[k], float(a.norm()) / median,
                      ref_n[k] / median,
                      float((a.sign() != b.sign()).float().mean())))
    return {"diff": statistics.median(diff_gaps(prog, ref, moved).values()),
            "gap": max(gaps.values()), "moved": moved, "worst": worst}


def train_numbers(loss: float, ref_loss: float, steps: list, change: dict,
                  ref_change: dict) -> dict:
    """The training numbers from the chunk's mean losses, each step's
    `grad_step` and the parameters' changes."""
    moved = steps[0]["moved"]
    return {"loss_gap": abs(loss - ref_loss) / abs(ref_loss),
            "grad_diff": max(s["diff"] for s in steps),
            "grad_diff_mean": statistics.fmean(s["diff"] for s in steps),
            "grad_gap": max(s["gap"] for s in steps),
            "step_gap": max(leaf_gaps(_norms(change), _norms(ref_change),
                                      moved).values())}


def change_details(change: dict, ref_change: dict, first: dict,
                   top: int = 3) -> list:
    """The `top` leaves of the worst gap of change norms: leaf, gap,
    program and reference norms."""
    gaps = leaf_gaps(_norms(change), _norms(ref_change), first["moved"])
    return [(k, gaps[k], float(change[k].norm()),
             float(ref_change[k].norm()))
            for k in sorted(gaps, key=lambda k: -gaps[k])[:top]]


def det_gaps(dets: np.ndarray, corners, obj, cls) -> np.ndarray:
    """(K,) gaps of each served detection to the reference prediction of
    the image that explains it best: the largest of 1 - IoU, the relative
    score gap and the class gap. dets (K, 6) [x1, y1, x2, y2, score,
    class]; corners (M, 4), obj (M,), cls (M, nc) on one device."""
    if len(dets) == 0:
        return np.zeros(0)
    d = torch.as_tensor(dets, dtype=torch.float32, device=corners.device)
    c = d[:, 5].long()
    # every box widened by a pixel on each side, so that two boxes under
    # a pixel wide that lie on one another read an IoU of about 1
    grow = torch.tensor([-1.0, -1.0, 1.0, 1.0], device=d.device)
    iou = iou_matrix(d[:, :4] + grow, corners + grow)  # (K, M)
    p_c = cls[:, c].T  # (K, M): the served class's probability
    score = obj[None, :] * p_c
    score_gap = (d[:, 4:5] - score).abs() / score.clamp(min=1e-12)
    cls_gap = cls.amax(dim=1)[None, :] - p_c
    gap = torch.maximum(torch.maximum(1 - iou, score_gap), cls_gap)
    return gap.amin(dim=1).cpu().numpy()


def rank_gaps(dets: np.ndarray, ref: np.ndarray, k: int) -> np.ndarray:
    """Per rank below the longer list's length: |served score - reference
    score| over the larger of the two, both lists sorted and padded with
    0 (a detection missing on one side reads 1)."""
    n = max(len(dets), len(ref))
    a, b = np.zeros(k), np.zeros(k)
    a[:len(dets)] = np.sort(dets[:, 4])[::-1][:k]
    b[:len(ref)] = np.sort(ref[:, 4])[::-1][:k]
    return np.abs(a - b)[:n] / np.maximum(np.maximum(a, b)[:n], 1e-30)


def found(dets: np.ndarray, ref: np.ndarray, top: int) -> int:
    """How many of the reference's `top` best detections have a served
    detection of their class beside them (IoU of the widened boxes 0.5 or
    more)."""
    ref = ref[np.argsort(-ref[:, 4], kind="stable")[:top]]
    if len(ref) == 0 or len(dets) == 0:
        return 0
    a, b = (torch.as_tensor(x[:, :4], dtype=torch.float64)
            + torch.tensor([-1.0, -1.0, 1.0, 1.0], dtype=torch.float64)
            for x in (ref, dets))
    same = torch.as_tensor(ref[:, 5])[:, None] == torch.as_tensor(
        dets[:, 5])[None, :]
    hit = (iou_matrix(a, b) >= 0.5) & same
    return int(hit.any(dim=1).sum())


def serve_numbers(det: list, rank: list, n_ref: list, hits: list,
                  top: int) -> dict:
    """The serving numbers from per-image lists (`det_gaps`' first column,
    `rank_gaps`, the reference's detection count, `found`'s count). A
    reference detection with no served one beside it (the reference's
    list longer than the served) counts as a gap of 1 in `det_gap`."""
    full = [np.concatenate([d, np.ones(max(0, n - len(d)))])
            for d, n in zip(det, n_ref)]
    every = np.concatenate(full) if full else np.zeros(0)
    wanted = sum(min(n, top) for n in n_ref)
    return {"det_gap": float(every.mean()) if len(every) else 0.0,
            "rank_gap": float(np.mean([r.mean() if len(r) else 0.0
                                       for r in rank])) if rank else 0.0,
            "miss_share": 1.0 - sum(hits) / wanted if wanted else 0.0}


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, number, limit)]) over the numbers that have a
    limit; a number that is not finite, or missing, fails."""
    rows = [(k, numbers.get(k, math.nan), limits[k]) for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
