"""Greedy NMS through the hand-written CUDA kernel (counterpart of
`yolo_from_scratch_tpu/ops/nms_pallas.py`).

The kernel (`csrc/nms.cu`) computes the keep mask over score-sorted,
class-offset boxes in two passes: the suppression bits of every pair of
ranks over the whole card into a workspace that this wrapper allocates,
then one block per image scanning them in chunks of 64 ranks. Around it,
in plain torch on the same stream and exactly as `nms_pallas.py` does
outside its Pallas kernel: the sort and the scatter back (skipped when
`presorted`), the class offsets and the top-k compaction.

The keep mask of sorted boxes is the registered op
`yolo_torch::nms_keep_mask`, which dispatches by the tensors' device: CPU
tensors go to the plain version (`ops/nms.py`), CUDA tensors launch the
kernel or raise, anything else raises. There is no fallback from the
kernel to the plain version. The live path and a `torch.export` program
(`infer/export.py`, which cannot trace a ctypes call on `data_ptr()`) call
the same op. `launches` counts the wrapper's launches of the kernel (both
passes each time) and nothing else. It counts Python calls: a launch
captured in a CUDA graph is counted once, at capture, and never at a
replay (count a replay's launches with the profiler).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from yolo_from_scratch_tpu_torch.ops import nms as nms_plain
from yolo_from_scratch_tpu_torch.ops.nms import (
    _class_offset_boxes,
    select_top,
    sort_desc,
)

launches = 0


class Geometry(NamedTuple):
    """The kernel's launch geometry at (B, N), as `csrc/nms.cu` exports it:
    W = ceil(N / 64), the scan's chunks of 64 ranks in flight (as many as
    fit in shared memory, at most 8), the scan's shared memory and the
    workspace (per image and chunk c of 64 ranks, 64 column words and 64
    rows of W - 1 - c words, 32 W (W + 1) words of 8 bytes in all), in
    bytes, and the mask pass's blocks (one per pair of 64-rank blocks,
    column >= row, per image)."""

    words: int
    stages: int
    scan_smem_bytes: int
    workspace_bytes: int
    mask_blocks: int


def geometry(lib, b, n):
    """`Geometry` of a (B, N) launch, read from the kernel library."""
    out = (ctypes.c_longlong * 5)()
    rc = lib.nms_geometry(b, n, out)
    if rc != 0:
        raise ValueError(f"NMS kernel takes 1..65535 images of 1.."
                         f"{lib.nms_max_boxes()} boxes, got B={b} N={n}")
    return Geometry(*out)


def check_operand(t, name, align):
    """Raise ValueError unless t is dense (contiguous) and starts on an
    `align`-byte boundary, as the kernel reads it. No copy is made."""
    if not t.is_contiguous():
        raise ValueError(f"{name}: the NMS kernel reads a contiguous tensor, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: the NMS kernel reads it from a {align}-byte "
                         f"boundary, got address {t.data_ptr():#x}")


def _launch_keep_mask(boxes_s, scores_s, iou_threshold, cap):
    """Run the kernel on sorted (B, N, 4) / (B, N) float32 CUDA tensors.
    Raises ValueError, before anything is built or launched, on tensors
    the kernel cannot read (the boxes are read as float4)."""
    global launches
    check_operand(boxes_s, "boxes", 16)
    check_operand(scores_s, "scores", 4)
    from yolo_from_scratch_tpu_torch.kernels.build import load_library

    lib = load_library()
    b, n = scores_s.shape
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes_s.device)
    if b == 0 or n == 0:
        return keep
    mask = torch.empty(geometry(lib, b, n).workspace_bytes, dtype=torch.uint8,
                       device=boxes_s.device)
    with torch.cuda.device(boxes_s.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.nms_keep_mask_f32(
            boxes_s.data_ptr(), scores_s.data_ptr(), keep.data_ptr(),
            mask.data_ptr(), b, n, cap, float(iou_threshold), stream,
        )
    if rc != 0:
        raise RuntimeError(f"NMS kernel launch failed: "
                           f"{lib.nms_error_string(rc).decode()} ({rc})")
    launches += 1
    return keep


@torch.library.custom_op("yolo_torch::nms_keep_mask", mutates_args=())
def keep_mask_sorted(boxes_s: torch.Tensor, scores_s: torch.Tensor,
                     iou_threshold: float, cap: int) -> torch.Tensor:
    """(B, N) keep mask of (B, N, 4) / (B, N) boxes and scores sorted by
    descending score per image, at most `cap` kept an image: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if boxes_s.device.type == "cpu":
        return nms_plain.nms_keep_mask(boxes_s, scores_s, iou_threshold,
                                       max_keep=cap, presorted=True)
    return _launch_keep_mask(boxes_s, scores_s, iou_threshold, cap)


@keep_mask_sorted.register_fake
def _(boxes_s, scores_s, iou_threshold, cap):
    return scores_s.new_empty(scores_s.shape, dtype=torch.bool)


def nms_keep_mask_batched(boxes, scores, iou_threshold, max_keep=None,
                          presorted=False):
    """Batched greedy NMS. boxes (B, N, 4), scores (B, N); entries <=
    NEG_INF/2 are padding. `presorted`: scores already descend per image
    (e.g. straight out of the top-k), so the sort and the scatter back are
    skipped. Returns a (B, N) bool keep mask in the original order."""
    if (boxes.device.type not in ("cpu", "cuda")
            or scores.device != boxes.device):
        raise ValueError(f"NMS takes CPU or CUDA tensors on one device, got "
                         f"boxes on {boxes.device}, scores on {scores.device}")
    if boxes.device.type == "cuda" and (boxes.dtype != torch.float32
                                        or scores.dtype != torch.float32):
        raise TypeError(f"NMS kernel takes float32, got {boxes.dtype}, "
                        f"{scores.dtype}")
    if (boxes.dim() != 3 or boxes.shape[2] != 4
            or scores.shape != boxes.shape[:2]):
        raise ValueError(f"expected boxes (B, N, 4) and scores (B, N), got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    b, n = scores.shape
    if presorted:
        boxes_s, scores_s = boxes, scores
    else:
        scores_s, order = sort_desc(scores, dim=1)
        boxes_s = torch.gather(boxes, 1, order[..., None].expand(b, n, 4))
    cap = n if max_keep is None else min(max_keep, n)
    keep = torch.ops.yolo_torch.nms_keep_mask(boxes_s, scores_s,
                                              float(iou_threshold), cap)
    if presorted:
        return keep
    return torch.zeros_like(keep).scatter_(1, order, keep)


def nms_keep_mask(boxes, scores, iou_threshold, max_keep=None,
                  presorted=False):
    """Single image: (N, 4), (N,) -> (N,) bool keep mask."""
    return nms_keep_mask_batched(boxes[None], scores[None], iou_threshold,
                                 max_keep=max_keep, presorted=presorted)[0]


def batched_nms_fixed_cuda(boxes, scores, classes, iou_threshold,
                           max_outputs, presorted=False):
    """Class-aware global NMS with fixed-size output, one image. Same
    contract as `ops.nms.batched_nms_fixed`."""
    keep = nms_keep_mask(_class_offset_boxes(boxes, classes), scores,
                         iou_threshold, max_keep=max_outputs,
                         presorted=presorted)
    return select_top(keep, boxes, scores, classes, max_outputs)


def batched_nms_fixed_cuda_images(boxes, scores, classes, iou_threshold,
                                  max_outputs, presorted=False):
    """Class-aware global NMS over a batch of images, one kernel launch.
    (B, N, 4)/(B, N)/(B, N) -> (B, K, 4)/(B, K)/(B, K)/(B, K), per image the
    contract of `ops.nms.batched_nms_fixed`."""
    keep = nms_keep_mask_batched(_class_offset_boxes(boxes, classes), scores,
                                 iou_threshold, max_keep=max_outputs,
                                 presorted=presorted)
    return select_top(keep, boxes, scores, classes, max_outputs)
