"""Single-image inference with cross-scale global NMS (counterpart of
`yolo_from_scratch_tpu/infer/predict.py`).

letterbox -> uint8 * INV255 -> forward -> per-scale decode -> sigmoid,
then the objectness gate -> un-letterbox -> top-k prefilter -> class-aware
greedy NMS -> (x1, y1, x2, y2, conf, cls) tuples in original image
coordinates. Everything after the host letterbox runs on the Predictor's
device with fixed shapes; only the final (K, ...) block is copied back.
NMS goes through the CUDA kernel's wrapper (`ops/nms_cuda.py`), which
launches the kernel for CUDA tensors and runs the plain version for CPU
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_from_scratch_tpu_torch.config import INV255, YoloConfig
from yolo_from_scratch_tpu_torch.models.yolo import (
    YOLO,
    cast_convs_,
    compute_dtype,
)
from yolo_from_scratch_tpu_torch.ops.decode import decode_predictions
from yolo_from_scratch_tpu_torch.ops.nms import (
    NEG_INF,
    batched_nms_fixed,
    sort_desc,
)
from yolo_from_scratch_tpu_torch.ops.nms_cuda import batched_nms_fixed_cuda


def default_topk(img_size: int, preds_per_cell: int = 3) -> int:
    """NMS candidate capacity per resolution: all A * sum((S/s)^2)
    predictions, capped at 4096 (25,200 @640 for the 3-anchor head)."""
    total = preds_per_cell * sum((img_size // s) ** 2 for s in (8, 16, 32))
    return min(total, 4096)


def make_postprocess(model: YOLO, cfg: YoloConfig, conf_threshold=0.5,
                     iou_threshold=0.4, topk=None, max_outputs=None,
                     use_cuda_nms=True):
    """Build the forward+postprocess:
    (img (1,S,S,3) uint8 or float, scale, pad_top, pad_left)
      -> (boxes (K,4) px orig-image, scores (K,), classes (K,), valid (K,)),
    all on the image's device.

    `use_cuda_nms`: True sends NMS through the kernel's wrapper (the
    kernel on a CUDA tensor, the plain version on a CPU tensor); False runs
    the plain version on any device, which is what the kernel is checked
    against. The returned function also carries its stages, `.decode` and
    `.candidates`, for parity checks.
    """
    anchors = cfg.anchors_array
    img_size = cfg.img_size
    nc = cfg.num_classes
    k = topk or default_topk(img_size)
    max_out = max_outputs or k
    nms_fn = batched_nms_fixed_cuda if use_cuda_nms else batched_nms_fixed

    @torch.inference_mode()
    def decode(img, scale, pad_top, pad_left):
        """-> corners (M, 4) in original-image pixels, obj (M,),
        cls_prob (M,), cls_id (M,) for all M raw predictions."""
        if img.dtype == torch.uint8:
            # multiply by the shared float32 reciprocal, never divide by
            # 255: bit-identical to the host loader (config.INV255)
            img = img.float() * float(INV255)
        preds = model(img)
        boxes_all, obj_all, cls_all = [], [], []
        for pred, anc in zip(preds, anchors):
            flat = decode_predictions(pred, anc, img_size).reshape(-1, 5 + nc)
            boxes_all.append(flat[:, 0:4])
            obj_all.append(torch.sigmoid(flat[:, 4]))
            cls_all.append(torch.sigmoid(flat[:, 5:]))
        boxes = torch.cat(boxes_all)  # (M, 4) normalized cx cy w h
        obj = torch.cat(obj_all)
        cls = torch.cat(cls_all)
        if nc == 1:
            cls_prob = cls[:, 0]
            cls_id = torch.zeros(cls.shape[0], dtype=torch.int32,
                                 device=cls.device)
        else:
            cls_prob = cls.amax(dim=1)
            cls_id = cls.argmax(dim=1).to(torch.int32)

        # normalized -> letterboxed pixels -> corners -> original image
        cx, cy = boxes[:, 0] * img_size, boxes[:, 1] * img_size
        w, h = boxes[:, 2] * img_size, boxes[:, 3] * img_size
        x1 = (cx - w / 2 - pad_left) / scale
        y1 = (cy - h / 2 - pad_top) / scale
        x2 = (cx + w / 2 - pad_left) / scale
        y2 = (cy + h / 2 - pad_top) / scale
        return torch.stack([x1, y1, x2, y2], dim=1), obj, cls_prob, cls_id

    def candidates(img, scale, pad_top, pad_left):
        """The NMS input: the top-k by gated score, in descending order."""
        corners, obj, cls_prob, cls_id = decode(img, scale, pad_top, pad_left)
        # objectness gate, then combined confidence obj * cls
        score = torch.where(obj > conf_threshold, obj * cls_prob, NEG_INF)
        top_scores, idx = sort_desc(score)
        idx = idx[:k]
        return corners[idx], top_scores[:k], cls_id[idx]

    def postprocess(img, scale, pad_top, pad_left):
        boxes, scores, classes = candidates(img, scale, pad_top, pad_left)
        # candidates arrive sorted: the kernel skips its sort and scatter
        return nms_fn(boxes, scores, classes, iou_threshold, max_out,
                      presorted=True)

    postprocess.decode = decode
    postprocess.candidates = candidates
    return postprocess


def letterbox_input(image, img_size: int):
    """Host letterbox: (HWC uint8 array, scale, pad_top, pad_left).

    `image` is a path, a PIL image or an HWC uint8 numpy array. An array
    already at img_size x img_size is its own letterbox (scale 1, pads 0:
    PIL's resize to the same size is a copy), so it needs no PIL.
    """
    if isinstance(image, np.ndarray):
        if image.shape == (img_size, img_size, 3) and image.dtype == np.uint8:
            return image, 1.0, 0, 0
        from PIL import Image

        image = Image.fromarray(np.asarray(image, np.uint8))
    elif not hasattr(image, "size"):
        from PIL import Image

        image = Image.open(image)
    from yolo_from_scratch_tpu_torch.data.letterbox import letterbox_image

    return letterbox_image(image.convert("RGB"), img_size)


class Predictor:
    """Reusable single-image predictor on an explicit device.

    `state_dict` is the port's (from `utils.checkpoint.load_checkpoint` or
    `utils.convert.from_flax_variables`).
    """

    def __init__(self, state_dict, cfg: YoloConfig, conf_threshold=0.5,
                 iou_threshold=0.4, topk=None, max_outputs=None, *, device,
                 use_cuda_nms=True):
        self.cfg = cfg
        self.device = torch.device(device)
        # built on the meta device, so no weight is initialised (nor the
        # global RNG drawn from) only to be overwritten by the load
        self.model = YOLO(cfg, device="meta")
        self.model.load_state_dict(
            {k: v.to(self.device, torch.float32)
             for k, v in state_dict.items()},
            strict=True, assign=True)
        # the conv weights once in the compute dtype, so no request casts
        cast_convs_(self.model, compute_dtype(cfg)).eval()
        self.postprocess = make_postprocess(
            self.model, cfg, conf_threshold, iou_threshold, topk, max_outputs,
            use_cuda_nms=use_cuda_nms,
        )

    def stage(self, image):
        """Letterbox on the host and upload as uint8 (4x fewer bytes than
        float32; normalized on the device). Returns the postprocess args."""
        img_u8, scale, pad_top, pad_left = letterbox_input(image,
                                                           self.cfg.img_size)
        img = torch.tensor(img_u8[None])  # a copy: PIL's arrays are read-only
        return (img.to(self.device), float(scale), float(pad_top),
                float(pad_left))

    @torch.inference_mode()
    def __call__(self, image):
        """image: path, PIL image or HWC uint8 array. Returns
        [(x1, y1, x2, y2, conf, cls), ...] in original image coordinates."""
        boxes, scores, classes, valid = (
            t.cpu() for t in self.postprocess(*self.stage(image)))
        # one tolist() per column: per-element float()/int() costs ~1.5 us
        # a detection, milliseconds at random-init detection counts
        return [(*b, s, c) for b, s, c in zip(boxes[valid].tolist(),
                                              scores[valid].tolist(),
                                              classes[valid].tolist())]


def predict(state_dict, cfg, image, conf_threshold=0.5, iou_threshold=0.4,
            *, device):
    """One-shot convenience mirroring the reference signature. Builds a
    fresh Predictor per call; construct one and reuse it when serving."""
    return Predictor(state_dict, cfg, conf_threshold, iou_threshold,
                     device=device)(image)
