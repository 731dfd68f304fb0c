"""Inference with cross-scale global NMS (counterpart of
`yolo_from_scratch_tpu/infer/predict.py`): single-image and batched
serving, both heads.

letterbox -> uint8 * INV255 -> forward -> per-scale decode -> sigmoid,
then the gate -> un-letterbox -> top-k prefilter -> class-aware greedy
NMS -> (x1, y1, x2, y2, conf, cls) tuples in original image coordinates.
The anchor head gates on objectness and scores obj * cls; the anchor-free
head (objectness folded into its classes) gates on and scores its best
class probability, one prediction a cell. Everything after the letterbox
runs on the predictor's device with fixed shapes; only the final (K, ...)
block is copied back.
NMS goes through the CUDA kernel's wrapper (`ops/nms_cuda.py`), which
launches the kernel for CUDA tensors and runs the plain version for CPU
tensors.

- `Predictor`: one image a call (`make_postprocess`); with
  `device_letterbox=True` the B=1 batch program behind the device
  letterbox.
- `BatchPredictor`: B images a call, one forward and ONE NMS launch for
  the whole batch (`make_batch_postprocess`). The host decodes and stages
  the raw frames in one buffer, uploaded once; L1
  (`ops/letterbox_cuda.py`) makes PIL's letterboxed bytes from them on
  the device. `device_letterbox=True` takes the JAX package's device
  letterbox instead (`data/letterbox.py::letterbox_device_bucketed`,
  within ~1.5 LSB of PIL).
- `PipelinedPredictor`: single-image requests with up to `depth` in
  flight; each result comes back through pinned host memory behind a CUDA
  event.

`quantize_calib` (a list of images) serves the int8 model instead
(`infer/quantize.py`), calibrated on those images: every ConvBNSiLU but
`stem0` runs Q1 and Q2 (`ops/quant.py`), kernels on the card; a packed
model's convs run them at their packed shapes (the 2x2 convs padded (1, 0)
included).

A config with the packed layouts (`cfg.packed_stem`, `models/packed.py`)
is served packed: the host letterboxes and packs each image 4x
(`pack_s2d_host`) before the upload, or, in `BatchPredictor`, L1 writes
that layout. Behind `device_letterbox=True` the
device emits pixel images, and the predictors serve them through the
unpacked model on the same weights, as the JAX package does.

`approx_topk=True` asks for the JAX package's approximate top-k
prefilter, which is approximate only on a TPU and exact elsewhere: here
it selects the exact top-k, as without it.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from yolo_from_scratch_tpu_torch.config import INV255, STRIDES, YoloConfig
from yolo_from_scratch_tpu_torch.data.letterbox import (
    bucket_shape,
    letterbox_device_bucketed,
    letterbox_geometry,
    letterbox_image,
    pack_s2d_host,
    stage_to_bucket,
)
from yolo_from_scratch_tpu_torch.infer.detections import (
    detections,
    detections_per_image,
)
from yolo_from_scratch_tpu_torch.models.anchor_free import decode_anchor_free
from yolo_from_scratch_tpu_torch.models.yolo import (
    YOLO,
    cast_convs_,
    compute_dtype,
)
from yolo_from_scratch_tpu_torch.ops import letterbox_cuda
from yolo_from_scratch_tpu_torch.ops.decode import decode_predictions
from yolo_from_scratch_tpu_torch.ops.nms import (
    NEG_INF,
    batched_nms_fixed,
    sort_desc,
)
from yolo_from_scratch_tpu_torch.ops.nms_cuda import (
    batched_nms_fixed_cuda,
    batched_nms_fixed_cuda_images,
)
from yolo_from_scratch_tpu_torch.utils.metrics_log import span


def default_topk(img_size: int, preds_per_cell: int = 3) -> int:
    """NMS candidate capacity per resolution: all A * sum((S/s)^2)
    predictions, capped at 4096 (25,200 @640 for the 3-anchor head, 8,400
    for the anchor-free head's one a cell)."""
    total = preds_per_cell * sum((img_size // s) ** 2 for s in (8, 16, 32))
    return min(total, 4096)


def preds_per_cell(cfg: YoloConfig) -> int:
    """Predictions a grid cell: 1 for the anchor-free head, else 3."""
    return 1 if cfg.head_type == "anchor_free" else 3


def _flat_predictions(preds, cfg: YoloConfig, b: int):
    """Per-scale raw outputs -> (boxes (B, M, 4) normalised cx cy w h,
    obj (B, M), cls (B, M, nc) probabilities) over all M predictions. The
    anchor-free head has no objectness: obj is 1."""
    nc = cfg.num_classes
    boxes_all, obj_all, cls_all = [], [], []
    if cfg.head_type == "anchor_free":
        for pred, stride in zip(preds, STRIDES):
            flat = decode_anchor_free(pred, stride, cfg.img_size).reshape(
                b, -1, 4 + nc)
            boxes_all.append(flat[..., 0:4])
            obj_all.append(torch.ones_like(flat[..., 0]))
            cls_all.append(torch.sigmoid(flat[..., 4:]))
    else:
        for pred, anc in zip(preds, cfg.anchors_array):
            flat = decode_predictions(pred, anc, cfg.img_size).reshape(
                b, -1, 5 + nc)
            boxes_all.append(flat[..., 0:4])
            obj_all.append(torch.sigmoid(flat[..., 4]))
            cls_all.append(torch.sigmoid(flat[..., 5:]))
    return (torch.cat(boxes_all, dim=1), torch.cat(obj_all, dim=1),
            torch.cat(cls_all, dim=1))


def _gated_score(cfg: YoloConfig, obj, cls_prob, conf_threshold):
    """The NMS score, NEG_INF below the gate: the anchor head gates on
    objectness and scores obj * cls; the anchor-free head gates on and
    scores its class probability."""
    if cfg.head_type == "anchor_free":
        return torch.where(cls_prob > conf_threshold, cls_prob, NEG_INF)
    return torch.where(obj > conf_threshold, obj * cls_prob, NEG_INF)


def _best_class(cls):
    """(..., nc) class probabilities -> the best probability and its id
    (int32); with one class, that class. On a tie `torch.argmax` takes
    the first index, as `jnp.argmax` does (`max(dim).indices` promises
    no such order)."""
    if cls.shape[-1] == 1:
        return cls[..., 0], torch.zeros(cls.shape[:-1], dtype=torch.int32,
                                        device=cls.device)
    return cls.amax(dim=-1), torch.argmax(cls, dim=-1).to(torch.int32)


def _unletterbox(boxes, img_size, scale, pad_top, pad_left):
    """Normalized (..., 4) cx cy w h -> letterboxed pixels -> corners in
    the original image's pixels."""
    cx, cy = boxes[..., 0] * img_size, boxes[..., 1] * img_size
    w, h = boxes[..., 2] * img_size, boxes[..., 3] * img_size
    x1 = (cx - w / 2 - pad_left) / scale
    y1 = (cy - h / 2 - pad_top) / scale
    x2 = (cx + w / 2 - pad_left) / scale
    y2 = (cy + h / 2 - pad_top) / scale
    return torch.stack([x1, y1, x2, y2], dim=-1)


def make_postprocess(model: YOLO, cfg: YoloConfig, conf_threshold=0.5,
                     iou_threshold=0.4, topk=None, max_outputs=None,
                     use_cuda_nms=True, approx_topk=False):
    """Build the forward+postprocess:
    (img (1,S,S,3) uint8 or float, or a packed model's (1, S/4, S/4, 48),
     scale, pad_top, pad_left)
      -> (boxes (K,4) px orig-image, scores (K,), classes (K,), valid (K,)),
    all on the image's device.

    `use_cuda_nms`: True sends NMS through the kernel's wrapper (the
    kernel on a CUDA tensor, the plain version on a CPU tensor); False runs
    the plain version on any device, which is what the kernel is checked
    against. `approx_topk` takes the exact top-k (see the module's
    docstring). The returned function also carries its stages, `.decode`
    and `.candidates`, for parity checks.
    """
    img_size = cfg.img_size
    k = topk or default_topk(img_size, preds_per_cell(cfg))
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
        boxes, obj, cls = (t[0] for t in _flat_predictions(model(img), cfg,
                                                             1))
        cls_prob, cls_id = _best_class(cls)
        return (_unletterbox(boxes, img_size, scale, pad_top, pad_left), obj,
                cls_prob, cls_id)

    def candidates(img, scale, pad_top, pad_left):
        """The NMS input: the top-k by gated score, in descending order."""
        corners, obj, cls_prob, cls_id = decode(img, scale, pad_top, pad_left)
        score = _gated_score(cfg, obj, cls_prob, conf_threshold)
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


def make_batch_postprocess(model: YOLO, cfg: YoloConfig, conf_threshold=0.5,
                           iou_threshold=0.4, topk=None, max_outputs=300,
                           use_cuda_nms=True, approx_topk=False):
    """Batched serving path: (imgs (B, S, S, 3) uint8 or float, or a
    packed model's (B, S/4, S/4, 48), scales
    (B,), pad_tops (B,), pad_lefts (B,)) -> per-image fixed-shape
    detections (boxes (B, K, 4), scores (B, K), classes (B, K), valid
    (B, K)), K = `max_outputs`, all on the images' device.

    One forward over the whole batch; per image the gate, un-letterbox and
    top-k exactly as `make_postprocess`'s `candidates` (a stable
    descending sort, then the first k), taken along dim 1; then ONE
    class-aware NMS over (B, k): on a CUDA tensor one launch of the
    kernel for the batch, on a CPU tensor its plain version.
    `use_cuda_nms=False` runs the plain version on any device;
    `approx_topk` takes the exact top-k. The returned function carries its
    stages, `.decode` and `.candidates`, for parity checks.
    """
    img_size = cfg.img_size
    k = topk or default_topk(img_size, preds_per_cell(cfg))
    nms_fn = batched_nms_fixed_cuda_images if use_cuda_nms else \
        batched_nms_fixed

    @torch.inference_mode()
    def decode(imgs, scales, pad_tops, pad_lefts):
        """-> corners (B, M, 4) in original-image pixels, obj (B, M),
        cls_prob (B, M), cls_id (B, M) for all M raw predictions."""
        if imgs.dtype == torch.uint8:
            # the shared float32 reciprocal, never a divide by 255
            imgs = imgs.float() * float(INV255)
        boxes, obj, cls = _flat_predictions(model(imgs), cfg, imgs.shape[0])
        cls_prob, cls_id = _best_class(cls)
        corners = _unletterbox(boxes, img_size, scales[:, None],
                               pad_tops[:, None], pad_lefts[:, None])
        return corners, obj, cls_prob, cls_id

    def candidates(imgs, scales, pad_tops, pad_lefts):
        """The NMS input per image: (B, k, 4) corners, (B, k) scores in
        descending order, (B, k) class ids."""
        corners, obj, cls_prob, cls_id = decode(imgs, scales, pad_tops,
                                                pad_lefts)
        score = _gated_score(cfg, obj, cls_prob, conf_threshold)
        top_scores, idx = sort_desc(score, dim=1)
        idx = idx[:, :k]
        return (torch.gather(corners, 1, idx[..., None].expand(*idx.shape, 4)),
                top_scores[:, :k].contiguous(), torch.gather(cls_id, 1, idx))

    def postprocess(imgs, scales, pad_tops, pad_lefts):
        boxes, scores, classes = candidates(imgs, scales, pad_tops, pad_lefts)
        # candidates arrive sorted: the kernel skips its sort and scatter
        return nms_fn(boxes, scores, classes, iou_threshold, max_outputs,
                      presorted=True)

    postprocess.decode = decode
    postprocess.candidates = candidates
    return postprocess


def _image_array(image):
    """A decoded HWC uint8 RGB array of a path, PIL image or array (an
    HWC 3-channel array needs no PIL; other arrays convert as
    `letterbox_input` converts them)."""
    if isinstance(image, np.ndarray):
        image = np.asarray(image, np.uint8)
        if image.ndim == 3 and image.shape[2] == 3:
            return image
    from PIL import Image

    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    elif not hasattr(image, "size"):
        image = Image.open(image)
    return np.asarray(image.convert("RGB"), np.uint8)


def _stage_batch(arrs, img_size):
    """Host staging for the device-letterbox path: decoded HWC uint8
    arrays -> (bufs (B, Hb, Wb, 3), geoms (B, 6), scales (B,)) in one shared
    bucket (the component-wise max), so the whole batch is one call."""
    buckets = [bucket_shape(a.shape[0], a.shape[1]) for a in arrs]
    bucket = (max(b[0] for b in buckets), max(b[1] for b in buckets))
    bufs = np.stack([stage_to_bucket(a, bucket) for a in arrs])
    geoms, scales = [], []
    for a in arrs:
        geom, scale, _, _ = letterbox_geometry(a.shape[1], a.shape[0],
                                               img_size)
        geoms.append(geom)
        scales.append(scale)
    return bufs, np.stack(geoms), np.asarray(scales, np.float32)


def _wrap_device_letterbox(inner_post, img_size):
    """Device letterbox, then forward and postprocess: (bufs, geoms,
    scales) on the device -> `inner_post`'s outputs."""

    def post_lb(bufs, geoms, scales):
        imgs = letterbox_device_bucketed(bufs, geoms, img_size)
        return inner_post(imgs, scales, geoms[:, 4], geoms[:, 5])

    return post_lb


def _load_model(state_dict, cfg, device):
    """The serving model on `device` from a port state dict: a copy of
    every tensor (a caller's model is never aliased), the conv weights
    cast once to the compute dtype, eval mode."""
    # built on the meta device, so no weight is initialised (nor the
    # global RNG drawn from) only to be overwritten by the load
    model = YOLO(cfg, device="meta")
    model.load_state_dict(
        {k: v.to(device, torch.float32, copy=True)
         for k, v in state_dict.items()},
        strict=True, assign=True)
    # the conv weights once in the compute dtype, so no request casts
    return cast_convs_(model, compute_dtype(cfg)).eval()


def _quantize(model, state_dict, cfg, calib_images):
    """The predictors' PTQ: calibrate `model` on the letterboxed images and
    return its int8 copy, quantized from the float32 `state_dict` (the
    model's own conv weights are already cast to the compute dtype); a
    packed model calibrates on host-packed batches and serves packed."""
    from yolo_from_scratch_tpu_torch.infer.quantize import (
        calib_batches_from_images,
        quantize_model,
    )

    with span("serve.calibrate"):
        batches = calib_batches_from_images(calib_images, cfg.img_size,
                                            packed_stem=cfg.packed_stem)
        return quantize_model(model, batches, state_dict=state_dict)


def _pixel_model(model, state_dict, cfg, device):
    """The model that serves the device letterbox's pixel images: `model`
    itself, or for a packed config an unpacked one on the same weights."""
    if not cfg.packed_stem:
        return model, cfg
    cfg = cfg.with_(packed_stem=False, packed_interior=False,
                    packed_p3=False)
    return _load_model(state_dict, cfg, device), cfg


def _host_pack(batch, cfg):
    """A letterboxed (B, S, S, 3) uint8 host batch in the model's input
    layout: packed 4x for a packed model (`pack_s2d_host`)."""
    return pack_s2d_host(batch) if cfg.packed_stem else batch


def _refuse_letterbox(quantize_calib, device_letterbox):
    if quantize_calib is not None and device_letterbox:
        raise ValueError(
            "quantize_calib + device_letterbox unsupported: the "
            "calibrated layout must match the serving layout")


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
    return letterbox_image(image.convert("RGB"), img_size)


class Predictor:
    """Reusable single-image predictor on an explicit device.

    `state_dict` is the port's (from `utils.checkpoint.load_checkpoint` or
    `utils.convert.from_flax_variables`). `device_letterbox=True` moves the
    resize and pad onto the device: the host only decodes, and the B=1
    batch program (`make_batch_postprocess`, one NMS launch) runs behind
    `letterbox_device_bucketed`. `quantize_calib`: serve the int8 model
    calibrated on these images (not with `device_letterbox`).
    """

    def __init__(self, state_dict, cfg: YoloConfig, conf_threshold=0.5,
                 iou_threshold=0.4, topk=None, max_outputs=None, *, device,
                 use_cuda_nms=True, device_letterbox=False,
                 quantize_calib=None):
        _refuse_letterbox(quantize_calib, device_letterbox)
        self.cfg = cfg
        self.device = torch.device(device)
        self.device_letterbox = device_letterbox
        self.model = _load_model(state_dict, cfg, self.device)
        if quantize_calib is not None:
            self.model = _quantize(self.model, state_dict, cfg,
                                   quantize_calib)
        self.postprocess = make_postprocess(
            self.model, cfg, conf_threshold, iou_threshold, topk, max_outputs,
            use_cuda_nms=use_cuda_nms,
        )
        if device_letterbox:
            model, lb_cfg = _pixel_model(self.model, state_dict, cfg,
                                         self.device)
            self._post_lb = _wrap_device_letterbox(
                make_batch_postprocess(
                    model, lb_cfg, conf_threshold, iou_threshold, topk,
                    max_outputs or topk or default_topk(
                        cfg.img_size, preds_per_cell(cfg)),
                    use_cuda_nms=use_cuda_nms),
                cfg.img_size)

    def stage(self, image):
        """Letterbox on the host (and pack, for a packed model) and upload
        as uint8 (4x fewer bytes than float32; normalized on the device).
        Returns the postprocess args."""
        img_u8, scale, pad_top, pad_left = letterbox_input(image,
                                                           self.cfg.img_size)
        # a copy: PIL's arrays are read-only
        img = torch.tensor(_host_pack(img_u8[None], self.cfg))
        return (img.to(self.device), float(scale), float(pad_top),
                float(pad_left))

    @torch.inference_mode()
    def __call__(self, image):
        """image: path, PIL image or HWC uint8 array. Returns
        [(x1, y1, x2, y2, conf, cls), ...] in original image coordinates."""
        if self.device_letterbox:
            staged = _stage_batch([_image_array(image)], self.cfg.img_size)
            out = self._post_lb(*(torch.from_numpy(a).to(self.device)
                                  for a in staged))
            return detections(*(t[0].cpu() for t in out))
        return detections(*(t.cpu() for t in self.postprocess(
            *self.stage(image))))


class PipelinedPredictor:
    """Single-image serving client that keeps up to `depth` requests in
    flight (counterpart of the JAX `PipelinedPredictor`).

    `_dispatch` letterboxes on the host, enqueues the postprocess, starts
    non-blocking copies of its four outputs into pinned host tensors and
    records a CUDA event; `_finalize` waits on that event only. With
    `depth` requests in flight the card starts request k+1 while the host
    still reads back request k: sustained throughput rises, per-request
    latency does not fall. On the CPU every step is synchronous.

    Usage: `pp(images)`, or incrementally `pp.submit(img)` / `pp.drain()`.
    Results keep submission order.
    """

    def __init__(self, state_dict, cfg: YoloConfig, depth=4,
                 conf_threshold=0.5, iou_threshold=0.4, topk=None,
                 max_outputs=None, *, device, quantize_calib=None):
        self._p = Predictor(state_dict, cfg, conf_threshold, iou_threshold,
                            topk, max_outputs, device=device,
                            quantize_calib=quantize_calib)
        self.depth = max(1, int(depth))
        self._inflight = collections.deque()

    @torch.inference_mode()
    def _dispatch(self, image):
        out = self._p.postprocess(*self._p.stage(image))
        if self._p.device.type != "cuda":
            return out, None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     .copy_(t, non_blocking=True) for t in out)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _finalize(inflight):
        out, done = inflight
        if done is not None:
            done.synchronize()
        return detections(*(t.cpu() for t in out))

    def submit(self, image):
        """Enqueue one image; returns the results whose window slot was
        needed (a possibly empty list of per-image detection lists)."""
        self._inflight.append(self._dispatch(image))
        done = []
        while len(self._inflight) > self.depth:
            done.append(self._finalize(self._inflight.popleft()))
        return done

    def drain(self):
        """Collect every remaining in-flight result, in order."""
        done = [self._finalize(o) for o in self._inflight]
        self._inflight.clear()
        return done

    def __call__(self, images):
        """Run a stream of images; returns one detection list per image,
        in order, with up to `depth` requests overlapped."""
        results = []
        for image in images:
            results.extend(self.submit(image))
        results.extend(self.drain())
        return results


def predict(state_dict, cfg, image, conf_threshold=0.5, iou_threshold=0.4,
            *, device):
    """One-shot convenience mirroring the reference signature. Builds a
    fresh Predictor per call; construct one and reuse it when serving."""
    return Predictor(state_dict, cfg, conf_threshold, iou_threshold,
                     device=device)(image)


class BatchPredictor:
    """Batched serving predictor over paths, PIL images or HWC uint8
    arrays, on an explicit device: one L1 launch, one forward and one NMS
    launch a call (`stage`; the staging buffers are the predictor's,
    reused across calls, so it serves one call at a time).

    `device_letterbox=True`: the host only decodes; resize, pad and
    normalize, forward and NMS run on the device, the batch staged in one
    bucket of 256-px multiples (`_stage_batch`). `topk`: NMS candidates
    per image (default `default_topk`, 4096 @640 for either head).
    `quantize_calib`: serve the int8 model calibrated on these images (not
    with `device_letterbox`). `approx_topk`: the exact top-k (the module's
    docstring).
    """

    def __init__(self, state_dict, cfg: YoloConfig, conf_threshold=0.5,
                 iou_threshold=0.4, max_outputs=300, device_letterbox=False,
                 topk=None, quantize_calib=None, approx_topk=False, *,
                 device, use_cuda_nms=True):
        _refuse_letterbox(quantize_calib, device_letterbox)
        self.cfg = cfg
        self.device = torch.device(device)
        self.device_letterbox = device_letterbox
        self._staging = letterbox_cuda.Staging(self.device)
        self.model = _load_model(state_dict, cfg, self.device)
        if quantize_calib is not None:
            self.model = _quantize(self.model, state_dict, cfg,
                                   quantize_calib)
        post = dict(topk=topk, max_outputs=max_outputs,
                    use_cuda_nms=use_cuda_nms, approx_topk=approx_topk)
        self.postprocess = make_batch_postprocess(
            self.model, cfg, conf_threshold, iou_threshold, **post)
        self._lb_model = None  # a packed config's pixel-image model
        if device_letterbox:
            lb_model, lb_cfg = _pixel_model(self.model, state_dict, cfg,
                                            self.device)
            post_lb = self.postprocess
            if lb_model is not self.model:
                self._lb_model = lb_model
                post_lb = make_batch_postprocess(
                    lb_model, lb_cfg, conf_threshold, iou_threshold, **post)
            self._post_lb = _wrap_device_letterbox(post_lb, cfg.img_size)

    def load_weights(self, state_dict):
        """Serve new weights (a training model's float32 master weights,
        say) without rebuilding: each tensor copied into the predictor's
        own model (both of a packed predictor's behind the device
        letterbox) and cast to its dtype; the source is left as it is."""
        for model in (self.model, self._lb_model):
            if model is None:
                continue
            own = model.state_dict()
            if own.keys() != state_dict.keys():
                raise KeyError(f"state dicts differ in keys: "
                               f"{sorted(own.keys() ^ state_dict.keys())}")
            with torch.no_grad():
                for key, t in own.items():
                    t.copy_(state_dict[key])

    def stage(self, images):
        """The decoded frames staged on the host, uploaded in one copy and
        letterboxed on the device by L1 in the model's input layout
        (packed, for a packed model), inside `serve.letterbox`,
        `serve.upload` and `serve.l1` (`Staging.letterbox`). Returns the
        postprocess args."""
        return self._staging.letterbox(
            (_image_array(image) for image in images), self.cfg.img_size,
            self.cfg.packed_stem)

    @torch.inference_mode()
    def __call__(self, images):
        """images: list of paths, PIL images or HWC uint8 arrays. Returns a
        list (per image) of [(x1, y1, x2, y2, conf, cls), ...] in original
        coordinates. Spans (`utils/metrics_log.py`): `serve.call` around
        the call; inside it `serve.letterbox` (the host's staging),
        `serve.upload`, `serve.l1` (L1's launch), `serve.forward` (the
        host's dispatch), `serve.download` (which waits for the card) and
        `serve.lists`."""
        with span("serve.call"):
            if self.device_letterbox:
                with span("serve.letterbox"):
                    staged = _stage_batch([_image_array(i) for i in images],
                                          self.cfg.img_size)
                with span("serve.upload",
                          nbytes=sum(a.nbytes for a in staged)):
                    args = [torch.from_numpy(a).to(self.device)
                            for a in staged]
                post = self._post_lb
            else:
                args, post = self.stage(images), self.postprocess
            with span("serve.forward"):
                out = post(*args)
            with span("serve.download"):
                host = [t.cpu() for t in out]
            with span("serve.lists"):
                return detections_per_image(*host, len(images))
