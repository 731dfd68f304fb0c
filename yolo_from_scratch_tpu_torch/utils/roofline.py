"""Least device time on one NVIDIA H100 SXM, from the data sheet (dense
rates, 700 W): the larger of the bytes a function must move over the
memory rate and its operations over the peak rate for their type. These
are bounds computed from shapes, never measurements.

Two levels:

- the port's hand-written kernels (`bound_ms` and the `*_work` counts):
  each input byte counts as read once and each output byte as written
  once, whatever the kernel reads again; where the work depends on the
  data (the NMS walk), the caller counts what the run's data needs;
- the model (counterpart of the model level of
  `yolo_from_scratch_tpu/utils/roofline.py`, `ConvCost` ..
  `param_bytes`): every conv of the eval forward, walked on the meta
  device (no weights are made) by a `TorchFunctionMode` that sees each
  `conv2d` call, the gated convs' `conv3x3_same` too, with its input,
  weight and output bytes in the compute dtype and 2 * out * k^2 * cin
  FLOPs at the dtype's peak; the max pools, upsamples and concats as
  non-conv bytes (read + write of the output). A training step is taken
  as 3x the forward's conv FLOPs and time, and `mfu` of a measured rate
  is the step's FLOPs over the card's peak for the compute dtype.

Run as a module for the model's table (no card needed):
    python -m yolo_from_scratch_tpu_torch.utils.roofline [--batch 8] \
        [--size s] [--img-size 640] [--dtype bfloat16] [--measured IMG_S]
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

C = 64
H100_BYTES_PER_S = 3.35e12
# bf16 and int8 on the tensor cores; float32 outside them (the float32
# kernels keep FMAs: TF32 would miss their 1e-5 tolerance)
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# one IoU test (csrc/nms.cu::suppresses): 4 min/max, 2 subtractions, 2
# clamps and 1 product for the overlap, 3 additions for the union (with
# its 1e-6), 1 division, 1 comparison; and once per box its area (2
# subtractions, 1 product)
NMS_FLOPS_PER_IOU = 14
NMS_FLOPS_PER_BOX = 3


def bound_ms(flops, bytes_, dtype):
    """(least ms, "bytes" or "operations") for `flops` operations in
    `dtype` ("bfloat16", "float32" or "int8") and `bytes_` of device
    memory."""
    t_bytes = bytes_ / H100_BYTES_PER_S
    t_ops = flops / H100_PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def conv3x3_bwd_work(b, h, w, itemsize):
    """(FLOPs, bytes) of dx and dW of one stride-1 SAME 3x3 64->64 conv
    (K2, K3, K4): two products of 2·P·9·C² each, P = B·H·W; x and dy read,
    dx written in the activation type, the (576, 64) weights read in it
    and dW written in float32."""
    p = b * h * w
    flops = 4 * p * 9 * C * C
    bytes_ = 3 * p * C * itemsize + 9 * C * C * itemsize + 9 * C * C * 4
    return flops, bytes_


def chain_bwd_work(b, h, w, itemsize):
    """(FLOPs, bytes) of the conv-SiLU-conv chain's backward (K5): four
    conv products (dx, dw1 and the two of conv2's input gradient and dw2);
    x, z1, a1 and dy read, dx written, both weights read, the two float32
    scales read and the two float32 weight gradients written."""
    p = b * h * w
    flops = 8 * p * 9 * C * C
    bytes_ = (5 * p * C * itemsize + 2 * 9 * C * C * itemsize + 2 * C * 4
              + 2 * 9 * C * C * 4)
    return flops, bytes_


def nms_work(n_boxes, n_iou):
    """(FLOPs, bytes) of a greedy NMS keep mask that takes `n_iou` IoU
    tests (float32) over `n_boxes` boxes: the float32 boxes (4 values)
    and scores read, the one-byte mask written."""
    flops = NMS_FLOPS_PER_IOU * n_iou + NMS_FLOPS_PER_BOX * n_boxes
    return flops, n_boxes * (4 * 4 + 4 + 1)


def nms_iou_count(keep, valid):
    """IoU tests a greedy walk over score-sorted boxes needs: each kept
    pivot against every later valid candidate. `keep` and `valid` are
    (..., N) boolean masks in sorted order; returns a Python int."""
    later_valid = valid.flip(-1).cumsum(-1).flip(-1) - valid.long()
    return int((later_valid * keep.long()).sum())


def nms_mask_pass_tests(valid):
    """IoU tests the two-pass kernel's mask pass (csrc/nms.cu) takes: each
    valid rank against every later rank, valid or not. That is the work of
    the design; the bound stays the function's (`nms_iou_count`). `valid`
    is an (..., N) boolean mask in sorted order; returns a Python int."""
    n = valid.shape[-1]
    later = torch.arange(n - 1, -1, -1, device=valid.device)
    return int((valid.long() * later).sum())


def conv3x3_bwd_bound_ms(b, h, w, dtype):
    """`bound_ms` of `conv3x3_bwd_work` at (B, H, W) in `dtype`."""
    itemsize = 2 if dtype == "bfloat16" else 4
    return bound_ms(*conv3x3_bwd_work(b, h, w, itemsize), dtype)


def chain_bwd_bound_ms(b, h, w, dtype):
    """`bound_ms` of `chain_bwd_work` at (B, H, W) in `dtype`."""
    itemsize = 2 if dtype == "bfloat16" else 4
    return bound_ms(*chain_bwd_work(b, h, w, itemsize), dtype)


def int8_conv_work(b, h, w, cin, cout, k, stride, out_itemsize):
    """(operations, bytes) of Q2, one int8 conv with its epilogue: 2 M N K
    integer operations, M = B Ho Wo, K = k^2 Cin (the real channels, not
    Q1's zero padding); xq read once (B H W Cin int8), the (Cout, K) int8
    weights and the two float32 vectors read, the output written in its
    type (4 bytes for the raw int32). Ho = (H - 1) // stride + 1 for
    every conv Q2 takes: a SAME k x k, or a packed 2x2 padded (1, 0)."""
    ho = (h - 1) // stride + 1
    wo = (w - 1) // stride + 1
    m, kk = b * ho * wo, k * k * cin
    return (2 * m * cout * kk,
            b * h * w * cin + cout * kk + 2 * cout * 4
            + m * cout * out_itemsize)


def quant_input_work(b, c, h, w, itemsize):
    """(operations, bytes) of Q1: per element a product, a rounding and a
    clip (4 float32 operations); the activation read in its type, the int8
    written."""
    n = b * c * h * w
    return 4 * n, n * itemsize + n


# --- the model level ------------------------------------------------------

# non-conv ops whose output the forward reads and writes once more
_OTHER_OPS = ("max_pool2d", "interpolate", "cat")


@dataclasses.dataclass
class ConvCost:
    """One conv of the forward: NCHW output and OIHW kernel shapes, its
    FLOPs (2 per multiply-add) and bytes (input + weight + output in the
    op's dtype), and enough of its signature to run it alone."""

    out_shape: tuple
    kernel_shape: tuple
    flops: float
    bytes_io: float
    lhs_shape: tuple = ()
    strides: tuple = (1, 1)
    padding: tuple = ()
    dtype: str = "float32"

    @property
    def t_ops(self):
        """Seconds at the H100's peak for the dtype."""
        return self.flops / H100_PEAK_FLOPS[self.dtype]

    def t_hbm(self, bw=H100_BYTES_PER_S):
        return self.bytes_io / bw

    @property
    def t_min(self):
        return max(self.t_ops, self.t_hbm())


def _pairs(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class _Walk(TorchFunctionMode):
    """Records each `conv2d` as a ConvCost and the bytes of each max pool,
    upsample and concat, in the order the forward computes them."""

    def __init__(self):
        super().__init__()
        self.convs, self.others = [], []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is F.conv2d:
            x, w = args[0], args[1]
            rest = dict(zip(("bias", "stride", "padding", "dilation",
                             "groups"), args[2:]), **kwargs)
            groups = rest.get("groups", 1)
            kh, kw = w.shape[2:]
            pad = _pairs(rest.get("padding", 0))
            self.convs.append(ConvCost(
                tuple(out.shape), tuple(w.shape),
                2.0 * out.numel() * kh * kw * w.shape[1],
                float(x.numel() * x.element_size()
                      + w.numel() * w.element_size()
                      + out.numel() * out.element_size()),
                lhs_shape=tuple(x.shape),
                strides=_pairs(rest.get("stride", 1)),
                padding=tuple((p, p) for p in pad),
                dtype=str(x.dtype).removeprefix("torch.")))
        elif getattr(func, "__name__", "") in _OTHER_OPS:
            self.others.append(2.0 * out.numel() * out.element_size())
        return out


def forward_conv_costs(cfg, batch=8):
    """Walk the eval forward of cfg's model at `batch` on the meta device:
    ([ConvCost, ...], non-conv bytes)."""
    from yolo_from_scratch_tpu_torch.models.yolo import YOLO

    model = YOLO(cfg, device="meta")
    walk = _Walk()
    with torch.no_grad(), walk:
        model(torch.empty((batch, cfg.img_size, cfg.img_size, 3),
                          device="meta"), train=False)
    return walk.convs, float(sum(walk.others))


def summarize(cfg, batch=8, measured_img_s=None):
    """The model's roofline at `batch` on the H100 (dict): the forward's
    conv FLOPs and floor, a training step's (3x the forward's) and the
    img/s it allows; with a measured img/s, `mfu` (the step's FLOPs over
    the card's peak for the compute dtype) and `roofline_frac` (the
    step's floor over its measured time)."""
    convs, other_bytes = forward_conv_costs(cfg, batch)
    fwd_flops = sum(c.flops for c in convs)
    fwd_t_ops = sum(c.t_ops for c in convs)
    fwd_t_min = sum(c.t_min for c in convs) + other_bytes / H100_BYTES_PER_S
    # training step: fwd + bwd-data + bwd-weights ~= 3x conv FLOPs; byte
    # traffic roughly 2x fwd (activations re-read + grads written)
    train_flops = 3.0 * fwd_flops
    train_t_min = 3.0 * fwd_t_min
    peak = H100_PEAK_FLOPS[cfg.compute_dtype]
    out = {
        "convs": convs,
        "other_bytes": other_bytes,
        "peak_flops": peak,
        "fwd_flops": fwd_flops,
        "fwd_t_ops_ms": fwd_t_ops * 1e3,
        "fwd_t_min_ms": fwd_t_min * 1e3,
        "train_flops": train_flops,
        "train_t_min_ms": train_t_min * 1e3,
        "roofline_img_s": batch / train_t_min,
    }
    if measured_img_s:
        t_meas = batch / measured_img_s
        out["measured_img_s"] = measured_img_s
        out["mfu"] = train_flops / t_meas / peak
        out["roofline_frac"] = train_t_min / t_meas
    return out


def markdown_table(cfg, batch=8, measured_img_s=None):
    s = summarize(cfg, batch, measured_img_s)
    lines = [
        f"Roofline @ batch {batch}, img {cfg.img_size}, dtype "
        f"{cfg.compute_dtype} (H100 SXM data sheet: "
        f"{s['peak_flops'] / 1e12:.0f} TFLOP/s, "
        f"{H100_BYTES_PER_S / 1e12:.2f} TB/s)",
        "",
        "| conv (out shape) | kernel | GFLOP | t_ops us | t_hbm us | bound |",
        "|---|---|---|---|---|---|",
    ]
    for c in s["convs"]:
        bound = "ops" if c.t_ops >= c.t_hbm() else "HBM"
        lines.append(
            f"| {c.out_shape} | {c.kernel_shape} | {c.flops / 1e9:.2f} "
            f"| {c.t_ops * 1e6:.1f} | {c.t_hbm() * 1e6:.1f} | {bound} |"
        )
    lines += [
        "",
        f"- forward conv FLOPs: {s['fwd_flops'] / 1e9:.1f} GFLOP "
        f"({s['fwd_flops'] / batch / 1e9:.2f} GFLOP/img)",
        f"- forward floor: {s['fwd_t_min_ms']:.2f} ms "
        f"(peak-rate convs {s['fwd_t_ops_ms']:.2f} ms; non-conv bandwidth "
        f"{s['other_bytes'] / 1e6:.0f} MB)",
        f"- training-step floor (3x conv work): {s['train_t_min_ms']:.2f} ms "
        f"= {s['roofline_img_s']:.0f} img/s speed-of-light",
    ]
    if measured_img_s:
        lines += [
            f"- measured: {measured_img_s:.0f} img/s -> "
            f"{100 * s['roofline_frac']:.0f}% of roofline, "
            f"MFU {100 * s['mfu']:.1f}%",
        ]
    return "\n".join(lines)


def param_bytes(cfg) -> float:
    """Trainable-parameter bytes (float32 master weights), from the model
    on the meta device: no weights are made."""
    from yolo_from_scratch_tpu_torch.models.yolo import YOLO

    return float(sum(p.numel() * p.element_size()
                     for p in YOLO(cfg, device="meta").parameters()))


if __name__ == "__main__":
    import argparse

    from yolo_from_scratch_tpu_torch.config import YoloConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", default="s")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--measured", type=float, default=None,
                    help="measured img/s to compare against")
    a = ap.parse_args()
    print(markdown_table(YoloConfig.from_size(a.size, img_size=a.img_size,
                                              compute_dtype=a.dtype),
                         a.batch, a.measured))
