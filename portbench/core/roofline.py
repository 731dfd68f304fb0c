"""The yardstick of device work: one NVIDIA H100 SXM's published peaks
(NVIDIA's data sheet, dense rates, 700 W) and the least time a piece of
work can take on it, the larger of its bytes over the memory rate and its
operations over the peak rate for their type. Bounds computed from
shapes and data, never measurements.

Kernel work counts (each input byte read once, each output byte written
once, whatever the kernel reads again; where the work depends on the data,
what these inputs need):
- `nms_work` / `nms_iou_count`: the greedy NMS keep mask (K1);
- `int8_conv_work`: the int8 conv with its dequant epilogue (Q2);
- `quant_input_work`: rounding activations to int8 (Q1).
The model level (`conv_flops`) walks the benchmark's own reference model
(`portbench/reference/model.py`), never the program's.
"""

from __future__ import annotations

import torch

H100_BYTES_PER_S = 3.35e12
# bf16 and int8 on the tensor cores; float32 outside them
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# one IoU test: 4 min/max, 2 subtractions, 2 clamps and 1 product for the
# overlap, 3 additions for the union, 1 division, 1 comparison; once per
# box its area (2 subtractions, 1 product)
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


def int8_conv_work(b, h, w, cin, cout, k, stride, out_itemsize):
    """(operations, bytes) of one int8 conv with its epilogue: 2 M N K
    integer operations, M = B Ho Wo, K = k^2 Cin; the int8 input read
    once, the (Cout, K) int8 weights and two float32 vectors read, the
    output written in its type. Ho = (H - 1) // stride + 1."""
    ho = (h - 1) // stride + 1
    wo = (w - 1) // stride + 1
    m, kk = b * ho * wo, k * k * cin
    return (2 * m * cout * kk,
            b * h * w * cin + cout * kk + 2 * cout * 4
            + m * cout * out_itemsize)


def quant_input_work(b, c, h, w, itemsize):
    """(operations, bytes) of rounding activations to int8: per element a
    product, a rounding and a clip (4 operations); the activation read in
    its type, the int8 written."""
    n = b * c * h * w
    return 4 * n, n * itemsize + n


def conv_walk(cfg: dict, batch: int = 1):
    """[(layer name, input shape NCHW, weight shape OIHW, stride, FLOPs)]
    of every conv of the reference model's eval forward at `batch` images
    of cfg's size, in forward order, walked on the meta device (no weights
    are made); 2 FLOPs a multiply-add."""
    from portbench.reference.model import Numerics, forward, param_shapes

    class Walk(Numerics):
        def __init__(self):
            self.convs = []

        def conv(self, x, w, b, stride, name):
            y = super().conv(x, w, b, stride, name)
            self.convs.append((name, tuple(x.shape), tuple(w.shape), stride,
                               2.0 * y.numel() * w[0].numel()))
            return y

    p = {k: torch.empty(s, device="meta")
         for k, s in param_shapes(cfg).items()}
    x = torch.empty((batch, cfg["img_size"], cfg["img_size"], 3),
                    device="meta")
    walk = Walk()
    with torch.no_grad():
        forward(p, cfg, x, num=walk)
    return walk.convs


def conv_flops(cfg: dict) -> float:
    """Forward conv FLOPs of one image at cfg's size."""
    return sum(c[4] for c in conv_walk(cfg))
