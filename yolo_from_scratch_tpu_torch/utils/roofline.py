"""Least device time for a kernel's work on one NVIDIA H100 SXM, from the
data sheet (dense rates, 700 W): the larger of the bytes the function must
move over the memory rate and its operations over the peak rate for their
type. Each input byte counts as read once and each output byte as written
once, whatever the kernel reads again; where the work depends on the data
(the NMS walk), the caller counts what the run's data needs. These are
bounds computed from shapes, never measurements. (The JAX package's
`utils/roofline.py` bounds the model's convs on a TPU; this module bounds
the port's hand-written kernels on the H100.)
"""

from __future__ import annotations

import torch

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
    type (4 bytes for the raw int32)."""
    ho = (h + 2 * (k // 2) - k) // stride + 1
    wo = (w + 2 * (k // 2) - k) // stride + 1
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
