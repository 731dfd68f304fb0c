"""Plain float32 reference of the yolo-from-scratch detector: the
YOLOv5-style CSP backbone, SPPF, FPN + PANet neck and three anchor heads
of KhaledSharif/yolo-from-scratch (train.py:336-397), written as
functions of a flat state dict of tensors.

It imports nothing of the program under test. The state-dict keys are
those the program's `state_dict()` uses (`stem0.conv.weight`,
`bb_p3_c3a.bottleneck0.conv1.bn.scale`, `head_p3.pred.bias`, ...), so one
dict made by the benchmark feeds both; `layers(cfg)` lists every conv
with its shapes, and `param_shapes(cfg)` every tensor of that dict.

A conv + BatchNorm + SiLU and a head's 1x1 prediction conv go through a
`Numerics` object, which says how the arithmetic is done: `Numerics`
itself is float32 (TF32 is the caller's to switch off), `Fp8Numerics`
rounds both operands of every conv, and the gradient flowing into it, to
fp8 with a per-tensor scale (the control of a bfloat16 training cell),
and `reference/quant.py` holds the int8 / int4 forward. Layout: images
NHWC in, NCHW inside, head outputs (B, H, W, A, 5 + nc) float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
STRIDES = (8, 16, 32)
ANCHORS_PX = ((10, 13), (16, 30), (33, 23),
              (30, 61), (62, 45), (59, 119),
              (116, 90), (156, 198), (373, 326))
NUM_ANCHORS = 3


def divisible(x: float, width: float, divisor: int = 8) -> int:
    """Channels scaled by the width multiplier, rounded up to 8."""
    return int(math.ceil(x * width / divisor) * divisor)


def repeats(n: int, depth: float) -> int:
    """Bottlenecks of a C3 block scaled by the depth multiplier."""
    return max(round(n * depth), 1) if n > 1 else n


@dataclasses.dataclass(frozen=True)
class Conv:
    """One conv of the model: `name` its state-dict prefix, a k x k conv
    at `stride`, `bias` on the conv itself, `bn` False for a head's plain
    prediction conv."""

    name: str
    cin: int
    cout: int
    k: int
    stride: int = 1
    bias: bool = False
    bn: bool = True


def _c3(name, cin, cout, n):
    hidden = cout // 2
    out = [Conv(f"{name}.conv1", cin, hidden, 1)]
    for i in range(n):
        out += [Conv(f"{name}.bottleneck{i}.conv1", hidden, hidden, 3),
                Conv(f"{name}.bottleneck{i}.conv2", hidden, hidden, 3)]
    return out + [Conv(f"{name}.conv2", cin, hidden, 1),
                  Conv(f"{name}.conv3", 2 * hidden, cout, 1)]


def layers(cfg: dict) -> list[Conv]:
    """Every conv of the model in forward order, from the configuration's
    width_mult, depth_mult and num_classes."""
    w, d, nc = cfg["width_mult"], cfg["depth_mult"], cfg["num_classes"]
    cs, c3, c4, c5 = (divisible(c, w) for c in (64, 128, 256, 512))
    r1, r2 = repeats(1, d), repeats(2, d)
    out = [Conv("stem0", 3, cs // 2, 3, 2, True),
           Conv("stem1", cs // 2, cs, 3, 2, True),
           *_c3("bb_p3_c3a", cs, cs, r1),
           Conv("bb_p3_down", cs, c3, 3, 2, True),
           *_c3("bb_p3_c3b", c3, c3, r2),
           Conv("bb_p4_down", c3, c4, 3, 2, True),
           *_c3("bb_p4_c3", c4, c4, r2),
           Conv("bb_p5_down", c4, c5, 3, 2, True),
           *_c3("bb_p5_c3", c5, c5, r1),
           Conv("sppf.conv1", c5, c5 // 2, 1, 1, True),
           Conv("sppf.conv2", 4 * (c5 // 2), c5, 1, 1, True),
           Conv("lateral_p4", c4, c4, 1),
           Conv("lateral_p3", c3, c3, 1),
           Conv("reduce_p5_for_p4", c5, c4, 1),
           *_c3("merge_p4", 2 * c4, c4, r1),
           Conv("reduce_p4_for_p3", c4, c3, 1),
           *_c3("merge_p3", 2 * c3, c3, r1),
           Conv("downsample_p3_to_p4", c3, c3, 3, 2),
           *_c3("panet_merge_p4", c3 + c4, c4, r1),
           Conv("downsample_p4_to_p5", c4, c4, 3, 2),
           *_c3("panet_merge_p5", c4 + c5, c5, r1)]
    for head, c in zip(("head_p3", "head_p4", "head_p5"), (c3, c4, c5)):
        out += [Conv(f"{head}.conv1", c, c, 3), Conv(f"{head}.conv2", c, c, 3),
                Conv(f"{head}.pred", c, NUM_ANCHORS * (5 + nc), 1, 1, True,
                     bn=False)]
    return out


def param_shapes(cfg: dict) -> dict:
    """{key: shape} of every tensor of the state dict, parameters and the
    BatchNorm statistics; `is_param(key)` tells them apart."""
    shapes = {}
    for c in layers(cfg):
        conv = f"{c.name}.conv" if c.bn else c.name
        shapes[f"{conv}.weight"] = (c.cout, c.cin, c.k, c.k)
        if c.bias:
            shapes[f"{conv}.bias"] = (c.cout,)
        if c.bn:
            for leaf in ("scale", "bias", "mean", "var"):
                shapes[f"{c.name}.bn.{leaf}"] = (c.cout,)
    return shapes


def is_param(key: str) -> bool:
    """True for trained parameters, False for BatchNorm's running
    statistics."""
    return not key.endswith((".bn.mean", ".bn.var"))


def head_prior_bias(nc: int) -> torch.Tensor:
    """A fresh head's prediction bias: 0 but -log(99) on each anchor's
    objectness channel (an objectness prior of 0.01)."""
    bias = torch.zeros(NUM_ANCHORS, 5 + nc)
    bias[:, 4] = -math.log(99.0)
    return bias.reshape(-1)


class Numerics:
    """float32 arithmetic: conv, then BatchNorm (batch statistics in
    training, the running ones otherwise), then SiLU."""

    def conv(self, x, w, b, stride, name):
        return F.conv2d(x, w, b, stride, w.shape[-1] // 2)

    def conv_bn_silu(self, p, c: Conv, x, train):
        y = self.conv(x, p[f"{c.name}.conv.weight"],
                      p.get(f"{c.name}.conv.bias"), c.stride, c.name)
        scale, shift = p[f"{c.name}.bn.scale"], p[f"{c.name}.bn.bias"]
        if train:
            mean = y.mean(dim=(0, 2, 3))
            var = (y * y).mean(dim=(0, 2, 3)) - mean * mean
        else:
            mean, var = p[f"{c.name}.bn.mean"], p[f"{c.name}.bn.var"]
        inv = torch.rsqrt(var.clamp(min=0.0) + BN_EPS) * scale
        y = (y - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1) \
            + shift.view(1, -1, 1, 1)
        return F.silu(y)

    def pred(self, p, c: Conv, x):
        return self.conv(x, p[f"{c.name}.weight"], p[f"{c.name}.bias"], 1,
                         c.name)


def _fp8(t, dtype):
    """t rounded to the fp8 format `dtype` with a per-tensor scale that
    maps its largest magnitude to the format's largest value."""
    top = torch.finfo(dtype).max
    scale = t.detach().abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8Conv(torch.autograd.Function):
    """A conv whose operands are rounded to e4m3 and whose incoming
    gradient is rounded to e5m2, products and sums in float32."""

    @staticmethod
    def forward(ctx, x, w, b, stride):
        xq, wq = _fp8(x, torch.float8_e4m3fn), _fp8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        ctx.stride, ctx.has_bias = stride, b is not None
        return F.conv2d(xq, wq, b, stride, w.shape[-1] // 2)

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dy = _fp8(dy, torch.float8_e5m2)
        pad = wq.shape[-1] // 2
        dx = torch.nn.grad.conv2d_input(xq.shape, wq, dy, ctx.stride, pad)
        dw = torch.nn.grad.conv2d_weight(xq, wq.shape, dy, ctx.stride, pad)
        db = dy.sum(dim=(0, 2, 3)) if ctx.has_bias else None
        return dx, dw, db, None


class Fp8Numerics(Numerics):
    """Every conv, the prediction convs too, computed on fp8 operands."""

    def conv(self, x, w, b, stride, name):
        return _Fp8Conv.apply(x, w, b, stride)


def _upsample(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _pool(x):
    return F.max_pool2d(x, 5, 1, 2)


def forward(p: dict, cfg: dict, images, train: bool = False,
            num: Numerics | None = None):
    """Head outputs [P3, P4, P5], each (B, H, W, A, 5 + nc) float32, of
    NHWC float32 `images` in [0, 1]. `p`: the state dict."""
    num = num or Numerics()
    convs = {c.name: c for c in layers(cfg)}

    def cbs(name, x):
        return num.conv_bn_silu(p, convs[name], x, train)

    def c3(name, x):
        x1 = cbs(f"{name}.conv1", x)
        i = 0
        while f"{name}.bottleneck{i}.conv1" in convs:
            x1 = x1 + cbs(f"{name}.bottleneck{i}.conv2",
                          cbs(f"{name}.bottleneck{i}.conv1", x1))
            i += 1
        x2 = cbs(f"{name}.conv2", x)
        return cbs(f"{name}.conv3", torch.cat([x1, x2], dim=1))

    def head(name, x):
        x = cbs(f"{name}.conv2", cbs(f"{name}.conv1", x))
        y = num.pred(p, convs[f"{name}.pred"], x)
        b, _, h, w = y.shape
        return y.permute(0, 2, 3, 1).reshape(b, h, w, NUM_ANCHORS, -1)

    x = images.permute(0, 3, 1, 2)
    x = cbs("stem1", cbs("stem0", x))
    x = cbs("bb_p3_down", c3("bb_p3_c3a", x))
    p3 = c3("bb_p3_c3b", x)
    p4 = c3("bb_p4_c3", cbs("bb_p4_down", p3))
    x = c3("bb_p5_c3", cbs("bb_p5_down", p4))
    x = cbs("sppf.conv1", x)
    y1 = _pool(x)
    y2 = _pool(y1)
    p5 = cbs("sppf.conv2", torch.cat([x, y1, y2, _pool(y2)], dim=1))

    p4_fpn = c3("merge_p4", torch.cat(
        [_upsample(cbs("reduce_p5_for_p4", p5)), cbs("lateral_p4", p4)], 1))
    p3_fpn = c3("merge_p3", torch.cat(
        [_upsample(cbs("reduce_p4_for_p3", p4_fpn)), cbs("lateral_p3", p3)],
        1))
    p4_pan = c3("panet_merge_p4", torch.cat(
        [cbs("downsample_p3_to_p4", p3_fpn), p4_fpn], 1))
    p5_pan = c3("panet_merge_p5", torch.cat(
        [cbs("downsample_p4_to_p5", p4_pan), p5], 1))
    return [head("head_p3", p3_fpn), head("head_p4", p4_pan),
            head("head_p5", p5_pan)]


def normalize(images_u8):
    """uint8 NHWC images -> float32 in [0, 1] (times the float32 value of
    1 / 255)."""
    return images_u8.float() * torch.tensor(1.0 / 255.0, dtype=torch.float32,
                                            device=images_u8.device)
