"""Plain reference of post-training integer quantization of the serving
model: calibration, BatchNorm folding and the quantized conv + SiLU, at
8 bits (the int8 configuration) or 4 (its control).

- Calibration: the float32 model's forward over the calibration images;
  each conv + BN + SiLU's input abs-max, the max over batches, gives its
  activation scale amax / qmax (qmax = 2^(bits-1) - 1).
- Folding: W' = W * gamma / sqrt(var + eps) per output channel, b' = (b0
  - mean) * gamma / sqrt(var + eps) + beta.
- Weights: symmetric per output channel, scale max|W'_c| / qmax, rounded
  half to even and clipped to [-qmax, qmax].
- A quantized layer: x_q = clip(round(x / a_scale)), acc = conv(x_q, w_q)
  on the integers (in float32 with TF32 off: exact up to 2^24, a relative
  1e-7 beyond), y = silu(acc * a_scale * w_scale + b').
- The first conv (`stem0`) and the heads' prediction convs stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.model import BN_EPS, Conv, Numerics, forward

FLOAT_LAYERS = ("stem0",)


class _Calibrate(Numerics):
    def __init__(self):
        self.amax = {}

    def conv_bn_silu(self, p, c, x, train):
        m = float(x.detach().abs().amax())
        self.amax[c.name] = max(self.amax.get(c.name, 0.0), m)
        return super().conv_bn_silu(p, c, x, train)


def calibrate(p: dict, cfg: dict, batches) -> dict:
    """{layer: input abs-max} over float32 NHWC batches in [0, 1]."""
    cal = _Calibrate()
    with torch.no_grad():
        for x in batches:
            forward(p, cfg, x, train=False, num=cal)
    return cal.amax


def fold(p: dict, name: str):
    """(W', b') of a conv + BN layer in eval mode."""
    w = p[f"{name}.conv.weight"]
    b0 = p.get(f"{name}.conv.bias")
    if b0 is None:
        b0 = torch.zeros(w.shape[0], device=w.device)
    f = p[f"{name}.bn.scale"] / torch.sqrt(p[f"{name}.bn.var"] + BN_EPS)
    return (w * f.view(-1, 1, 1, 1),
            (b0 - p[f"{name}.bn.mean"]) * f + p[f"{name}.bn.bias"])


class QuantNumerics(Numerics):
    """The forward with every conv + BN + SiLU but `FLOAT_LAYERS` run on
    `bits`-bit integers."""

    def __init__(self, p: dict, amax: dict, bits: int = 8):
        self.qmax = 2 ** (bits - 1) - 1
        self.layers = {}
        for name, m in amax.items():
            if name in FLOAT_LAYERS:
                continue
            w, b = fold(p, name)
            w_scale = w.abs().amax(dim=(1, 2, 3)).clamp(min=1e-12) / self.qmax
            wq = torch.clamp(torch.round(w / w_scale.view(-1, 1, 1, 1)),
                             -self.qmax, self.qmax)
            self.layers[name] = (max(m, 1e-8) / self.qmax, wq, w_scale, b)

    def conv_bn_silu(self, p, c: Conv, x, train):
        if c.name not in self.layers:
            return super().conv_bn_silu(p, c, x, train)
        a_scale, wq, w_scale, b = self.layers[c.name]
        xq = torch.clamp(torch.round(x / a_scale), -self.qmax, self.qmax)
        acc = F.conv2d(xq, wq, None, c.stride, c.k // 2)
        return F.silu(acc * (a_scale * w_scale).view(1, -1, 1, 1)
                      + b.view(1, -1, 1, 1))
