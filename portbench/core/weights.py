"""Random weights from the seed, made on the device in a few large draws.

One flat normal draw gives every conv kernel, scaled by 1 / sqrt(fan
in), the heads' prediction kernels by 1.5 / sqrt(fan in). One flat
uniform draw gives the rest: conv biases U(-1 / sqrt(fan in), 1 / sqrt(fan
in)), BatchNorm scales U(0.2, 0.4), shifts and running means U(-0.2,
0.2), running variances U(0.5, 1.5); the prediction biases are the
objectness prior's (0 but -log(99) on objectness) plus U(-0.5, 0.5).

The BatchNorm scales keep the random network out of the chaotic regime a
trained one is not in: with scales about 1 each SiLU works far from its
linear part and the network amplifies rounding layer by layer (bfloat16
boxes 14% of an IoU from float32 at 'l', gradients 2-4% a leaf, and the
int8 path only ~2.5x worse than bfloat16); with 0.2-0.4 bfloat16 comes
within 2% and int8 and fp8 stay 5-10x worse. Shapes and work are the
same either way.

A served model also needs running statistics that fit its inputs, or
its activations grow or vanish layer by layer and every output sits at
the prior: `calibrate_batchnorm` sets them to the batch statistics of
one reference forward over the given images, as training leaves them.

All float32, keyed as the program's state dict
(`reference/model.py::param_shapes`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.model import (
    Numerics,
    forward,
    head_prior_bias,
    normalize,
    param_shapes,
)

PRED_GAIN = 1.5
BN_SCALE = (0.2, 0.4)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream `tag` of a run's `seed` (any whole
    number)."""
    words = [ord(c) for c in tag]
    return int(np.random.SeedSequence([seed % 2 ** 64, *words])
               .generate_state(1, np.uint64)[0]) >> 1


def make_state_dict(cfg: dict, seed: int, device) -> dict:
    """{key: float32 tensor on `device`}: the model's weights for `seed`."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    kernels = [k for k, s in shapes.items() if len(s) == 4]
    others = [k for k, s in shapes.items() if len(s) != 4]
    normal = torch.randn(sum(math.prod(shapes[k]) for k in kernels),
                         generator=gen, device=device)
    uniform = torch.rand(sum(math.prod(shapes[k]) for k in others),
                         generator=gen, device=device)
    out, i = {}, 0
    for k in kernels:
        n = math.prod(shapes[k])
        fan_in = math.prod(shapes[k][1:])
        gain = PRED_GAIN if k.endswith(".pred.weight") else 1.0
        out[k] = normal[i:i + n].view(shapes[k]) * (gain / math.sqrt(fan_in))
        i += n
    fans = {k.rsplit(".", 1)[0]: math.prod(shapes[k][1:]) for k in kernels}
    j = 0
    nc = cfg["num_classes"]
    for k in others:
        n = math.prod(shapes[k])
        u = uniform[j:j + n]
        j += n
        if k.endswith(".pred.bias"):
            v = head_prior_bias(nc).to(device) + (u - 0.5)
        elif k.endswith(".conv.bias"):
            bound = 1.0 / math.sqrt(fans[k.rsplit(".", 1)[0]])
            v = (2 * u - 1) * bound
        elif k.endswith(".bn.scale"):
            v = BN_SCALE[0] + u * (BN_SCALE[1] - BN_SCALE[0])
        elif k.endswith(".bn.var"):
            v = 0.5 + u
        else:  # BatchNorm shift and running mean
            v = (2 * u - 1) * 0.2
        out[k] = v.view(shapes[k])
    return {k: v.contiguous() for k, v in out.items()}


class _BatchStats(Numerics):
    """float32 numerics that normalise by batch statistics and record
    them."""

    def __init__(self):
        self.stats = {}

    def conv_bn_silu(self, p, c, x, train):
        y = self.conv(x, p[f"{c.name}.conv.weight"],
                      p.get(f"{c.name}.conv.bias"), c.stride, c.name)
        mean = y.mean(dim=(0, 2, 3))
        var = (y * y).mean(dim=(0, 2, 3)) - mean * mean
        self.stats[c.name] = (mean, var.clamp(min=0.0))
        q = dict(p)
        q[f"{c.name}.bn.mean"], q[f"{c.name}.bn.var"] = self.stats[c.name]
        return super().conv_bn_silu(q, c, x, False)


@torch.no_grad()
def calibrate_batchnorm(p: dict, cfg: dict, images_u8) -> dict:
    """`p` with every BatchNorm's running mean and variance replaced by
    the batch statistics of a float32 forward over `images_u8` (NHWC
    uint8 on p's device)."""
    rec = _BatchStats()
    forward(p, cfg, normalize(images_u8), train=False, num=rec)
    out = dict(p)
    for name, (mean, var) in rec.stats.items():
        out[f"{name}.bn.mean"], out[f"{name}.bn.var"] = mean, var
    return out
