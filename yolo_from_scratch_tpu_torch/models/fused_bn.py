"""BatchNorm+SiLU tail, eval mode (counterpart of
`yolo_from_scratch_tpu/models/fused_bn.py`).

Holds the JAX package's parameter and statistic names (`scale`, `bias`
/ `mean`, `var`), so checkpoints convert leaf for leaf, and keeps its op
order: `mul = rsqrt(var + eps) * scale`, then `z = (x - mean) * mul + bias` in
float32, cast to the compute dtype, then SiLU in that dtype. Not
`nn.BatchNorm2d`, whose running variance update differs from the JAX
package's (unbiased vs biased), which matters once training is ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


class BNSiLU(nn.Module):
    """`BatchNorm -> silu` over the channel axis of an NCHW tensor. Eval
    mode only: the train-mode statistics, their momentum update and the
    fused backward come with the training port."""

    def __init__(self, features, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(features, **f32))
        self.bias = nn.Parameter(torch.zeros(features, **f32))
        self.register_buffer("mean", torch.zeros(features, **f32))
        self.register_buffer("var", torch.ones(features, **f32))

    def forward(self, x, train: bool = False):
        if train:
            raise NotImplementedError("training is ported in a later PR")
        mul = torch.rsqrt(self.var + BN_EPS) * self.scale
        c = (1, -1, 1, 1)
        z = ((x.float() - self.mean.view(c)) * mul.view(c)
             + self.bias.view(c)).to(x.dtype)
        return F.silu(z)
