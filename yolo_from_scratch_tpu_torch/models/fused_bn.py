"""BatchNorm+SiLU tail with the JAX package's fused train-mode backward
(counterpart of `yolo_from_scratch_tpu/models/fused_bn.py`).

Holds the JAX package's parameter and statistic names (`scale`, `bias`
/ `mean`, `var`), so checkpoints convert leaf for leaf, and keeps its op
order: `mul = rsqrt(var + eps) * scale`, then `z = (x - mean) * mul + bias` in
float32, cast to the compute dtype, then SiLU in that dtype.

Train mode is `bn_silu_train`, a `torch.autograd.Function` with the math
of the JAX `custom_vjp`: float32 fast-variance batch statistics
(`mean(x^2) - mean(x)^2` clipped at 0), and a backward that saves only the
conv output and the per-channel vectors and recomputes the elementwise
chain,

    dx = scale * r * (dz - mean(dz) - xhat * mean(dz * xhat)),

with the SiLU gradient `s * (1 + z * (1 - s))` in the compute dtype. The
running statistics move with momentum 0.9 towards the BIASED batch
variance, as flax does; `nn.BatchNorm2d` would use the unbiased one.

Inside `parallel/mesh.py::data_parallel` the statistics are the global
batch's, as BatchNorm over a batch sharded on the JAX mesh's data axis
computes them: each rank's per-channel means of x and x^2, times its
share of the global batch, are summed over the ranks in one all-reduce
before the variance is formed, and the backward sums the per-channel
sums behind mean(dz) and mean(dz * xhat) over the ranks (the gradients of
scale and bias stay this rank's part; the step sums them with the rest).
The running statistics then move by the global mean and variance, equal
on every rank. On a 2-D mesh (`--spatial`) each rank holds a block of
rows of its data shard's batch. Where the blocks are equal the same
shares of 1 / world over the world group give the statistics of the
whole global batch, data x space (`tests/test_torch_spatial.py` holds
them); where they differ (`parallel/mesh.py::uneven`) each rank's sums
over the global count do (`global_elements`; a rank without rows adds
zeros), and the backward's means divide by that count.
On a `data x model` mesh (`--model-parallel`) a channel-sharded conv's
BatchNorm holds its slice of the channels, and the ranks of a model group
hold one batch: the statistics of the slice are reduced over the data
group alone, with shares of 1 / n_data (`parallel/mesh.py::reduce_mesh`).
Without an active mesh, or on a model mesh of one data shard, no
collective is issued.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from yolo_from_scratch_tpu_torch.parallel.mesh import (
    all_reduce,
    global_elements,
    reduce_mesh,
    uneven,
)

BN_MOMENTUM = 0.9
BN_EPS = 1e-5
_C = (1, -1, 1, 1)  # a per-channel vector against an NCHW tensor


def _stats(x, mesh=None, count=None):
    """float32 fast-variance batch statistics per channel of NCHW x, over
    `mesh`'s global batch when one is given: equal local batches, or
    unequal row blocks of `count` elements a channel in all."""
    xf = x.float()
    if mesh is not None and uneven():
        sums = torch.stack([xf.sum(dim=(0, 2, 3)),
                            torch.square(xf).sum(dim=(0, 2, 3))])
        mu, mu2 = all_reduce(sums / count, mesh).unbind()
        return mu, torch.clamp(mu2 - torch.square(mu), min=0.0)
    mu = xf.mean(dim=(0, 2, 3))
    mu2 = torch.square(xf).mean(dim=(0, 2, 3))
    if mesh is not None:
        # a local mean times the local share, summed: at one rank the
        # product by 1.0 and the sum of one are exact, so the statistics
        # stay those of the run without a group bit for bit
        mu, mu2 = all_reduce(torch.stack([mu, mu2]) * (1.0 / mesh.size),
                             mesh).unbind()
    return mu, torch.clamp(mu2 - torch.square(mu), min=0.0)


def _affine_silu(x, mu, var, scale, bias, eps):
    mul = torch.rsqrt(var + eps) * scale
    z = ((x.float() - mu.view(_C)) * mul.view(_C) + bias.view(_C)).to(x.dtype)
    return F.silu(z)


class _BNSiLUTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.mesh = reduce_mesh()
        # the global batch's elements a channel: (B, h, W) blocks, rows at 1
        ctx.count = global_elements(x[:, 0])
        mu, var = _stats(x, ctx.mesh, ctx.count)
        ctx.save_for_backward(x, mu, var, scale, bias)
        ctx.eps = eps
        ctx.mark_non_differentiable(mu, var)
        return _affine_silu(x, mu, var, scale, bias, eps), mu, var

    @staticmethod
    def backward(ctx, dy, _dmu, _dvar):
        x, mu, var, scale, bias = ctx.saved_tensors
        r = torch.rsqrt(var + ctx.eps)
        xhat = (x.float() - mu.view(_C)) * r.view(_C)
        z = (xhat * scale.view(_C) + bias.view(_C)).to(x.dtype)
        s = torch.sigmoid(z)
        dz = (dy * (s * (1.0 + z * (1.0 - s)))).float()
        m = ctx.count
        dbeta = dz.sum(dim=(0, 2, 3))
        dgamma = (dz * xhat).sum(dim=(0, 2, 3))
        sum_dz, sum_dzx = dbeta, dgamma
        if ctx.mesh is not None:
            # the global means of dz and dz * xhat (the backward's
            # all-reduces run in the same order on every rank)
            sum_dz, sum_dzx = all_reduce(torch.stack([dbeta, dgamma]),
                                         ctx.mesh).unbind()
        dx = (scale * r).view(_C) * (dz - (sum_dz / m).view(_C)
                                     - xhat * (sum_dzx / m).view(_C))
        return dx.to(x.dtype), dgamma, dbeta, None


def bn_silu_train(x, scale, bias, eps=BN_EPS):
    """Train-mode fused BatchNorm+SiLU over NCHW x. Returns (y, mean,
    var); mean and var feed the (undifferentiated) running-stat update."""
    return _BNSiLUTrain.apply(x, scale, bias, eps)


class BNSiLU(nn.Module):
    """`BatchNorm -> silu` over the channel axis of an NCHW tensor."""

    def __init__(self, features, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(features, **f32))
        self.bias = nn.Parameter(torch.zeros(features, **f32))
        self.register_buffer("mean", torch.zeros(features, **f32))
        self.register_buffer("var", torch.ones(features, **f32))

    def reset_parameters(self):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x, train: bool = False):
        if not train:
            return _affine_silu(x, self.mean, self.var, self.scale, self.bias,
                                BN_EPS)
        y, mu, var = bn_silu_train(x, self.scale, self.bias, BN_EPS)
        with torch.no_grad():
            self.mean.copy_(BN_MOMENTUM * self.mean + (1.0 - BN_MOMENTUM) * mu)
            self.var.copy_(BN_MOMENTUM * self.var + (1.0 - BN_MOMENTUM) * var)
        return y
