"""Building blocks: Conv+BN+SiLU, Bottleneck, C3 (CSP), SPPF (counterpart
of `yolo_from_scratch_tpu/models/blocks.py`).

Modules take NCHW tensors. Submodule names are the JAX package's, so its
parameter path `a/b/conv/kernel` is the state-dict key `a.b.conv.weight`.
Every parameter is float32 (the master weights an optimizer updates); the
convolutions cast weight and bias to the compute dtype at use, as flax's
`promote_dtype` does (a no-op in float32). `Predictor` casts its conv
weights once at load instead, so serving launches no cast.

Inside `parallel/mesh.py::data_parallel` with a 2-D mesh each tensor is
this rank's block of rows (`--spatial`), and every op that reads across
rows takes its neighbours' rows first (`parallel/spatial.py::
halo_rows`): a 3x3 conv 1 row above and 1 below (at stride 2, 1 above
only: its symmetric padding of 1 reads rows 2i-1 .. 2i+1, and the local
heights are even), each 5x5 pool of SPPF 2 and 2 of -inf. The conv then
pads the columns alone. Upsample, concat and 1x1 convs stay local.
A rank whose block holds no rows (a P5 grid smaller than the space axis)
runs each op on a tile padded to the op's size and keeps no output row
(`parallel/spatial.py::fit_rows`), so that it joins every exchange.
Without a space axis nothing changes.

On a `data x model` mesh (`--model-parallel N`) a conv that
`parallel/tensor.py::shard_model_` cut holds its rows of the output
channels (`ConvBNSiLU.tp`, a prediction conv's `tp`): its input passes
`model_input` (backward: dx summed over the model group), it computes its
channels, and its output is gathered whole (`gather_channels`), so every
other op runs on whole tensors, as in one process.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from yolo_from_scratch_tpu_torch.models.fused_bn import BNSiLU
from yolo_from_scratch_tpu_torch.ops.conv_bwd import (
    conv3x3_same,
    use_fused_bwd,
)
from yolo_from_scratch_tpu_torch.parallel.mesh import global_rows, spatial_mesh
from yolo_from_scratch_tpu_torch.parallel.spatial import fit_rows, halo_rows
from yolo_from_scratch_tpu_torch.parallel.tensor import (
    conv3x3_same_tp,
    gather_channels,
    model_input,
)


def cast(t, dtype):
    """t in `dtype`; t itself, with no op dispatched, when it already is
    (serving: `Predictor` casts its conv weights once at load)."""
    return t if t is None or t.dtype == dtype else t.to(dtype)


def uniform_fan_in_(t, fan_in, generator):
    """The PyTorch Conv2d default the JAX package copies
    (`torch_kernel_init`, `torch_bias_init_for`): U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), drawn on the CPU from `generator`."""
    bound = 1.0 / math.sqrt(fan_in)
    draw = torch.rand(t.shape, generator=generator, dtype=torch.float32)
    with torch.no_grad():
        t.copy_(draw * (2 * bound) - bound)


class ConvBNSiLU(nn.Module):
    """Conv2d + BatchNorm + SiLU.

    `use_bias=False` matches the reference's ConvBlock; `use_bias=True`
    its raw `nn.Conv2d + BN + SiLU` stem/downsample and SPPF convs, which
    keep the (redundant) conv bias before BN. `dtype` is the compute dtype;
    `self.conv` holds the float32 parameters and their stride and padding.
    A conv that `use_fused_bwd` selects runs `conv3x3_same`: the same
    forward, the fused backward. On a row block (`--spatial`) the gate
    reads the global height (the block plan's, `parallel/mesh.py::
    global_rows`), so that the same convs are selected as in one process
    on every rank, and `conv3x3_same` runs unchanged on the haloed tile
    (h + 2 rows) of which the first and last output rows are dropped: its
    backward then gets zero dy there, so its dW is exact, and the halo
    rows' dx goes back through the exchange.

    Cut for a model mesh (`tp`, the mesh; None for a whole conv) the conv
    and its BatchNorm hold this rank's rows of the output channels, and
    the output is gathered over the model group after the SiLU. The gate
    then reads the global cout, so the same convs are selected as in one
    process; a selected conv runs `conv3x3_same_tp`, whose backward runs
    the fused backward at the global shapes on the gathered dy and weight
    and returns the whole dx (its input takes no `model_input`).

    A packed conv (`models/packed.py`) runs these forwards through the
    two hooks it overrides: `conv_args` (its packed kernel, stride and
    asymmetric padding) and `gathered` (its phase-major channel order).
    """

    def __init__(self, cin, features, kernel=1, stride=1, use_bias=False,
                 dtype=None, device=None):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.conv = nn.Conv2d(cin, features, kernel, stride,
                              padding=kernel // 2, bias=use_bias,
                              dtype=torch.float32, device=device)
        self.bn = BNSiLU(features, device=device)
        self.tp = None

    def reset_parameters(self, generator):
        k = self.conv.kernel_size[0]
        fan_in = self.conv.in_channels * k * k
        uniform_fan_in_(self.conv.weight, fan_in, generator)
        if self.conv.bias is not None:
            uniform_fan_in_(self.conv.bias, fan_in, generator)
        self.bn.reset_parameters()

    def gate_shape(self, x):
        """The arguments of K2's gate (`ops/conv_bwd.py::use_fused_bwd`)
        for input x: kernel, stride, cin, the global cout (a model mesh's
        slice times its ranks), the global height, width and the compute
        dtype; None for a conv with a bias, which the gate never takes."""
        conv = self.conv
        if conv.bias is not None:
            return None
        n_model = self.tp.n_model if self.tp is not None else 1
        return (conv.kernel_size[0], conv.stride[0], x.shape[1],
                conv.weight.shape[0] * n_model,
                global_rows(x.shape[2], x.shape[3]), x.shape[3], self.dtype)

    def conv_args(self):
        """(weight, bias, k, stride, (low, high) padding) of the conv that
        runs, weight and bias in the compute dtype; a packed conv
        (`models/packed.py`) answers with its packed kernel."""
        conv = self.conv
        k, pad = conv.kernel_size[0], conv.padding[0]
        return (cast(conv.weight, self.dtype), cast(conv.bias, self.dtype),
                k, conv.stride[0], (pad, k - 1 - pad))

    def gathered(self, y):
        """The output gathered over the model group, in the layer's channel
        order: as gathered here; a packed conv permutes it."""
        return y

    def forward(self, x, train: bool = False):
        if self.tp is not None:
            return self._forward_tp(x, train)
        w, bias, k, stride, pad = self.conv_args()
        mesh = spatial_mesh()
        gate = self.gate_shape(x)
        gated = gate is not None and use_fused_bwd(*gate)
        if gated and (mesh is None or x.shape[2]):
            # a rank without rows takes the row-block conv below
            if mesh is None:
                y = conv3x3_same(x, w)
            else:
                y = conv3x3_same(halo_rows(x, 1, 1, 0.0, mesh), w)[:, :, 1:-1]
            if bias is not None:  # a packed conv's; the gate takes it
                y = y + bias.view(1, -1, 1, 1)
        elif mesh is None:
            y = _conv(x, w, bias, stride, pad)
        else:
            # output row o reads input rows o*stride - pad[0] .. + k - 1:
            # the block's outputs read pad[0] rows above it and
            # k - stride - pad[0] below (a rank without rows: its halo,
            # and no output row)
            if k > 1:
                x = halo_rows(x, pad[0], k - stride - pad[0], 0.0, mesh)
            y = fit_rows(lambda t: _conv(t, w, bias, stride, pad, rows=False),
                         x, k)
        return self.bn(y, train)

    def _forward_tp(self, x, train):
        mesh = self.tp
        w, bias, _, stride, pad = self.conv_args()
        gate = self.gate_shape(x)
        if gate is not None and use_fused_bwd(*gate):
            y = conv3x3_same_tp(x, w, mesh)
            if bias is not None:
                y = y + bias.view(1, -1, 1, 1)
        else:
            y = _conv(model_input(x, mesh), w, bias, stride, pad)
        return self.gathered(gather_channels(self.bn(y, train), mesh))


def _conv(x, w, bias, stride, pad, rows=True):
    """F.conv2d at `stride`, padded pad = (low, high) on both axes, or on
    the columns alone (`rows=False`: a row block, whose halo rows are its
    row padding)."""
    lo, hi = pad
    if lo == hi:
        return F.conv2d(x, w, bias, stride, (lo if rows else 0, lo))
    return F.conv2d(F.pad(x, (lo, hi, lo, hi) if rows else (lo, hi)), w,
                    bias, stride)


def pred_conv(conv, x, dtype):
    """A head's raw 1x1 prediction conv with bias on NCHW x, in `dtype`;
    cut for a model mesh (`conv.tp`), this rank's channels gathered after
    the bias."""
    mesh = getattr(conv, "tp", None)
    w, b = cast(conv.weight, dtype), cast(conv.bias, dtype)
    if mesh is None:
        # a row block of no rows (`--spatial`) keeps its place in the graph
        return fit_rows(lambda t: F.conv2d(t, w, b), x, 1)
    return gather_channels(F.conv2d(model_input(x, mesh), w, b), mesh)


class Bottleneck(nn.Module):
    """Two 3x3 ConvBNSiLU with a residual add. The model builds only the
    JAX package's shortcut=True, cin == cout case, which always adds."""

    def __init__(self, features, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = ConvBNSiLU(features, features, 3, **kw)
        self.conv2 = ConvBNSiLU(features, features, 3, **kw)

    def forward(self, x, train: bool = False):
        return x + self.conv2(self.conv1(x, train), train)


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions: hidden = features // 2; path 1
    runs `n` Bottlenecks, path 2 is a 1x1; concat then 1x1 project."""

    def __init__(self, cin, features, n=1, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        hidden = features // 2
        self.conv1 = ConvBNSiLU(cin, hidden, 1, **kw)
        self.n = n
        for i in range(n):
            self.add_module(f"bottleneck{i}",
                            Bottleneck(hidden, **kw))
        self.conv2 = ConvBNSiLU(cin, hidden, 1, **kw)
        self.conv3 = ConvBNSiLU(2 * hidden, features, 1, **kw)

    def forward(self, x, train: bool = False):
        x1 = self.conv1(x, train)
        for i in range(self.n):
            x1 = getattr(self, f"bottleneck{i}")(x1, train)
        x2 = self.conv2(x, train)
        return self.conv3(torch.cat([x1, x2], dim=1), train)


def maxpool_same(x, k: int):
    """k x k stride-1 SAME max pool with -inf padding; `F.max_pool2d`
    pads with -inf, so this is the forward of the JAX `_maxpool_same`. On
    a row block the k // 2 rows above and below come from the neighbours
    (-inf beyond the image), and only the columns are padded."""
    mesh = spatial_mesh()
    if mesh is None:
        return F.max_pool2d(x, k, 1, k // 2)
    x = halo_rows(x, k // 2, k // 2, -torch.inf, mesh)
    return fit_rows(lambda t: F.max_pool2d(t, k, 1, (0, k // 2)), x, k,
                    -torch.inf)


class SPPF(nn.Module):
    """Spatial Pyramid Pooling - Fast: 1x1 reduce to cin//2, three
    sequential 5x5 stride-1 max pools, concat [x, y1, y2, y3], 1x1 out.
    Both convs carry a bias, as the reference's raw nn.Conv2d do."""

    def __init__(self, cin, features, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        hidden = cin // 2
        self.conv1 = ConvBNSiLU(cin, hidden, 1, use_bias=True, **kw)
        self.conv2 = ConvBNSiLU(4 * hidden, features, 1, use_bias=True, **kw)

    def forward(self, x, train: bool = False):
        x = self.conv1(x, train)
        y1 = maxpool_same(x, 5)
        y2 = maxpool_same(y1, 5)
        y3 = maxpool_same(y2, 5)
        return self.conv2(torch.cat([x, y1, y2, y3], dim=1), train)


def upsample_nearest_2x(x):
    """Nearest-neighbor 2x upsample of an NCHW tensor (of a row block of
    no rows too, `fit_rows`)."""
    return fit_rows(lambda t: F.interpolate(t, scale_factor=2,
                                            mode="nearest"), x, 1)
