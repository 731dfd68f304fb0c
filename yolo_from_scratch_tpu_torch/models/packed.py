"""Space-to-depth packed layouts: the same model math on packed tensors
(counterpart of `yolo_from_scratch_tpu/models/packed.py`).

A map packed by f holds pixel phase (a, b) of each f x f cell on the
channel axis: packed channel (a*f + b)*C + c, phase-major. The host packs
the input image 4x (`pack_s2d_host`, (B, S/4, S/4, 48)); the stem's
stride-2 3x3 convs then run as stride-1 2x2 convs on packed maps, and with
`packed_interior` / `packed_p3` the 160x160 and 80x80 stages run packed
2x2 (`PackedC3`, `GPackedConvBNSiLU`): thin wide maps become narrow maps
with 4x the channels (the 16-channel C3a 3x3s become 64 -> 64 convs, which
K2's gate, `ops/conv_bwd.py::use_fused_bwd`, then selects).

Every packed conv keeps the canonical parameters of the `ConvBNSiLU` it
replaces (`conv.weight` OIHW, `conv.bias`, `bn.scale`, `bn.bias`, `bn.mean`,
`bn.var`, same names and shapes), so state dicts, checkpoints of either
package and `--resume` carry packed and unpacked models alike. Its packed
kernel is a gather from the float32 canonical weight: an index map, built
once at construction by running the JAX package's rewrite on an iota,
points each packed tap at a canonical tap or at a zero slot of its own.
The forward gathers, then casts to the compute dtype (JAX's order);
autograd's scatter-add of the gather carries the packed kernel's gradient
back to the canonical one. BatchNorm reduces over batch, space and phases per
canonical channel (`models/fused_bn.py`, `phases`).

Inside the port tensors are NCHW: the NHWC host layout permutes to NCHW
with the packed channel order unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolo_from_scratch_tpu_torch.models.blocks import ConvBNSiLU, cast
from yolo_from_scratch_tpu_torch.models.fused_bn import BNSiLU
from yolo_from_scratch_tpu_torch.ops.conv_bwd import (
    conv3x3_same,
    use_fused_bwd,
)

PACK_FACTOR = 4  # the model input's space-to-depth factor when packed


def pack_s2d_host(x: np.ndarray, f: int = PACK_FACTOR) -> np.ndarray:
    """Space-to-depth on the host: (..., H, W, C) -> (..., H/f, W/f,
    f*f*C), channel (a*f + b)*C + c for pixel phase (a, b)."""
    *lead, h, w, c = x.shape
    x = x.reshape(*lead, h // f, f, w // f, f, c)
    x = np.moveaxis(x, -4, -3)  # (..., h/f, w/f, f, f, c)
    return np.ascontiguousarray(x.reshape(*lead, h // f, w // f, f * f * c))


def pack_s2d(x: torch.Tensor, f: int = PACK_FACTOR) -> torch.Tensor:
    """`pack_s2d_host` of an NHWC tensor, on its device."""
    *lead, h, w, c = x.shape
    x = x.reshape(*lead, h // f, f, w // f, f, c).movedim(-4, -3)
    return x.reshape(*lead, h // f, w // f, f * f * c)


def unpack_s2d(x: torch.Tensor, f: int = PACK_FACTOR) -> torch.Tensor:
    """Inverse of `pack_s2d`: (..., H/f, W/f, f*f*C) -> (..., H, W, C)."""
    *lead, hp, wp, cc = x.shape
    c = cc // (f * f)
    x = x.reshape(*lead, hp, wp, f, f, c).movedim(-3, -4)
    return x.reshape(*lead, hp * f, wp * f, c)


def unpack_nchw(x: torch.Tensor, f: int) -> torch.Tensor:
    """`unpack_s2d` of an NCHW map: (B, f*f*C, H, W) -> (B, C, f*H, f*W)."""
    b, cc, h, w = x.shape
    c = cc // (f * f)
    x = x.reshape(b, f, f, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c, h * f, w * f)


def pack_conv_kernel(w: np.ndarray, fi: int) -> np.ndarray:
    """A (3, 3, cin, cout) HWIO stride-2 SAME kernel as the equivalent
    (2, 2, fi*fi*cin, fo*fo*cout) stride-1 kernel (fo = fi // 2) on the
    fi-packed input with pad ((1, 0), (1, 0)), producing the fo-packed
    output: output row r = fo*i + p reads input rows 2r + di - 1 =
    fi*i + (2p + di - 1), and writing 2p + di - 1 = fi*(u - 1) + a maps
    each tap (p, di) to one packed tap (u, a), zero elsewhere."""
    w = np.asarray(w)
    k, _, cin, cout = w.shape
    assert k == 3, "the packed rewrite is derived for 3x3 stride-2 convs"
    fo = fi // 2
    pad = 2 * fi
    wp = np.pad(w, ((pad, pad), (pad, pad), (0, 0), (0, 0)))
    outs = []
    for p in range(fo):
        r0 = pad - fi + 1 - 2 * p  # di of packed tap t = 0 (t = fi*u + a)
        for q in range(fo):
            c0 = pad - fi + 1 - 2 * q
            blk = wp[r0:r0 + 2 * fi, c0:c0 + 2 * fi]  # (2fi, 2fi, cin, cout)
            blk = blk.reshape(2, fi, 2, fi, cin, cout)  # (u, a, v, b, ...)
            blk = blk.transpose(0, 2, 1, 3, 4, 5)       # (u, v, a, b, ...)
            outs.append(blk.reshape(2, 2, fi * fi * cin, cout))
    # output channel (p*fo + q)*cout + o: the fo-packing of the output
    return np.concatenate(outs, axis=-1)


def packed_taps(k: int, stride: int, fi: int, fo: int):
    """The tap map of `repack_conv_kernel`: ({(p, d): (u, a)}, the least
    u, the packed kernel's size kp, its stride s_packed, its padding (low,
    high))."""
    assert (stride * fo) % fi == 0, (stride, fi, fo)
    s_packed = stride * fo // fi
    taps = {}  # (p, d) -> (u, a)
    u_min = u_max = 0
    for p in range(fo):
        for d in range(k):
            c = stride * p + d - k // 2
            u, a = c // fi, c % fi
            taps[(p, d)] = (u, a)
            u_min, u_max = min(u_min, u), max(u_max, u)
    kp = u_max - u_min + 1
    pad = (-u_min, kp - 1 + u_min) if s_packed == 1 else (-u_min, u_max)
    return taps, u_min, kp, s_packed, pad


def repack_conv_kernel(w: np.ndarray, stride: int, fi: int, fo: int,
                       in_segments=None):
    """A (k, k, cin, cout) HWIO SAME conv (k in {1, 3}, `stride`) on the
    unpacked map rewritten for the fi-packed input: (w_packed, s_packed,
    pad) such that the conv of the fi-packed input with w_packed, stride
    s_packed and padding `pad` (low, high; rows and columns alike) is the
    fo-packed output.

    Output row R = fo*i + p reads input rows stride*R + d - k//2; with
    stride*fo == s_packed*fi that is packed row s_packed*i + u and phase
    a, where stride*p + d - k//2 = fi*u + a: each tap (p, d) maps to one
    packed tap (u, a), zero elsewhere.

    `in_segments`: the packed input's channel layout as [(f, channels)]
    segments in canonical channel order, e.g. [(2, 16), (2, 16)] for the
    concat of two 2-packed maps; default one segment [(fi, cin)]. The
    output is phase-major."""
    w = np.asarray(w)
    k, k2, cin, cout = w.shape
    assert k == k2 and k in (1, 3)
    taps, u_min, kp, s_packed, pad = packed_taps(k, stride, fi, fo)
    if in_segments is None:
        in_segments = [(fi, cin)]
    assert sum(c for _, c in in_segments) == cin
    assert all(f == fi for f, _ in in_segments), \
        "mixed input pack factors are not supported"
    offs = [0]
    for f, c in in_segments:
        offs.append(offs[-1] + f * f * c)

    wp = np.zeros((kp, kp, offs[-1], fo * fo * cout), w.dtype)
    for p in range(fo):
        for q in range(fo):
            for di in range(k):
                u, a = taps[(p, di)]
                for dj in range(k):
                    v, b = taps[(q, dj)]
                    col = (p * fo + q) * cout
                    can0 = 0
                    for si, (f, cs) in enumerate(in_segments):
                        row = offs[si] + (a * f + b) * cs
                        wp[u - u_min, v - u_min, row:row + cs,
                           col:col + cout] = w[di, dj, can0:can0 + cs, :]
                        can0 += cs
    return wp, s_packed, pad


def kernel_index(shape, rewrite) -> np.ndarray:
    """The gather map of a packed kernel: `rewrite` (an HWIO -> HWIO
    function above) run on an iota over the canonical OIHW kernel of
    `shape`. Returns an int64 OIHW array of indices into the canonical
    kernel's n flat elements followed by one zero slot for each zero tap:
    zero tap k reads slot n + k. Slots of their own keep the gather's
    backward (a sort by index, then a sum over each run of equal indices)
    free of one long run: most taps of a packed kernel are zero, and one
    shared slot made the backward of a packed p3 step take ~100 ms on
    the H100 (`PERF.md` §6)."""
    n = int(np.prod(shape))
    iota = np.arange(1, n + 1, dtype=np.int64).reshape(shape)
    packed = rewrite(iota.transpose(2, 3, 1, 0))  # OIHW -> HWIO
    idx = np.ascontiguousarray(packed.transpose(3, 2, 0, 1)) - 1  # OIHW
    zero = idx < 0
    idx[zero] = n + np.arange(int(zero.sum()))
    return idx


class _PackedConv(ConvBNSiLU):
    """A ConvBNSiLU whose conv runs in a packed domain: `self.conv` holds
    the canonical parameters (and `reset_parameters` draws them as
    `ConvBNSiLU` does), the forward gathers the packed kernel through
    `self._index` (`kernel_index`) and convolves the packed map with stride `s_packed` and
    padding `pad`. Subclasses set those three and `phases_out`."""

    def _setup(self, index, s_packed, pad, phases_out, device):
        self._index = index  # numpy; one device copy each, made at first use
        self._index_on = {}
        self._zero_taps = int((index >= self.conv.weight.numel()).sum())
        self.s_packed = s_packed
        self.pad = pad
        self.phases_out = phases_out
        self.bn = BNSiLU(self.conv.out_channels, phases=phases_out,
                         device=device)

    def packed_weight(self, dtype=None):
        """The packed OIHW kernel, gathered from the canonical weight, in
        `dtype` (default the compute dtype)."""
        w = self.conv.weight
        idx = self._index_on.get(w.device)
        if idx is None:
            idx = self._index_on[w.device] = torch.from_numpy(
                self._index).to(w.device)
        flat = torch.cat([w.reshape(-1), w.new_zeros(self._zero_taps)])
        return cast(flat[idx], dtype or self.dtype)

    def gate_shape(self, x):
        """K2's gate arguments for packed input x, as the JAX package's
        `GPackedConvBNSiLU` reads them: the packed kernel, and only a 3x3
        stride-1 conv padded (1, 1) qualifies."""
        cout, cin, kh, _ = self._index.shape
        if kh != 3 or self.s_packed != 1 or self.pad != (1, 1):
            return None
        return (3, 1, cin, cout, x.shape[2], x.shape[3], self.dtype)

    def forward(self, x, train: bool = False):
        w = self.packed_weight()
        bias = self.conv.bias
        if bias is not None:
            bias = cast(bias.repeat(self.phases_out), self.dtype)
        gate = self.gate_shape(x)
        if gate is not None and use_fused_bwd(*gate):
            # the packed C3a bottleneck 3x3s (64 channels @80x80 at 640):
            # the same forward, K2's backward; dW goes back through the
            # gather to the canonical kernel
            y = conv3x3_same(x, w)
            if bias is not None:
                y = y + bias.view(1, -1, 1, 1)
        else:
            lo, hi = self.pad
            if lo != hi:
                x = F.pad(x, (lo, hi, lo, hi))
                lo = 0
            y = F.conv2d(x, w, bias, self.s_packed, lo)
        return self.bn(y, train)


class GPackedConvBNSiLU(_PackedConv):
    """ConvBNSiLU (kernel 1 or 3, any stride) evaluated on an fi-packed
    input, emitting the fo-packed output (natural when fo == 1);
    `in_segments` is a concat layout of the input (`repack_conv_kernel`)."""

    def __init__(self, cin, features, kernel=3, stride=1, packed_in=2,
                 packed_out=2, use_bias=False, in_segments=None, dtype=None,
                 device=None):
        super().__init__(cin, features, kernel, stride, use_bias, dtype,
                         device)
        segs = list(in_segments) if in_segments is not None else None
        index = kernel_index(
            tuple(self.conv.weight.shape),
            lambda w: repack_conv_kernel(w, stride, packed_in, packed_out,
                                         in_segments=segs)[0])
        *_, s_packed, pad = packed_taps(kernel, stride, packed_in,
                                        packed_out)
        self._setup(index, s_packed, pad, packed_out * packed_out, device)


class PackedConvBNSiLU(_PackedConv):
    """A stride-2 3x3 ConvBNSiLU evaluated on an fi-packed input as a
    stride-1 2x2 conv padded ((1, 0), (1, 0)) (`pack_conv_kernel`),
    emitting the fi/2-packed output (natural when fi == 2)."""

    def __init__(self, cin, features, packed_in, use_bias=True, dtype=None,
                 device=None):
        super().__init__(cin, features, 3, 2, use_bias, dtype, device)
        fo = packed_in // 2
        index = kernel_index(tuple(self.conv.weight.shape),
                             lambda w: pack_conv_kernel(w, packed_in))
        self._setup(index, 1, (1, 0), fo * fo, device)


class PackedBottleneck(nn.Module):
    """`Bottleneck` on f-packed maps: the residual add is exact under the
    phase permutation."""

    def __init__(self, features, packed=2, dtype=None, device=None):
        super().__init__()
        kw = dict(packed_in=packed, packed_out=packed, dtype=dtype,
                  device=device)
        self.conv1 = GPackedConvBNSiLU(features, features, 3, 1, **kw)
        self.conv2 = GPackedConvBNSiLU(features, features, 3, 1, **kw)

    def forward(self, x, train: bool = False):
        return x + self.conv2(self.conv1(x, train), train)


class PackedC3(nn.Module):
    """`C3` on f-packed maps: conv1 and conv2 read the (possibly concat)
    packed input, their phase-major outputs are concatenated on channels,
    and conv3 reads that two-segment layout; nothing is unpacked. Modules
    are registered in `C3`'s order, so seeded resets draw alike."""

    def __init__(self, cin, features, n=1, packed=2, in_segments=None,
                 dtype=None, device=None):
        super().__init__()
        hidden = features // 2
        kw = dict(packed_in=packed, packed_out=packed, dtype=dtype,
                  device=device)
        self.conv1 = GPackedConvBNSiLU(cin, hidden, 1, 1,
                                       in_segments=in_segments, **kw)
        self.n = n
        for i in range(n):
            self.add_module(f"bottleneck{i}",
                            PackedBottleneck(hidden, packed, dtype, device))
        self.conv2 = GPackedConvBNSiLU(cin, hidden, 1, 1,
                                       in_segments=in_segments, **kw)
        self.conv3 = GPackedConvBNSiLU(
            2 * hidden, features, 1, 1,
            in_segments=((packed, hidden), (packed, hidden)), **kw)

    def forward(self, x, train: bool = False):
        x1 = self.conv1(x, train)
        for i in range(self.n):
            x1 = getattr(self, f"bottleneck{i}")(x1, train)
        x2 = self.conv2(x, train)
        return self.conv3(torch.cat([x1, x2], dim=1), train)
