"""Fused backward of the stride-1 SAME 3x3 convs with 64 channels in and
out (counterpart of `yolo_from_scratch_tpu/ops/conv_bwd.py`).

`conv3x3_same` is a `torch.autograd.Function`: its forward is exactly
`F.conv2d(x, w, padding=1)`, so inference, checkpoints and forward
numerics are the stock convolution's; its backward computes both
gradients in one pass,

    dW = sum_b X9_b^T @ dy_b     X9  = (H*W, 9C) shifted-patch matrix of x
    dx = DY9 @ W9flip            DY9 = the same of dy,
                                 W9flip[t*C + co, ci] = w[co, ci, 2-i, 2-j]

with dW summed over the batch in float32 and dx in x's dtype. For a CUDA
tensor the backward launches the hand-written kernel `csrc/conv_bwd.cu`
(two launches: tiles, then the fixed-order sum of their dW partials); for a
CPU tensor it runs `fused_bwd_plain`, the patch math in torch, which is also
what the kernel is checked against. There is no fallback from the kernel to
the plain version. `launches` counts kernel launches and nothing else.
It counts Python calls: inside a CUDA graph (the scanned trainers of
`train/steps.py`) a launch is counted once, at capture, and never at a
replay; the kernel launches on the current stream, the capture stream
there, with its workspace from `torch.empty`, the graph's memory pool.

The bf16 kernels of this module and of `benchmarks/bwdproto.py` (K3, K4)
and `benchmarks/blockbwd.py` (K5) load their tiles by TMA and run in
clusters of blocks that sum their dW partials on chip. Each conv-backward
kernel (K2-K5) owns its launch geometry and exports it
(`<kernel>_geometry`); `geometry` reads it and `launch_plan` turns it into
the grid and the dW workspace, the arithmetic every wrapper uses.
`check_tma_operand` refuses what TMA cannot read.

`YOLO_FUSED_CONV_BWD` (default "0") is read at every call of
`use_fused_bwd`; any other value turns the gate on. Unlike the JAX
package, which reads it when a program is traced, the port can switch it
between steps.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

launches = 0
LAUNCHES_PER_CALL = 2  # the tile kernel and the dW sum

_FUSED_C = 64
_MAX_HW = 80 * 80  # the JAX gate's bound: bf16 6400, float32 3200
_TAPS = [(i, j) for i in range(3) for j in range(3)]


def use_fused_bwd(kernel: int, stride: int, cin: int, cout: int, h: int,
                  w: int, dtype=torch.bfloat16) -> bool:
    """Should this conv take its backward from `fused_bwd`? The switch,
    then `fused_bwd_fits`."""
    if os.environ.get("YOLO_FUSED_CONV_BWD", "0") == "0":
        return False
    return fused_bwd_fits(kernel, stride, cin, cout, h, w, dtype)


def fused_bwd_fits(kernel: int, stride: int, cin: int, cout: int, h: int,
                   w: int, dtype=torch.bfloat16) -> bool:
    """The JAX gate's shape rule and H*W bounds, so both packages select
    the same convs once the switch is on."""
    if not (kernel == 3 and stride == 1 and cin == cout == _FUSED_C):
        return False
    limit = _MAX_HW if dtype.itemsize <= 2 else _MAX_HW // 2
    return h * w <= limit


def _patches(t):
    """(B, C, H, W) -> (B, H*W, 9C): the 9 zero-padded shifted NHWC views
    of t, tap-major, channel-concatenated."""
    b, c, h, w = t.shape
    tp = F.pad(t.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))
    return torch.cat([tp[:, i:i + h, j:j + w, :] for i, j in _TAPS],
                     dim=-1).reshape(b, h * w, 9 * c)


def fused_bwd_plain(x, dy, w):
    """(dx, dW) of y = conv2d(x, w, padding=1) by the patch math, in plain
    torch. x, dy (B, C, H, W) in one dtype, w (C, C, 3, 3) OIHW. Products
    are taken in float32 (exact for bf16 inputs), dW summed over the batch in
    float32; returns dx in x's dtype (NCHW, channels-last in memory) and dW
    float32 OIHW."""
    b, c, h, wd = x.shape
    dw9 = torch.matmul(_patches(x).float().transpose(1, 2),
                       dy.permute(0, 2, 3, 1).reshape(b, h * wd, c).float())
    dw9 = dw9.sum(0)  # (9C, C): row t*C + ci, column co
    w9 = w.flip(2, 3).permute(2, 3, 0, 1).reshape(9 * c, c).float()
    dx = torch.matmul(_patches(dy).float(), w9).to(x.dtype)
    dx = dx.reshape(b, h, wd, c).permute(0, 3, 1, 2)
    return dx, dw9.reshape(3, 3, c, c).permute(3, 2, 0, 1)


class Geometry(NamedTuple):
    """A conv-backward tile kernel's launch geometry, as the kernel's
    `<kernel>_geometry` export gives it."""
    tile: tuple          # output tile (rows, columns)
    cluster: int         # blocks of a cluster; 1: no clusters
    partial_floats: int  # floats of one dW partial
    max_clusters: int    # clusters the card holds at once; 0 unclustered


def geometry(lib, kernel, bf16):
    """Geometry of `kernel` (conv3x3_bwd, conv_bwd_patch, conv_bwd_tap or
    chain_bwd) for bf16 or float32, read from the kernel library."""
    out = (ctypes.c_int * 5)()
    rc = getattr(lib, f"{kernel}_geometry")(int(bf16), out)
    if rc != 0:
        raise RuntimeError(f"{kernel}: the card cannot run a cluster of the "
                           f"kernel ({lib.conv3x3_bwd_error_string(rc).decode()})")
    return Geometry((out[0], out[1]), out[2], out[3], out[4])


def tile_count(b, h, w, tile):
    """Output tiles of (rows, columns) `tile` over a (B, H, W) batch."""
    return b * -(-h // tile[0]) * -(-w // tile[1])


def launch_grid(n_tiles, sms, geom):
    """Blocks a kernel runs with. Clustered: the cluster size x the smaller
    of the clusters the card holds at once and the tiles / cluster rounded
    up, so no cluster waits for another to finish. Otherwise one block per
    SM, at most one a tile."""
    if geom.cluster == 1:
        return min(n_tiles, sms)
    if geom.max_clusters < 1:
        raise RuntimeError("the card cannot run a cluster of the kernel")
    return geom.cluster * min(geom.max_clusters, -(-n_tiles // geom.cluster))


def workspace_floats(grid, geom):
    """Floats of the dW workspace: a partial a cluster, else one a block."""
    return grid // geom.cluster * geom.partial_floats


def launch_plan(lib, kernel, b, h, w, bf16, sms):
    """(grid, workspace floats) of one launch of `kernel` over a (B, H, W)
    batch on a card with `sms` SMs."""
    geom = geometry(lib, kernel, bf16)
    grid = launch_grid(tile_count(b, h, w, geom.tile), sms, geom)
    return grid, workspace_floats(grid, geom)


def check_tma_operand(t, name, channels_last):
    """Raise ValueError unless t is what the kernels' TMA tensor maps read:
    dense with its channels innermost (an NCHW tensor in channels-last
    memory if `channels_last`, else a contiguous NHWC tensor), a base
    address and strides that are multiples of 16 bytes. No copy is made."""
    dense = (t.is_contiguous(memory_format=torch.channels_last)
             if channels_last else t.is_contiguous())
    if not dense:
        layout = "channels-last NCHW" if channels_last else "contiguous NHWC"
        raise ValueError(f"{name}: the kernel reads a dense {layout} tensor, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")
    bad = [st for st, n in zip(t.stride(), t.shape)
           if n > 1 and st != 1 and st * t.element_size() % 16]
    if t.data_ptr() % 16 or bad:
        raise ValueError(f"{name}: TMA needs a 16-byte aligned base and "
                         f"strides that are multiples of 16 bytes, got "
                         f"address {t.data_ptr():#x}, strides {t.stride()}")


def _launch(x, dy, w):
    global launches
    from yolo_from_scratch_tpu_torch.kernels.build import load_library

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv backward kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if dy.dtype != x.dtype or w.dtype != x.dtype:
        raise TypeError(f"x, dy and w must share a dtype, got {x.dtype}, "
                        f"{dy.dtype}, {w.dtype}")
    b, c, h, wd = x.shape
    if (c != _FUSED_C or tuple(dy.shape) != tuple(x.shape)
            or tuple(w.shape) != (c, c, 3, 3)):
        raise ValueError(f"expected x, dy (B, 64, H, W) and w (64, 64, 3, 3), "
                         f"got {tuple(x.shape)}, {tuple(dy.shape)}, "
                         f"{tuple(w.shape)}")
    if not (x.device == dy.device == w.device):
        raise ValueError(f"x, dy and w on different devices: {x.device}, "
                         f"{dy.device}, {w.device}")
    # the kernel reads channels-last x and dy (by TMA in bf16) and
    # contiguous w; nothing is copied here
    cl = torch.channels_last
    bf16 = x.dtype == torch.bfloat16
    for t, name in ((x, "x"), (dy, "dy")):
        if bf16:
            check_tma_operand(t, name, channels_last=True)
        elif not t.is_contiguous(memory_format=cl):
            raise ValueError(f"{name}: the kernel reads a dense channels-last "
                             f"NCHW tensor, got strides {t.stride()}")
    if not w.is_contiguous():
        raise ValueError(f"w: the kernel reads a contiguous OIHW tensor, got "
                         f"strides {w.stride()}")
    lib = load_library()
    dx = torch.empty_like(x, memory_format=cl)
    dw = torch.empty((c, c, 3, 3), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        grid, ws_floats = launch_plan(lib, "conv3x3_bwd", b, h, wd, bf16, sms)
        workspace = torch.empty(ws_floats, dtype=torch.float32,
                                device=x.device)
        rc = lib.conv3x3_bwd(
            x.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), workspace.data_ptr(), b, h, wd, grid, int(bf16),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv backward kernel launch failed: "
                           f"{lib.conv3x3_bwd_error_string(rc).decode()} "
                           f"({rc})")
    launches += LAUNCHES_PER_CALL
    return dx, dw


def fused_bwd(x, dy, w):
    """(dx in x's dtype, dW float32 OIHW) for y = conv2d(x, w, padding=1).
    CPU tensors run the plain version, CUDA tensors the kernel, which takes
    channels-last x and dy and a contiguous w and raises on anything
    else."""
    if x.device.type == "cpu":
        return fused_bwd_plain(x, dy, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv backward takes CPU or CUDA tensors, got "
                         f"{x.device}")
    return _launch(x, dy, w)


class _Conv3x3Same(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w, padding=1)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        if x.device.type == "cuda":
            # the kernel reads channels-last x and dy and refuses anything
            # else; autograd may hand dy (and the caller x) in another format
            cl = torch.channels_last
            x, dy = (t.contiguous(memory_format=cl) for t in (x, dy))
            w = w.contiguous()
        dx, dw = fused_bwd(x, dy, w)
        return dx.to(x.dtype), dw.to(w.dtype)


def conv3x3_same(x, w):
    """Stride-1 SAME 3x3 conv of NCHW x with OIHW w; forward ==
    `F.conv2d`, backward == `fused_bwd`."""
    return _Conv3x3Same.apply(x, w)
