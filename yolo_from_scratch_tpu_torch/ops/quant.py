"""The int8 conv body of the serving path: plain versions, the kernels'
wrappers and their registered ops (counterpart of `_quant_input`,
`_int8_conv` and `_dequant_silu` in `yolo_from_scratch_tpu/infer/
quantize.py`).

A quantized ConvBNSiLU runs

    Q1  xq = clip(round(x.to(dt) * inv), -127, 127) as int8, inv = (1 /
        a_scale) in float32 rounded to the compute dtype dt; a multiply by
        the reciprocal, never a divide; `torch.round` rounds half to even,
        as `jnp.round` does;
    Q2  acc = the int8 conv with an int32 accumulator, then
        silu(acc.to(dt) * scale + bias) in dt, scale = (a_scale * w_scale)
        in float32 rounded to dt, bias the folded bias rounded to dt.

Layouts: Q1 writes xq channels-last, (B, H, W, Cp) with Cp = C rounded up
to 16 and the extra channels zero; the packed weights are (N, Kp), row n
cout n's taps in (ky, kx, c < Cp) order, zero-padded to Kp, a multiple of
32 (`pack_weights`); Q2 writes (B, Ho, Wo, N), whose NCHW view is
channels-last. The kernels (`csrc/int8_conv.cu`) read and write exactly
these. Q2 takes k = 1, 2 or 3, padded k // 2 above and left and
k - 1 - k // 2 below and right: a SAME conv for k = 1 and 3, and for k = 2
the (1, 0) of the space-to-depth packed 2x2 convs (`models/packed.py`,
4 taps), so that Ho = (H - 1) // stride + 1 in every case.

The plain versions compute the accumulator in float64 on the integers
(an im2col product, exact: |acc| <= 127^2 * 9 * 512 < 2^53, where float32
would not be: the sums pass 2^24) and the epilogue with torch's own ops in
dt. The registered ops `yolo_torch::quant_input` and
`yolo_torch::int8_conv` dispatch by the tensors' device: CPU tensors take
the plain version, CUDA tensors launch the kernel or raise; there is no
fallback. The live path and a `torch.export` program (`infer/export.py`)
call the same ops, so a CUDA program launches the kernels and a CPU
program runs the plain versions. `quant_launches` and `conv_launches`
count the kernels' launches (a Python call each, as `ops/nms_cuda.py`
counts).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

quant_launches = 0
conv_launches = 0

_OUT_INT32, _OUT_FLOAT, _OUT_BF16 = 0, 1, 2


def padded_channels(c: int) -> int:
    """Cp: the channels of Q1's output, C rounded up to 16."""
    return -(-c // 16) * 16


def pack_weights(w_hwio) -> torch.Tensor:
    """int8 (k, k, Cin, N) weights (the JAX layout) -> (N, Kp) int8 as Q2
    reads them: the channels zero-padded to Cp, taps in (ky, kx, c) order,
    K zero-padded to a multiple of 32."""
    w = torch.as_tensor(np.asarray(w_hwio, np.int8))
    k, _, cin, n = w.shape
    cp = padded_channels(cin)
    w = F.pad(w.permute(3, 0, 1, 2), (0, cp - cin)).reshape(n, k * k * cp)
    return F.pad(w, (0, -(-w.shape[1] // 32) * 32 - w.shape[1])).contiguous()


def _unpack_weights(w, k, cp):
    """(N, Kp) packed weights -> (N, Cp, k, k), the OIHW the plain conv
    multiplies."""
    return w[:, :k * k * cp].reshape(-1, k, k, cp).permute(0, 3, 1, 2)


def input_inverse(a_scale, dtype) -> float:
    """inv = 1 / a_scale in float32, rounded to the compute dtype (as
    `_quant_input` does), as a Python float (exact: a bf16 or float32
    value)."""
    a = torch.tensor(a_scale, dtype=torch.float32)
    return float((1.0 / a).to(dtype))


def dequant_vectors(a_scale, w_scale, bias, dtype):
    """(scale, bias): a_scale * w_scale in float32 and the folded bias,
    each rounded to the compute dtype (as `_dequant_silu` does), held in
    float32 as Q2's epilogue reads them."""
    a = torch.tensor(a_scale, dtype=torch.float32)
    w = torch.as_tensor(np.asarray(w_scale, np.float32))
    b = torch.as_tensor(np.asarray(bias, np.float32))
    return (a * w).to(dtype).float(), b.to(dtype).float()


def _out_size(size, stride):
    return (size - 1) // stride + 1


# ----------------------------------------------------------------- plain


def quant_input_plain(x, inv):
    """Q1's plain version: NCHW x in the compute dtype -> (B, H, W, Cp)
    int8."""
    dt = x.dtype
    q = torch.clamp(torch.round(x * torch.tensor(inv, dtype=dt,
                                                 device=x.device)),
                    -127, 127).to(torch.int8)
    c = x.shape[1]
    return F.pad(q.permute(0, 2, 3, 1),
                 (0, padded_channels(c) - c)).contiguous()


def int8_conv_acc_plain(xq, w, k, stride):
    """Q2's accumulator, plain: (B, H, W, Cp) int8 and (N, Kp) packed
    weights -> (B, Ho, Wo, N) int32, through an exact float64 product."""
    b, h, wd, cp = xq.shape
    lo, hi = k // 2, k - 1 - k // 2
    xd = F.pad(xq.permute(0, 3, 1, 2).double(), (lo, hi, lo, hi))
    cols = F.unfold(xd, k, stride=stride)  # (B, Cp*k*k, L), channel-major
    wm = _unpack_weights(w, k, cp).reshape(w.shape[0], -1).double()
    acc = torch.matmul(wm, cols)  # (B, N, L)
    ho, wo = _out_size(h, stride), _out_size(wd, stride)
    return acc.reshape(b, -1, ho, wo).permute(0, 2, 3, 1).to(
        torch.int32).contiguous()


def dequant_silu_plain(acc, scale, bias, dtype):
    """Q2's epilogue, plain: silu(acc.to(dt) * scale + bias) in dt, the
    int32 cast to dt first (so a large sum rounds in bf16, as XLA's
    `y.astype(dt)` does)."""
    return F.silu(acc.to(dtype) * scale.to(dtype) + bias.to(dtype))


def int8_conv_plain(xq, w, scale, bias, k, stride, bf16):
    """Q2's plain version: (B, Ho, Wo, N) in the compute dtype."""
    dt = torch.bfloat16 if bf16 else torch.float32
    return dequant_silu_plain(int8_conv_acc_plain(xq, w, k, stride), scale,
                              bias, dt)


# --------------------------------------------------------------- kernels


def _lib():
    from yolo_from_scratch_tpu_torch.kernels.build import load_library

    return load_library()


def _check(rc, lib, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.int8_conv_error_string(rc).decode()} "
                           f"({rc})")


def _launch_quant_input(x, inv):
    global quant_launches
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"Q1 takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"Q1 takes NCHW, got shape {tuple(x.shape)}")
    lib = _lib()
    b, c, h, w = x.shape
    out = torch.empty((b, h, w, padded_channels(c)), dtype=torch.int8,
                      device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.quant_input(
            x.data_ptr(), int(x.dtype == torch.bfloat16), *x.stride(), b, c,
            h, w, out.shape[3], float(inv), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check(rc, lib, "Q1 (quant_input)")
    quant_launches += 1
    return out


def _launch_int8_conv(xq, w, scale, bias, k, stride, mode):
    global conv_launches
    if xq.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"Q2 takes int8 xq and w, got {xq.dtype}, {w.dtype}")
    if not (xq.is_contiguous() and w.is_contiguous()):
        raise ValueError("Q2 reads contiguous xq (B, H, W, Cp) and w (N, Kp)")
    b, h, wd, cp = xq.shape
    n = w.shape[0]
    if k not in (1, 2, 3) or stride < 1:
        raise ValueError(f"Q2 takes k 1, 2 or 3 and a stride of at least 1, "
                         f"got k {k}, stride {stride}")
    if cp % 16 or w.dim() != 2 or w.shape[1] != -(-k * k * cp // 32) * 32:
        raise ValueError(f"Q2 reads xq with Cp a multiple of 16 and w (N, Kp) "
                         f"with Kp = k*k*Cp rounded up to 32, got Cp {cp}, w "
                         f"{tuple(w.shape)}")
    if xq.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("Q2's TMA tensor maps need xq and w on 16-byte "
                         f"boundaries, got {xq.data_ptr():#x}, "
                         f"{w.data_ptr():#x}")
    if mode != _OUT_INT32 and (
            scale.dtype != torch.float32 or bias.dtype != torch.float32
            or scale.shape != (n,) or bias.shape != (n,)
            or not (scale.is_contiguous() and bias.is_contiguous())):
        raise ValueError("Q2's epilogue reads float32 scale and bias of "
                         f"shape ({n},)")
    lib = _lib()
    ho, wo = _out_size(h, stride), _out_size(wd, stride)
    dtype = {_OUT_INT32: torch.int32, _OUT_FLOAT: torch.float32,
             _OUT_BF16: torch.bfloat16}[mode]
    out = torch.empty((b, ho, wo, n), dtype=dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        rc = lib.int8_conv(
            xq.data_ptr(), w.data_ptr(),
            scale.data_ptr() if mode else None,
            bias.data_ptr() if mode else None, out.data_ptr(), mode, b, h,
            wd, cp, n, k, stride, k // 2, ho, wo, w.shape[1],
            torch.cuda.current_stream().cuda_stream)
    _check(rc, lib, "Q2 (int8_conv)")
    conv_launches += 1
    return out


class Q2Geometry(NamedTuple):
    """Q2's launch geometry at one shape, as `int8_conv_geometry` in
    `csrc/int8_conv.cu` (the one source of it) gives it."""
    nt: int           # output channels a tile (NW, a warpgroup's, is N or N / 2)
    split: int        # 1: the warpgroups share 64 pixels, N / 2 columns each
    tile_h: int       # output pixels a tile: rows
    tile_w: int       # and columns
    chunk: int        # channel bytes a ring stage
    stages: int
    smem: int         # dynamic shared memory bytes
    grid: int         # persistent blocks
    work: int         # work items: pixel tiles x N tiles
    halo_h: int
    halo_w: int
    n_tiles: int      # N tiles
    tiles_y: int      # pixel tiles an image, down
    tiles_x: int      # and across
    stage_bytes: int
    halo_bytes: int
    resident: int     # weight bytes kept for a block's life (0: a stage each)
    chunk_wbytes: int  # one channel chunk's weight boxes, bytes
    vec_bytes: int    # the epilogue's scale and bias, every column, bytes


def conv_geometry(lib, b, h, w, cp, n, k, stride, sms):
    """Q2's geometry for xq (B, H, W, Cp), `n` output channels, a k x k
    kernel at `stride` on a card of `sms` SMs, read from the library."""
    out = (ctypes.c_int * len(Q2Geometry._fields))()
    rc = lib.int8_conv_geometry(b, h, w, cp, n, k, stride, sms, out)
    _check(rc, lib, "Q2 geometry")
    return Q2Geometry(*out)


def _device_of(*tensors):
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda") or any(t.device != dev
                                              for t in tensors):
        raise ValueError(f"the int8 ops take CPU or CUDA tensors on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    return dev.type


def int8_conv_acc(xq, w, k, stride):
    """Q2's raw int32 accumulator (B, Ho, Wo, N): the kernel on CUDA
    tensors, the plain version on CPU tensors. The tests and the smoke
    script hold the two bit for bit; no serving path calls it."""
    if _device_of(xq, w) == "cpu":
        return int8_conv_acc_plain(xq, w, k, stride)
    return _launch_int8_conv(xq, w, None, None, k, stride, _OUT_INT32)


# ------------------------------------------------------------ registered


@torch.library.custom_op("yolo_torch::quant_input", mutates_args=())
def quant_input(x: torch.Tensor, inv: float) -> torch.Tensor:
    """Q1: NCHW x in the compute dtype -> (B, H, W, Cp) int8."""
    if _device_of(x) == "cpu":
        return quant_input_plain(x, inv)
    return _launch_quant_input(x, inv)


@quant_input.register_fake
def _(x, inv):
    b, c, h, w = x.shape
    return x.new_empty((b, h, w, padded_channels(c)), dtype=torch.int8)


@torch.library.custom_op("yolo_torch::int8_conv", mutates_args=())
def int8_conv(xq: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, k: int, stride: int,
              bf16: bool) -> torch.Tensor:
    """Q2: int8 conv, dequant, bias and SiLU -> (B, Ho, Wo, N) in bf16 or
    float32."""
    if _device_of(xq, w, scale, bias) == "cpu":
        return int8_conv_plain(xq, w, scale, bias, k, stride, bf16)
    return _launch_int8_conv(xq, w, scale, bias, k, stride,
                             _OUT_BF16 if bf16 else _OUT_FLOAT)


@int8_conv.register_fake
def _(xq, w, scale, bias, k, stride, bf16):
    b, h, wd, _ = xq.shape
    return xq.new_empty(
        (b, _out_size(h, stride), _out_size(wd, stride), w.shape[0]),
        dtype=torch.bfloat16 if bf16 else torch.float32)


def quant_conv_silu(x, inv, w, scale, bias, k, stride, plain=False):
    """The int8 ConvBNSiLU body: NCHW x in the compute dtype -> NCHW out
    (channels-last in memory) in the same dtype. `plain=True` runs the
    plain versions on any device (what the kernels are held against);
    otherwise the registered ops."""
    bf16 = x.dtype == torch.bfloat16
    if plain:
        y = int8_conv_plain(quant_input_plain(x, inv), w, scale, bias, k,
                            stride, bf16)
    else:
        y = torch.ops.yolo_torch.int8_conv(
            torch.ops.yolo_torch.quant_input(x, inv), w, scale, bias, k,
            stride, bf16)
    return y.permute(0, 3, 1, 2)
