"""Letterbox on the card (L1): the batch's raw HWC uint8 frames, staged
back to back in one buffer behind a small table, become the model's
letterboxed uint8 input in one launch of `csrc/letterbox.cu`.

The bytes are PIL's (`data/letterbox.py::letterbox_image`), bit for bit.
The geometry is `letterbox_params`'; a frame whose letterboxed size is its
own is copied (PIL's same-size resize is a copy), any other goes through
Pillow's 8-bit bilinear resample, written out in integers: the triangle
filter's coefficients of Pillow's `precompute_coeffs` (support scaled by
max(in / out, 1), normalised in float64; computed here on the host and
cached per (in, out) size), rounded to 22 fractional bits half away from
zero (`normalize_coeffs_8bpc`), the horizontal pass into a uint8
intermediate (accumulator from 1 << 21, then >> 22, clipped to 0..255),
then the vertical pass over the intermediate rows. Pillow skips the pass
of an axis whose size does not change, and so does L1.

The staging buffer (`Staging`, one a predictor, reused across calls and
grown only when a batch needs more; pinned host memory for a CUDA device):

    [table: B rows of TABLE_ROW_BYTES] [coefficients] [frames]

each part and each frame starting on a 16-byte boundary. A row holds
int32 fields (`FIELDS`; offsets count 16-byte units from the buffer's
start) and, at `FLOAT_FIELDS`, the float32 (scale, pad_top, pad_left)
that the postprocess takes. A coefficient block is Pillow's bounds (out,
2) int32, (first tap, taps), then its (out, taps) int32 coefficients.

`Staging.letterbox` packs, uploads and letterboxes a batch, inside the
serving spans `serve.letterbox` (the host's staging), `serve.upload` (the
copy) and `serve.l1` (L1's launch, or the plain version on the CPU). It
dispatches by the staging's device: the CPU runs the plain version
(`letterbox_plain`, which reads the same buffer and table in plain
torch), a CUDA device launches the kernel or raises. There is no
fallback. `launches` counts the kernel's launches, `resampled` the images
those launches took through the resample branch; both count Python calls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from yolo_from_scratch_tpu_torch.data.letterbox import (
    PACK_FACTOR,
    PAD_COLOR,
    letterbox_params,
)
from yolo_from_scratch_tpu_torch.utils.metrics_log import span

launches = 0
resampled = 0

ALIGN = 16
TABLE_ROW_BYTES = 128
FIELDS = ("src", "h", "w", "new_h", "new_w", "pad_top", "pad_left",
          "x_coef", "x_taps", "y_coef", "y_taps")
FLOAT_FIELDS = 16  # (scale, pad_top, pad_left) as float32 at 16, 17, 18
PRECISION_BITS = 22  # Pillow's PRECISION_BITS for 8-bit images


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


@functools.lru_cache(maxsize=1024)
def coefficients(in_size: int, out_size: int):
    """Pillow's bilinear coefficients for one axis, in -> out:
    (bounds (out, 2) int32 [first tap, taps], (out, taps_max) int32
    coefficients at 22 fractional bits, zero past each row's taps), both
    read-only (the cache hands them to every caller)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the triangle's support, 1, times the scale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(
        np.int64) - xmin
    taps = np.arange(ksize)
    arg = np.abs(((taps[None] + xmin[:, None]) - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where((arg < 1.0) & (taps[None] < xmax[:, None]), 1.0 - arg, 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):  # in Pillow's order: a float64 sum is not exact
        ww = ww + w[:, x]
    k = w / np.where(ww == 0.0, 1.0, ww)[:, None]  # Pillow skips ww == 0
    kk = np.trunc(np.where(k < 0, -0.5, 0.5) + k * (1 << PRECISION_BITS))
    out = np.stack([xmin, xmax], axis=1).astype(np.int32), kk.astype(np.int32)
    for a in out:
        a.flags.writeable = False
    return out


class Staging:
    """A predictor's staging of raw frames for L1: a host buffer (pinned
    for a CUDA device) and, for a CUDA device, the device buffer the used
    prefix is copied into; both reused across calls, grown only when a
    batch needs more. On the CPU the host buffer is the device's."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"L1 takes a CPU or CUDA device, got "
                             f"{self.device}")
        self._pinned = self.device.type == "cuda"
        self._host = torch.empty(0, dtype=torch.uint8)
        self.buffer = self._host  # on the device; see `letterbox`
        self.table = np.zeros((0, TABLE_ROW_BYTES // 4), np.int32)

    # normal tensors even when the first call comes under inference mode,
    # so that calls outside it may write them
    @torch.inference_mode(False)
    def _reserve(self, n: int):
        if n > self._host.numel():
            self._host = torch.empty(n, dtype=torch.uint8,
                                     pin_memory=self._pinned)
            if not self._pinned:
                self.buffer = self._host
        if self._pinned and n + ALIGN > self.buffer.numel():
            # 16 bytes of slack: L1's aligned word loads read up to 15
            # bytes past a frame's end
            self.buffer = torch.empty(n + ALIGN, dtype=torch.uint8,
                                      device=self.device)

    def _pack(self, arrays, size: int) -> int:
        """Write the table, the coefficients and the frames of `arrays`
        (HWC uint8, 3 channels) into the host buffer, letterboxed to
        `size`. Returns the bytes used; `self.table` is the table as
        written ((B, 32) int32, a copy)."""
        b = len(arrays)
        table = np.zeros((b, TABLE_ROW_BYTES // 4), np.int32)
        params = table.view(np.float32)
        rows, coefs = [], {}
        used = b * TABLE_ROW_BYTES
        for a in arrays:
            h, w = a.shape[:2]
            scale, pad_top, pad_left, new_w, new_h = letterbox_params(
                w, h, size)
            row = dict(h=h, w=w, new_h=new_h, new_w=new_w, pad_top=pad_top,
                       pad_left=pad_left)
            for axis, n, m in (("x", w, new_w), ("y", h, new_h)):
                if n == m:
                    continue  # Pillow skips the pass of an axis that stays
                bounds, kk = coefficients(n, m)
                if (n, m) not in coefs:
                    coefs[n, m] = used
                    used += _aligned(bounds.nbytes + kk.nbytes)
                row[f"{axis}_coef"] = coefs[n, m] // ALIGN
                row[f"{axis}_taps"] = kk.shape[1]
            rows.append(row)
            params[len(rows) - 1, FLOAT_FIELDS:FLOAT_FIELDS + 3] = (
                scale, pad_top, pad_left)
        for i, (row, a) in enumerate(zip(rows, arrays)):
            row["src"] = used // ALIGN
            used += _aligned(a.nbytes)
            table[i, :len(FIELDS)] = [row.get(f, 0) for f in FIELDS]
        self._reserve(used)
        host = self._host.numpy()
        host[:table.nbytes] = table.view(np.uint8).reshape(-1)
        for (n, m), off in coefs.items():
            for part in coefficients(n, m):
                host[off:off + part.nbytes] = part.view(np.uint8).reshape(-1)
                off += part.nbytes
        for row, a in zip(rows, arrays):
            off = row["src"] * ALIGN
            if a.flags.c_contiguous and a.flags.writeable:
                # torch's copy runs on its intra-op threads: ~3x numpy's
                self._host[off:off + a.nbytes].copy_(
                    torch.from_numpy(a).view(-1))
            else:
                np.copyto(host[off:off + a.nbytes].reshape(a.shape), a)
        self.table = table
        return used

    def letterbox(self, arrays, size: int, packed=False):
        """The letterboxed batch of `arrays` (an iterable of HWC uint8
        3-channel frames, taken inside `serve.letterbox`, so a generator's
        decoding counts there): (imgs (B, S, S, 3) uint8, or packed (B,
        S/4, S/4, 48), scales (B,), pad_tops (B,), pad_lefts (B,)
        float32) on the device. Stages the frames behind their table
        (`serve.letterbox`, the frames' bytes), copies the used bytes to
        `self.buffer` in one copy synchronous for the host (`serve.upload`,
        those bytes), then L1 or its plain version (`serve.l1`)."""
        _check_size(size)
        with span("serve.letterbox") as lb:
            arrays = list(arrays)
            used = self._pack(arrays, size)
            lb.nbytes = sum(a.nbytes for a in arrays)
        with span("serve.upload", nbytes=used):
            if self._pinned:
                self.buffer[:used].copy_(self._host[:used])
        with span("serve.l1"):
            if self._pinned:
                return _launch(self.buffer, size, packed, self.table)
            return letterbox_plain(self.buffer, len(arrays), size, packed)


def _params(buf, b):
    """(scales, pad_tops, pad_lefts) (B,) float32 of the table, a copy."""
    rows = buf[:b * TABLE_ROW_BYTES].view(torch.float32).view(b, -1)
    return rows[:, FLOAT_FIELDS:FLOAT_FIELDS + 3].clone().unbind(1)


def _check_size(size):
    if size % ALIGN or not 0 < size <= 16384:
        raise ValueError(f"L1 takes a size in 16..16384 that divides by "
                         f"{ALIGN}, got {size}")


def _check(buf, b, size):
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise TypeError(f"L1 reads a flat uint8 buffer, got {buf.dtype} of "
                        f"shape {tuple(buf.shape)}")
    _check_size(size)
    if not 0 < b <= 65535 or buf.numel() < b * TABLE_ROW_BYTES:
        raise ValueError(f"L1 takes 1..65535 images whose table the buffer "
                         f"holds, got B={b} in {buf.numel()} bytes")


def _resample(x, bounds, kk, dim):
    """One of Pillow's 8-bit passes along `dim` of an (H, W, 3) uint8
    tensor: bounds (out, 2), kk (out, taps) int32."""
    taps = kk.shape[1]
    idx = (bounds[:, :1] + torch.arange(taps, device=x.device)).clamp(
        max=x.shape[dim] - 1)
    xs = x.index_select(dim, idx.reshape(-1)).to(torch.int32)
    shape = list(x.shape)
    shape[dim:dim + 1] = [kk.shape[0], taps]
    k = kk.reshape([1] * dim + list(kk.shape) + [1] * (2 - dim))
    acc = (xs.reshape(shape) * k).sum(dim + 1) + (1 << (PRECISION_BITS - 1))
    return (acc >> PRECISION_BITS).clamp(0, 255).to(torch.uint8)


def _coef(buf, unit, out_size, taps):
    off = unit * ALIGN
    words = buf[off:off + 4 * out_size * (2 + taps)].view(torch.int32)
    return (words[:2 * out_size].view(out_size, 2).long(),
            words[2 * out_size:].view(out_size, taps))


def letterbox_plain(buf, b, size, packed=False):
    """L1's plain version: the same buffer and table -> (B, S, S, 3)
    uint8, or for `packed` the (B, S/4, S/4, 48) layout of
    `pack_s2d_host`. Plain torch on the buffer's device."""
    _check(buf, b, size)
    table = buf[:b * TABLE_ROW_BYTES].view(torch.int32).view(b, -1)
    rows = table[:, :len(FIELDS)].tolist()
    out = torch.empty((b, size, size, 3), dtype=torch.uint8,
                      device=buf.device)
    out[:] = torch.tensor(PAD_COLOR, dtype=torch.uint8)
    for i, row in enumerate(rows):
        f = dict(zip(FIELDS, row))
        h, w, new_h, new_w = f["h"], f["w"], f["new_h"], f["new_w"]
        off = f["src"] * ALIGN
        x = buf[off:off + h * w * 3].view(h, w, 3)
        if f["x_taps"]:
            x = _resample(x, *_coef(buf, f["x_coef"], new_w, f["x_taps"]), 1)
        if f["y_taps"]:
            x = _resample(x, *_coef(buf, f["y_coef"], new_h, f["y_taps"]), 0)
        top, left = f["pad_top"], f["pad_left"]
        out[i, top:top + new_h, left:left + new_w] = x
    if packed:
        f = PACK_FACTOR
        out = out.view(b, size // f, f, size // f, f, 3).permute(
            0, 1, 3, 2, 4, 5).reshape(b, size // f, size // f, f * f * 3)
    return out, *_params(buf, b)


def _launch(buf, size, packed, table):
    global launches, resampled
    from yolo_from_scratch_tpu_torch.kernels.build import load_library

    b = len(table)
    _check(buf, b, size)
    if not buf.is_contiguous() or buf.data_ptr() % ALIGN:
        raise ValueError(f"L1 reads a contiguous buffer from a {ALIGN}-byte "
                         f"boundary, got address {buf.data_ptr():#x}")
    lib = load_library()
    shape = ((b, size // PACK_FACTOR, size // PACK_FACTOR,
              3 * PACK_FACTOR * PACK_FACTOR) if packed
             else (b, size, size, 3))
    out = torch.empty(shape, dtype=torch.uint8, device=buf.device)
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.letterbox_u8(buf.data_ptr(), b, size, int(bool(packed)),
                              out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"L1 launch failed: "
                           f"{lib.letterbox_error_string(rc).decode()} "
                           f"({rc})")
    launches += 1
    x_taps, y_taps = FIELDS.index("x_taps"), FIELDS.index("y_taps")
    resampled += int(np.count_nonzero(table[:, x_taps] | table[:, y_taps]))
    return out, *_params(buf, b)
