"""L1, the letterbox on the card (`ops/letterbox_cuda.py`,
`csrc/letterbox.cu`), and `BatchPredictor`'s staging around it.

- The plain version's bytes equal PIL's letterbox (`letterbox_image`) at
  scale 1, shrinking, enlarging, odd sizes and the 1-px clamp, in the
  pixel and the packed layout; alone and in batches that mix the copy and
  the resample branches; its float32 params equal `letterbox_input`'s.
- A staging buffer reused across calls that grow and then shrink leaves
  no stale byte in the output.
- The kernel's chunk walk (pad chunks, the aligned-word copy, the byte at
  a time build of the others, in both layouts), modelled in Python,
  equals the plain version.
- `BatchPredictor`'s lists equal those of the host path it replaced
  (`letterbox_input`, `np.stack`, the params tensor) exactly, float, int8
  and packed.
- On a card (skipped without one): L1's bytes equal PIL's on the same
  grid, one launch a `BatchPredictor` call, `resampled` counting only
  the resized images. On the card: `python -m pytest --noconftest
  -p no:cacheprovider tests/test_torch_letterbox_kernel.py` (this file
  imports no JAX).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from yolo_from_scratch_tpu_torch import YoloConfig
from yolo_from_scratch_tpu_torch.data.letterbox import (
    letterbox_image,
    pack_s2d_host,
)
from yolo_from_scratch_tpu_torch.infer.detections import detections_per_image
from yolo_from_scratch_tpu_torch.infer.predict import (
    BatchPredictor,
    letterbox_input,
)
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import letterbox_cuda

S = 640
# (w, h): scale 1, square, shrink, enlarge, odd, the 1-px clamp
SIZES = [(640, 480), (480, 640), (640, 640), (1920, 1080), (1280, 720),
         (320, 240), (100, 37), (333, 517), (641, 479), (1, 4000)]
LAYOUTS = ["pixel", "packed"]


def _frame(w, h, seed=0):
    return np.random.default_rng([seed, w, h]).integers(0, 256, (h, w, 3),
                                                        dtype=np.uint8)


def _pil(frame, size, packed):
    want = letterbox_image(Image.fromarray(frame), size)[0]
    return pack_s2d_host(want) if packed else want


def _staged(frames, size, packed=False, staging=None):
    """(staging, its letterbox of `frames`) on the CPU."""
    staging = staging or letterbox_cuda.Staging("cpu")
    return staging, staging.letterbox(frames, size, packed)


def _assert_pil(out, frames, size, packed):
    for i, frame in enumerate(frames):
        want = _pil(frame, size, packed)
        got = out[i].cpu().numpy()
        assert got.shape == want.shape
        assert np.array_equal(got, want), (
            f"image {i} ({frame.shape[1]}x{frame.shape[0]}): "
            f"{int((got != want).sum())} bytes differ from PIL's")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("wh", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_plain_equals_pil(wh, layout):
    frames = [_frame(*wh)]
    out = _staged(frames, S, layout == "packed")[1][0]
    _assert_pil(out, frames, S, layout == "packed")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mixed_batch_equals_pil_and_letterbox_input(layout):
    frames = [_frame(w, h, seed=i) for i, (w, h) in enumerate(SIZES)]
    staging, (imgs, *params) = _staged(frames, S, layout == "packed")
    _assert_pil(imgs, frames, S, layout == "packed")
    want = torch.tensor([letterbox_input(f, S)[1:] for f in frames],
                        dtype=torch.float32)
    assert torch.equal(torch.stack(params, 1), want)
    # the copy branch where the letterboxed size is the frame's own
    taps = staging.table[:, [letterbox_cuda.FIELDS.index("x_taps"),
                             letterbox_cuda.FIELDS.index("y_taps")]]
    copied = [i for i, (w, h) in enumerate(SIZES) if max(w, h) == S]
    assert [i for i in range(len(SIZES)) if not taps[i].any()] == copied


def test_staging_reused_across_calls_that_grow_and_shrink():
    staging = letterbox_cuda.Staging("cpu")
    calls = [[(1920, 1080), (1280, 720)], [(100, 37), (640, 480)],
             [(333, 517)], [(1920, 1080), (320, 240), (1, 4000)]]
    sizes = []
    for i, shapes in enumerate(calls):
        frames = [_frame(w, h, seed=10 + i) for w, h in shapes]
        staging, out = _staged(frames, S, staging=staging)
        sizes.append(staging.buffer.numel())
        _assert_pil(out[0], frames, S, False)
    # grown by the first call, kept by the two smaller ones
    assert sizes[1] == sizes[2] == sizes[0]


def test_staging_takes_read_only_and_strided_frames():
    read_only = _frame(333, 517)
    read_only.flags.writeable = False
    strided = _frame(1282, 720)[:, ::-2]  # 641 wide, a negative stride
    frames = [read_only, strided, _frame(640, 480)]
    _assert_pil(_staged(frames, S)[1][0],
                [np.ascontiguousarray(f) for f in frames], S, False)


def test_plain_refuses_what_the_kernel_refuses():
    staging = letterbox_cuda.Staging("cpu")
    with pytest.raises(ValueError, match="multiple|divides"):
        staging.letterbox([_frame(40, 30)], 72)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        letterbox_cuda.Staging("meta")
    staging.letterbox([_frame(40, 30)], 64)
    with pytest.raises(ValueError, match="images whose table"):
        letterbox_cuda.letterbox_plain(staging.buffer[:64], 1, 64)


# --- the kernel's chunk walk (csrc/letterbox.cu), modelled in Python ---

PAD = 114


def _clip8(acc):
    return min(max(acc >> letterbox_cuda.PRECISION_BITS, 0), 255)


class _Image:
    """`load_image` of the kernel: a table row and its pointers."""

    def __init__(self, buf, b):
        row = buf[b * 128:(b + 1) * 128].view(np.int32)
        f = dict(zip(letterbox_cuda.FIELDS, row.tolist()))
        self.buf, self.src, self.w = buf, f["src"] * 16, f["w"]
        self.nh, self.nw = f["new_h"], f["new_w"]
        self.pt, self.pl = f["pad_top"], f["pad_left"]
        self.xt, self.yt = f["x_taps"], f["y_taps"]
        self.xc, self.yc = f["x_coef"] * 16, f["y_coef"] * 16

    def ints(self, off, i):
        return int(self.buf[off + 4 * i:off + 4 * i + 4].view(np.int32)[0])

    def src_pixel(self, y, x):
        p = self.src + (y * self.w + x) * 3
        return [int(v) for v in self.buf[p:p + 3]]

    def h_pixel(self, y, cx):
        if self.xt == 0:
            return self.src_pixel(y, cx)
        xmin, n = self.ints(self.xc, 2 * cx), self.ints(self.xc, 2 * cx + 1)
        k = self.xc + 4 * (2 * self.nw + cx * self.xt)
        s = [1 << 21] * 3
        for i in range(n):
            c = self.ints(k, i)
            px = self.src_pixel(y, xmin + i)
            s = [a + v * c for a, v in zip(s, px)]
        return [_clip8(a) for a in s]

    def pixel(self, y, x):
        cy, cx = y - self.pt, x - self.pl
        if not (0 <= cy < self.nh and 0 <= cx < self.nw):
            return [PAD] * 3
        if self.yt == 0:
            return self.h_pixel(cy, cx)
        ymin, n = self.ints(self.yc, 2 * cy), self.ints(self.yc, 2 * cy + 1)
        k = self.yc + 4 * (2 * self.nh + cy * self.yt)
        s = [1 << 21] * 3
        for j in range(n):
            c = self.ints(k, j)
            s = [a + v * c for a, v in zip(s, self.h_pixel(ymin + j, cx))]
        return [_clip8(a) for a in s]


def _load16(buf, p):
    """Five aligned little-endian words funnel-shifted right by p % 4."""
    a = p & ~3
    w = [int(v) for v in buf[a:a + 20].view("<u4")]
    sh = (p & 3) * 8
    words = [(((hi << 32) | lo) >> sh) & 0xFFFFFFFF
             for lo, hi in zip(w, w[1:])]
    return np.array(words, "<u4").view(np.uint8)


def _build16(g, size, o, packed):
    out, cache = [], None
    row_bytes, quads = 3 * size, size // 4
    for t in range(16):
        if packed:
            cell, k = divmod(o, 48)
            ci, cj = divmod(cell, quads)
            ab, c = divmod(k + t, 3)
            y, x = 4 * ci + (ab >> 2), 4 * cj + (ab & 3)
        else:
            y, r = divmod(o, row_bytes)
            x, c = divmod(r + t, 3)
        if cache is None or cache[0] != (y, x):
            cache = ((y, x), g.pixel(y, x))
        out.append(cache[1][c])
    return np.array(out, np.uint8)


def _kernel_model(buf, b, size, packed):
    row_bytes = 3 * size
    chunks = row_bytes * size // 16
    out = np.empty((b, chunks, 16), np.uint8)
    for i in range(b):
        g = _Image(buf, i)
        for q in range(chunks):
            o = 16 * q
            if packed:
                out[i, q] = _build16(g, size, o, True)
                continue
            y, r = divmod(o, row_bytes)
            cy, x0, x1 = y - g.pt, r // 3, (r + 15) // 3
            if (cy < 0 or cy >= g.nh or x1 < g.pl or x0 >= g.pl + g.nw):
                out[i, q] = PAD
            elif (g.xt == 0 and g.yt == 0 and x0 >= g.pl
                  and x1 < g.pl + g.nw):
                out[i, q] = _load16(buf, g.src + cy * g.w * 3 + r - 3 * g.pl)
            else:
                out[i, q] = _build16(g, size, o, False)
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_chunk_walk_model_equals_plain(layout):
    size, packed = 32, layout == "packed"
    # copies offset by 1, 2 and 3 bytes from a word, shrink, enlarge, odd,
    # a vertical pass alone
    shapes = [(32, 24), (27, 32), (30, 32), (29, 32), (100, 37), (20, 13),
              (33, 51), (1, 200)]
    frames = [_frame(w, h, seed=3) for w, h in shapes]
    staging, (want, *_) = _staged(frames, size, packed)
    # the device buffer's 16 bytes of slack past the last frame
    host = np.concatenate([staging.buffer.numpy(), np.zeros(16, np.uint8)])
    got = _kernel_model(host, len(frames), size, packed)
    assert np.array_equal(got.reshape(-1), want.numpy().reshape(-1))


# --- BatchPredictor against the host path it replaced ---

CFG = YoloConfig(num_classes=2, img_size=64, width_mult=0.25,
                 depth_mult=0.33)
P3 = dict(packed_stem=True, packed_interior=True, packed_p3=True)
# (h, w): scale 1 both ways, then shrink, enlarge and odd
FRAME_SHAPES = [(48, 64), (64, 40), (37, 100), (20, 30), (51, 33), (64, 64)]


def _host_path_lists(pred, frames):
    """The parent's `BatchPredictor.stage` arithmetic: `letterbox_input`
    of every frame, `np.stack`, a float32 params tensor."""
    cfg = pred.cfg
    staged = [letterbox_input(f, cfg.img_size) for f in frames]
    batch = np.stack([s[0] for s in staged])
    if cfg.packed_stem:
        batch = pack_s2d_host(batch)
    params = torch.tensor([s[1:] for s in staged], dtype=torch.float32)
    out = pred.postprocess(torch.from_numpy(batch), *params.unbind(1))
    return detections_per_image(*out, len(frames))


@pytest.mark.parametrize("kind", ["float", "int8", "packed"])
def test_batch_predictor_lists_equal_the_host_path(kind):
    torch.manual_seed(0)
    cfg = CFG.with_(**P3) if kind == "packed" else CFG
    state = YOLO(CFG).state_dict()
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in FRAME_SHAPES]
    pred = BatchPredictor(state, cfg, conf_threshold=0.01, max_outputs=20,
                          device="cpu",
                          quantize_calib=frames[:2] if kind == "int8"
                          else None)
    got = pred(frames)
    assert sum(map(len, got)) > 0
    assert got == _host_path_lists(pred, frames)


def test_non_rgb_arrays_stage_as_letterbox_input_converts_them():
    rng = np.random.default_rng(6)
    frames = [rng.integers(0, 256, (37, 50), dtype=np.uint8),
              rng.integers(0, 256, (64, 48, 4), dtype=np.uint8),
              rng.random((30, 64, 3)) * 255]
    torch.manual_seed(0)
    pred = BatchPredictor(YOLO(CFG).state_dict(), CFG, device="cpu")
    imgs, *params = pred.stage(frames)
    for i, f in enumerate(frames):
        want = letterbox_input(f, CFG.img_size)
        assert np.array_equal(imgs[i].numpy(), want[0])
        assert [p[i].item() for p in params] == [
            float(np.float32(v)) for v in want[1:]]



@pytest.mark.parametrize("kind", ["float", "packed"])
def test_stage_after_a_call_writes_the_staging_outside_inference_mode(kind):
    """The staging buffers are made on the first call, under inference
    mode; `stage` outside it writes them again (writable C-contiguous
    frames take torch's copy into the buffer)."""
    torch.manual_seed(0)
    cfg = CFG.with_(**P3) if kind == "packed" else CFG
    pred = BatchPredictor(YOLO(CFG).state_dict(), cfg, conf_threshold=0.01,
                          max_outputs=20, device="cpu")
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in FRAME_SHAPES]
    assert all(f.flags.writeable and f.flags.c_contiguous for f in frames)
    got = pred(frames)
    args = pred.stage(frames)
    assert not args[0].is_inference()
    with torch.inference_mode():
        out = pred.postprocess(*args)
    assert detections_per_image(*out, len(frames)) == got
    assert pred(frames) == got


# --- on the card ---


@pytest.mark.card
@pytest.mark.parametrize("layout", LAYOUTS)
def test_card_kernel_equals_pil_one_launch_a_call(layout):
    if not torch.cuda.is_available():
        pytest.skip("L1 runs on a CUDA card; this host has none")
    packed = layout == "packed"
    frames = [_frame(w, h, seed=i) for i, (w, h) in enumerate(SIZES)]
    staging = letterbox_cuda.Staging("cuda")
    launches, resampled = letterbox_cuda.launches, letterbox_cuda.resampled
    imgs, *params = staging.letterbox(frames, S, packed)
    torch.cuda.synchronize()
    _assert_pil(imgs, frames, S, packed)
    want = torch.tensor([letterbox_input(f, S)[1:] for f in frames],
                        dtype=torch.float32)
    assert torch.equal(torch.stack(params, 1).cpu(), want)
    n_resized = sum(max(w, h) != S for w, h in SIZES)
    assert letterbox_cuda.launches == launches + 1
    assert letterbox_cuda.resampled == resampled + n_resized
    # the predictor: one launch a call; resized images alone counted
    torch.manual_seed(0)
    cfg = CFG.with_(**P3) if packed else CFG
    pred = BatchPredictor(YOLO(CFG).state_dict(), cfg, conf_threshold=0.01,
                          device="cuda")
    small = [np.ascontiguousarray(f[:64, :48]) for f in frames[:3]] + [
        _frame(100, 37)]
    for call in range(3):
        launches, resampled = (letterbox_cuda.launches,
                               letterbox_cuda.resampled)
        pred(small)
        assert letterbox_cuda.launches == launches + 1
        assert letterbox_cuda.resampled == resampled + 1
