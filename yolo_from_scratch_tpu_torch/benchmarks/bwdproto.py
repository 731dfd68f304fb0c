"""Prototype fused backwards of the 3x3 64->64 convs on the card: K3 (the
patch matrix) and K4 (per-tap products), counterpart of the JAX
repository's `benchmarks/bwdproto.py`.

Both compute, for y = conv(x, w) stride 1 SAME with NHWC x, dy and HWIO w,
dx and dW in one pass that reads x and dy once:

    K3   dW = X9^T @ dy       X9  = (pixels, 9C) shifted-patch matrix of x
         dx = DY9 @ W9flip    DY9 = the same of dy, W9flip[t*C + co, ci] =
                              w[2-i, 2-j, ci, co]
    K4   the same as 9 accumulating per-tap products, dx summed in float32

`make_fused_bwd` / `make_fused_bwd_v2` keep the JAX names and layout:
fused(x, dy, w) -> (dx in x's dtype, dW float32 HWIO). A CPU tensor runs
the plain version (`fused_bwd_patch_plain`, `fused_bwd_tap_plain`), a CUDA
tensor the hand-written kernel (`csrc/conv_bwd_patch.cu`,
`csrc/conv_bwd_tap.cu`); anything else raises. `launches` counts kernel
launches and nothing else.

`main` checks both against autograd of `F.conv2d` (TF32 off) and times
them at the training path's two bf16 shapes against one library call that
computes the same function (`torch.ops.aten.convolution_backward`: cuDNN's
dgrad + wgrad) and the port's shipped kernel K2, then projects the saving
over the gated convs of the port's 's' @640 bf16 step, counted from the
model. The library call is a yardstick only; the port never calls it.

Usage: python -m yolo_from_scratch_tpu_torch.benchmarks.bwdproto
           [--iters 3] [--device cuda|cpu]
`--device cpu` checks the plain versions and skips timing (the JAX
script's `--interpret`).
"""

from __future__ import annotations

import argparse
import collections

import numpy as np
import torch
import torch.nn.functional as F

from yolo_from_scratch_tpu_torch import YoloConfig
from yolo_from_scratch_tpu_torch.device import cuda_device, tf32_disabled
from yolo_from_scratch_tpu_torch.ops import conv_bwd
from yolo_from_scratch_tpu_torch.utils import roofline
from yolo_from_scratch_tpu_torch.utils.timing import log, time_per_iter

C = 64
TAPS = [(i, j) for i in range(3) for j in range(3)]
LAUNCHES_PER_CALL = 2  # the tile kernel and the sum of its dW partials
launches = {"conv_bwd_patch": 0, "conv_bwd_tap": 0}
LOOP = (50, 550)  # the two loop lengths of `time_per_iter`, as in JAX


def flip9(w, dtype):
    """W9flip (9C, C) in `dtype` from HWIO w: row t*C + co, column ci =
    w[2-i, 2-j, ci, co], the weights of the input-gradient conv."""
    c = w.shape[-1]
    return w.flip(0, 1).permute(0, 1, 3, 2).reshape(9 * c, c).to(dtype)


def flip9t(w, dtype):
    """W9T (9C, C) in `dtype` from HWIO w: W9flip transposed tap by tap,
    row t*C + ci, column co = w[2-i, 2-j, ci, co] (the bf16 kernels' layout,
    K3, K4 and K5: each tap's block is the K-major B operand of its dx
    product, loaded by TMA as it lies)."""
    c = w.shape[-1]
    return w.flip(0, 1).reshape(9 * c, c).to(dtype)


def weight_layout(w, dtype):
    """The weights as the kernels read them, from HWIO w: W9T in bf16
    (loaded by TMA), W9flip in float32; contiguous, in `dtype`."""
    flip = flip9t if dtype == torch.bfloat16 else flip9
    return flip(w, dtype).contiguous()


def pad_hw(t):
    """Zero-pad the H and W axes of an NHWC tensor by one pixel."""
    return F.pad(t, (0, 0, 1, 1, 1, 1))


def tap_products(x, g, w9f):
    """The per-tap form of one conv's backward, in float32: for each tap
    t, dW[t] = shift_t(x)^T @ g and dx += shift_t(g) @ w9f[t]. x, g NHWC
    (any float dtype, taken as float32), w9f (9C, C) float32. Returns (dW
    (9C, C), dx (B, H, W, C)), both float32 and unrounded."""
    b, h, w, c = x.shape
    xp, gp = pad_hw(x.float()), pad_hw(g.float())
    gf = g.float().reshape(-1, c)
    dw = torch.empty((9 * c, c), dtype=torch.float32, device=x.device)
    dx = torch.zeros((b * h * w, c), dtype=torch.float32, device=x.device)
    for t, (i, j) in enumerate(TAPS):
        dw[t * c:(t + 1) * c] = xp[:, i:i + h, j:j + w].reshape(-1, c).T @ gf
        dx += gp[:, i:i + h, j:j + w].reshape(-1, c) @ w9f[t * c:(t + 1) * c]
    return dw, dx.reshape(b, h, w, c)


def fused_bwd_patch_plain(x, dy, w):
    """K3's formulation in plain torch: the X9 and DY9 patch matrices and
    two products, in float32 from the compute-dtype inputs (exact for
    bf16). Returns dx in x's dtype (rounded once) and dW float32 HWIO."""
    b, h, wd, c = x.shape
    x9 = conv_bwd._patches(x.permute(0, 3, 1, 2)).float()
    dw9 = torch.matmul(x9.transpose(1, 2),
                       dy.reshape(b, h * wd, c).float()).sum(0)
    dy9 = conv_bwd._patches(dy.permute(0, 3, 1, 2)).float()
    dx = torch.matmul(dy9, flip9(w, x.dtype).float()).to(x.dtype)
    return dx.reshape(b, h, wd, c), dw9.reshape(3, 3, c, c)


def fused_bwd_tap_plain(x, dy, w):
    """K4's formulation in plain torch: nine accumulating per-tap products
    into a float32 dx, rounded to x's dtype once. Returns (dx, dW float32
    HWIO)."""
    dw9, dx = tap_products(x, dy, flip9(w, x.dtype).float())
    c = x.shape[-1]
    return dx.to(x.dtype), dw9.reshape(3, 3, c, c)


def check_inputs(acts, w_list, shape=None, dtype=None):
    """Raise unless the activations `acts` are (B, H, W, 64) tensors of one
    float32 or bfloat16 dtype and the weights (3, 3, 64, 64), all on one
    device; `shape` and `dtype`, when given, are what the maker was built
    for. Returns the device type."""
    x = acts[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"takes float32 or bfloat16 activations, got "
                        f"{x.dtype}")
    if any(a.dtype != x.dtype for a in acts):
        raise TypeError(f"activations must share a dtype, got "
                        f"{[a.dtype for a in acts]}")
    if dtype is not None and x.dtype != dtype:
        raise TypeError(f"built for {dtype}, got {x.dtype}")
    if x.ndim != 4 or x.shape[-1] != C or any(a.shape != x.shape
                                              for a in acts):
        raise ValueError(f"expected (B, H, W, {C}) activations of one "
                         f"shape, got {[tuple(a.shape) for a in acts]}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"built for {tuple(shape)}, got {tuple(x.shape)}")
    if any(tuple(w.shape) != (3, 3, C, C) for w in w_list):
        raise ValueError(f"expected (3, 3, {C}, {C}) HWIO weights, got "
                         f"{[tuple(w.shape) for w in w_list]}")
    devices = {t.device for t in (*acts, *w_list)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"takes CPU or CUDA tensors, got {x.device}")
    return x.device.type


def launch_env(x):
    """(library, SM count, stream, bf16 flag, error text) for a kernel
    launch on x's card."""
    from yolo_from_scratch_tpu_torch.kernels.build import load_library

    lib = load_library()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return (lib, sms, torch.cuda.current_stream(x.device).cuda_stream,
            int(x.dtype == torch.bfloat16),
            lambda rc: f"{lib.conv3x3_bwd_error_string(rc).decode()} ({rc})")


def _launch(name, x, dy, w):
    """dx, dW of one conv through kernel `name` (conv_bwd_patch or
    conv_bwd_tap): the tile kernel, then the fixed-order sum of its dW
    partials. x and dy must be contiguous (the kernels read them by TMA or
    by dense indexing); nothing is copied. The weights go in the layout
    the kernel reads: W9T in bf16, W9flip in float32."""
    for t, label in ((x, "x"), (dy, "dy")):
        conv_bwd.check_tma_operand(t, label, channels_last=False)
    w9 = weight_layout(w, x.dtype)
    b, h, wd, c = x.shape
    dx = torch.empty_like(x)
    dw = torch.empty((3, 3, c, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        lib, sms, stream, bf16, error = launch_env(x)
        grid, ws_floats = conv_bwd.launch_plan(lib, name, b, h, wd, bf16, sms)
        workspace = torch.empty(ws_floats, dtype=torch.float32,
                                device=x.device)
        rc = getattr(lib, name)(
            x.data_ptr(), dy.data_ptr(), w9.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), workspace.data_ptr(), b, h, wd, grid, bf16,
            stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: {error(rc)}")
    launches[name] += LAUNCHES_PER_CALL
    return dx, dw


def _fused(name, plain, shape, dtype):
    if shape[-1] != C:
        raise ValueError(f"the kernels take {C} channels, got {shape[-1]}")

    def fused(x, dy, w):
        if check_inputs((x, dy), (w,), shape, dtype) == "cpu":
            return plain(x, dy, w)
        return _launch(name, x, dy, w)

    return fused


def make_fused_bwd(B, H, W, C_, dtype=torch.bfloat16):
    """K3: fused(x, dy, w) -> (dx, dW float32 HWIO) for (B, H, W, C) NHWC
    x, dy in `dtype` and HWIO w, through `fused_bwd_patch_plain` on CPU
    tensors and the conv_bwd_patch kernel on CUDA tensors. C must be 64."""
    return _fused("conv_bwd_patch", fused_bwd_patch_plain, (B, H, W, C_),
                  dtype)


def make_fused_bwd_v2(B, H, W, C_, dtype=torch.bfloat16):
    """K4: as `make_fused_bwd`, through `fused_bwd_tap_plain` and the
    conv_bwd_tap kernel."""
    return _fused("conv_bwd_tap", fused_bwd_tap_plain, (B, H, W, C_), dtype)


def model_shapes(cfg, module_type, keep):
    """{(H, W): count} over the calls of `module_type` modules in one
    forward of `cfg`'s model (batch 1, on the meta device: shapes only)
    whose NCHW input shape passes keep(module, shape)."""
    from yolo_from_scratch_tpu_torch.models.yolo import YOLO

    model = YOLO(cfg, device="meta")
    found = collections.Counter()

    def hook(module, args):
        if keep(module, args[0].shape):
            found[tuple(args[0].shape[2:])] += 1

    for m in model.modules():
        if isinstance(m, module_type):
            m.register_forward_pre_hook(hook)
    with torch.no_grad():
        model(torch.empty((1, cfg.img_size, cfg.img_size, 3), device="meta"))
    return dict(sorted(found.items()))


def step_config():
    """The training step the projections are for: 's' @640, bf16."""
    return YoloConfig.from_size("s", num_classes=1, img_size=640,
                                compute_dtype="bfloat16")


def gated_convs(cfg):
    """{(H, W): n}: the convs of `cfg`'s model whose backward the fused
    gate selects once switched on (`ops/conv_bwd.py::fused_bwd_fits`, as
    `ConvBNSiLU.forward` applies it)."""
    from yolo_from_scratch_tpu_torch.models.blocks import ConvBNSiLU

    def keep(m, s):
        conv = m.conv
        return conv.bias is None and conv_bwd.fused_bwd_fits(
            conv.kernel_size[0], conv.stride[0], s[1], conv.out_channels,
            s[2], s[3], m.dtype)

    return model_shapes(cfg, ConvBNSiLU, keep)


def _inputs(B, H, W, dtype, device):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, C)) * 0.05).astype(np.float32)
    dy = rng.standard_normal((B, H, W, C)).astype(np.float32)
    return [torch.from_numpy(a).to(device=device, dtype=dtype)
            for a in (x, w, dy)]


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _oihw(w):
    return w.permute(3, 2, 0, 1)


def rel_err(got, ref):
    """max |got - ref| / max |ref|, in float64."""
    ref = ref.double()
    return ((got.double() - ref).abs().max() / (ref.abs().max() + 1e-9)).item()


def check_correctness(B, H, W, device):
    """K3 and K4 (their plain versions on the CPU) against autograd of
    `F.conv2d` in float32 with TF32 off; relative error below 1e-4, as the
    JAX check."""
    x, w, dy = _inputs(B, H, W, torch.float32, device)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    with tf32_disabled():
        y = F.conv2d(_nchw(xr), _oihw(wr), padding=1).permute(0, 2, 3, 1)
        dx_ref, dw_ref = torch.autograd.grad(y, (xr, wr), dy)
        for name, mk in (("K3 patch", make_fused_bwd),
                         ("K4 tap", make_fused_bwd_v2)):
            dx, dw = mk(B, H, W, C, torch.float32)(x, dy, w)
            err_dx, err_dw = rel_err(dx, dx_ref), rel_err(dw, dw_ref)
            log(f"correctness {name} {B}x{H}x{W}x{C} ({device}): rel err dx "
                f"{err_dx:.2e} dw {err_dw:.2e}")
            assert err_dx < 1e-4 and err_dw < 1e-4, (name, err_dx, err_dw)


def roofline_floor_s(B, H, W, convs, itemsize=2):
    """H100 data-sheet floor (not a measurement) for the backward of
    `convs` 3x3 C->C convs: `utils.roofline.conv3x3_bwd_work` (x and dy
    read, dx written, the weights read and dW written; 4 * B*H*W*9*C*C
    flops) at 3.35 TB/s and the dtype's peak (bf16 989 TFLOP/s, float32 67
    TFLOP/s), whichever is slower. Seconds."""
    flops, bytes_ = roofline.conv3x3_bwd_work(B, H, W, itemsize)
    dtype = "bfloat16" if itemsize == 2 else "float32"
    return roofline.bound_ms(convs * flops, convs * bytes_, dtype)[0] / 1e3


def library_bwd(x, dy, w):
    """The one PyTorch call that computes dx and dW of y = conv2d(x, w,
    padding=1): `aten.convolution_backward` (cuDNN's dgrad and wgrad on
    the card). x, dy NCHW, w OIHW. A yardstick for timing only."""
    return torch.ops.aten.convolution_backward(
        dy, x, w, None, (1, 1), (1, 1), (1, 1), False, (0, 0), 1,
        (True, True, False))


def bench_shape(B, H, W, reps, dtype=torch.bfloat16):
    """Seconds per call of the library's backward (cuDNN), K3, K4 and K2
    at one shape; returns (cuDNN, the better of K3 and K4)."""
    dev = cuda_device()
    x, w, dy = _inputs(B, H, W, dtype, dev)
    xn, dyn, wo = _nchw(x), _nchw(dy), _oihw(w).contiguous()
    k3 = make_fused_bwd(B, H, W, C, dtype)
    k4 = make_fused_bwd_v2(B, H, W, C, dtype)

    def cudnn():
        library_bwd(xn, dyn, wo)

    arms = {"cuDNN": cudnn, "K3-patch": lambda: k3(x, dy, w),
            "K4-tap": lambda: k4(x, dy, w),
            "K2": lambda: conv_bwd._launch(xn, dyn, wo)}
    t = {k: time_per_iter(fn, *LOOP, reps=reps) for k, fn in arms.items()}
    best = min(t["K3-patch"], t["K4-tap"])
    log(f"bwd {B}x{H}x{W}x{C} {str(dtype).split('.')[1]}: "
        + "   ".join(f"{k} {v * 1e6:7.1f} us" for k, v in t.items())
        + f"   H100 data-sheet floor {roofline_floor_s(B, H, W, 1) * 1e6:5.1f}"
        f" us   (best prototype {t['cuDNN'] / best:.2f}x cuDNN's speed)")
    return t["cuDNN"], best


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3,
                    help="timings of each loop length (median taken)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: check the plain versions, skip timing")
    a = ap.parse_args(argv)

    dev = torch.device("cpu") if a.device == "cpu" else cuda_device()
    log(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    check_correctness(2, 16, 16, dev)
    if dev.type == "cpu":
        log("cpu: plain versions checked, timing skipped")
        return 0
    check_correctness(8, 40, 40, dev)
    check_correctness(8, 80, 80, dev)
    counts = gated_convs(step_config())
    log(f"gated 3x3 64-channel convs in the 's' @640 bf16 step: "
        + ", ".join(f"{n} at {h}x{w}" for (h, w), n in counts.items()))
    times = {(h, w): bench_shape(8, h, w, a.iters)
             for h, w in ((80, 80), (40, 40))}
    missing = set(counts) - set(times)
    if missing:
        raise AssertionError(f"gated convs at unbenched shapes {missing}")
    saved = sum(n * (times[s][0] - times[s][1]) for s, n in counts.items())
    log(f"projected step saving over cuDNN with the better prototype at "
        + " + ".join(f"{n}x{h}" for (h, _), n in counts.items())
        + f" convs: {saved * 1e3:+.3f} ms")
    log(f"launches: conv_bwd_patch {launches['conv_bwd_patch']} "
        f"conv_bwd_tap {launches['conv_bwd_tap']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
