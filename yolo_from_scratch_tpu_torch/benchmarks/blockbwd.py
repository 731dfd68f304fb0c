"""Backward through a whole bottleneck chain in one kernel on the card: K5,
counterpart of the JAX repository's `benchmarks/blockbwd.py`.

Chain (s1, s2 per-channel folded BN scales, both convs 3x3 stride 1 SAME,
64 channels, NHWC activations, HWIO weights):

    z1 = conv1(x) * s1;  a1 = silu(z1);  y = x + conv2(a1) * s2

and its backward given dy, with every product summed in float32 and the
gradients rounded to the compute dtype where the TPU kernel rounds them:

    dz2 = round(dy * s2)
    dw2[t] = shift_t(a1)^T @ dz2          da1 = sum_t shift_t(dz2) @ w2f[t]
    dz1 = round(da1 * silu'(z1) * s1)
    dw1[t] = shift_t(x)^T @ dz1           dx = round(sum_t shift_t(dz1) @ w1f[t] + dy)

This is the prototype's chain, not the model's `Bottleneck` (which adds a
BN bias and a second SiLU). `make_chain_bwd` keeps the JAX name and
layout: fused(x, z1, a1, dy, w1, w2, s1, s2) -> (dx, dw1, dw2), dw float32
HWIO, s1 and s2 taken as float32. A CPU tensor runs `chain_bwd_plain`, a
CUDA tensor the hand-written kernel `csrc/chain_bwd.cu`, in which dz1
never leaves the chip; anything else raises. `launches` counts kernel
launches and nothing else.

`main` checks K5 against autograd of `chain_fwd` (TF32 off) and times the
chain's forward + backward with K5 against autograd with cuDNN at the
training path's two bf16 shapes, then projects the step delta over the
64-channel bottlenecks of the port's 's' @640 bf16 model.

Usage: python -m yolo_from_scratch_tpu_torch.benchmarks.blockbwd
           [--iters 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from yolo_from_scratch_tpu_torch.benchmarks.bwdproto import (
    C,
    LAUNCHES_PER_CALL,
    LOOP,
    check_inputs,
    flip9,
    launch_env,
    model_shapes,
    rel_err,
    roofline_floor_s,
    step_config,
    tap_products,
    weight_layout,
)
from yolo_from_scratch_tpu_torch.device import cuda_device, tf32_disabled
from yolo_from_scratch_tpu_torch.ops import conv_bwd
from yolo_from_scratch_tpu_torch.utils.timing import log, time_per_iter

launches = 0


def _conv(x, w):
    """Stride-1 SAME 3x3 conv of NHWC x with HWIO w, NHWC out."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def chain_fwd(x, w1, w2, s1, s2):
    """(z1, a1, y) of the chain; the scales are cast to x's dtype, as the
    JAX forward does."""
    z1 = _conv(x, w1) * s1.to(x.dtype)
    a1 = F.silu(z1)
    return z1, a1, x + _conv(a1, w2) * s2.to(x.dtype)


def _silu_grad(z):
    """silu'(z) = sig * (1 + z * (1 - sig)), z float32."""
    sig = torch.sigmoid(z)
    return sig * (1.0 + z * (1.0 - sig))


def chain_bwd_plain(x, z1, a1, dy, w1, w2, s1, s2):
    """K5's formulation in plain torch: per-tap products in float32 from
    the compute-dtype inputs; dz2 and dz1 rounded to the compute dtype
    where the kernel rounds them; dx = (conv1 backprop + dy) rounded once.
    Returns (dx, dw1, dw2), the weight gradients float32 HWIO."""
    dt, c = x.dtype, x.shape[-1]
    s1, s2 = s1.float().reshape(c), s2.float().reshape(c)
    dz2 = (dy.float() * s2).to(dt)
    dw2, da1 = tap_products(a1, dz2, flip9(w2, dt).float())
    dz1 = (da1 * _silu_grad(z1.float()) * s1).to(dt)
    dw1, g = tap_products(x, dz1, flip9(w1, dt).float())
    dx = (g + dy.float()).to(dt)
    return dx, dw1.reshape(3, 3, c, c), dw2.reshape(3, 3, c, c)


def _launch(x, z1, a1, dy, w1, w2, s1, s2):
    """dx, dw1, dw2 through the chain_bwd kernel: the tile kernel, then
    the fixed-order sum of its dW partials. The activations must be
    contiguous NHWC with 16-byte aligned bases (the bf16 kernel reads them
    by TMA); nothing is copied. The weights go in the layout the kernel
    reads (W9T in bf16, W9flip in float32), the scales as float32."""
    global launches
    for t, label in ((x, "x"), (z1, "z1"), (a1, "a1"), (dy, "dy")):
        conv_bwd.check_tma_operand(t, label, channels_last=False)
    w1f, w2f = (weight_layout(w, x.dtype) for w in (w1, w2))
    s1, s2 = (s.float().reshape(C).contiguous() for s in (s1, s2))
    b, h, wd, c = x.shape
    dx = torch.empty_like(x)
    dws = torch.empty((2, 3, 3, c, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        lib, sms, stream, bf16, error = launch_env(x)
        grid, ws_floats = conv_bwd.launch_plan(lib, "chain_bwd", b, h, wd,
                                               bf16, sms)
        workspace = torch.empty(ws_floats, dtype=torch.float32,
                                device=x.device)
        rc = lib.chain_bwd(
            x.data_ptr(), z1.data_ptr(), a1.data_ptr(), dy.data_ptr(),
            w1f.data_ptr(), w2f.data_ptr(), s1.data_ptr(), s2.data_ptr(),
            dx.data_ptr(), dws.data_ptr(), workspace.data_ptr(), b, h, wd,
            grid, bf16, stream)
    if rc != 0:
        raise RuntimeError(f"chain_bwd kernel launch failed: {error(rc)}")
    launches += LAUNCHES_PER_CALL
    return dx, dws[0], dws[1]


def make_chain_bwd(B, H, W, C_, dtype=torch.bfloat16):
    """fused(x, z1, a1, dy, w1, w2, s1, s2) -> (dx, dw1, dw2) for (B, H, W,
    C) NHWC activations in `dtype`, HWIO weights and (C,) scales, through
    `chain_bwd_plain` on CPU tensors and the chain_bwd kernel on CUDA
    tensors. C must be 64."""
    if C_ != C:
        raise ValueError(f"the kernel takes {C} channels, got {C_}")

    def fused(x, z1, a1, dy, w1, w2, s1, s2):
        kind = check_inputs((x, z1, a1, dy), (w1, w2), (B, H, W, C_), dtype)
        if s1.numel() != C or s2.numel() != C or not (
                s1.device == s2.device == x.device):
            raise ValueError(f"expected ({C},) scales on {x.device}, got "
                             f"{tuple(s1.shape)} on {s1.device}, "
                             f"{tuple(s2.shape)} on {s2.device}")
        if kind == "cpu":
            return chain_bwd_plain(x, z1, a1, dy, w1, w2, s1, s2)
        return _launch(x, z1, a1, dy, w1, w2, s1, s2)

    return fused


def bottleneck_chains(cfg):
    """{(H, W): n}: the 64-channel residual bottlenecks of `cfg`'s model,
    each a conv -> SiLU -> conv chain of the kind K5 takes."""
    from yolo_from_scratch_tpu_torch.models.blocks import Bottleneck

    return model_shapes(cfg, Bottleneck, lambda m, s: s[1] == C)


def _inputs(B, H, W, dtype, device):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, C, C)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, C, C)) * 0.05).astype(np.float32)
    s1 = (rng.random(C) + 0.5).astype(np.float32)
    s2 = (rng.random(C) + 0.5).astype(np.float32)
    dy = rng.standard_normal((B, H, W, C)).astype(np.float32)
    t = lambda a, d=dtype: torch.from_numpy(a).to(device=device, dtype=d)
    return t(x), t(w1), t(w2), t(s1, torch.float32), t(s2, torch.float32), \
        t(dy)


def check_correctness(B, H, W, device):
    """K5 (its plain version on the CPU) against autograd of `chain_fwd` in
    float32 with TF32 off; relative error below 1e-4, as the JAX check."""
    x, w1, w2, s1, s2, dy = _inputs(B, H, W, torch.float32, device)
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, w2)]
    with tf32_disabled():
        y = chain_fwd(*leaves, s1, s2)[2]
        refs = torch.autograd.grad(y, leaves, dy)
        with torch.no_grad():
            z1, a1, _ = chain_fwd(x, w1, w2, s1, s2)
        got = make_chain_bwd(B, H, W, C, torch.float32)(
            x, z1, a1, dy, w1, w2, s1, s2)
    for name, g, r in zip(("dx", "dw1", "dw2"), got, refs):
        err = rel_err(g, r)
        log(f"correctness {name} {B}x{H}x{W}x{C} ({device}): rel err "
            f"{err:.2e}")
        assert err < 1e-4, (name, err)


def bench_chain(B, H, W, reps, dtype=torch.bfloat16):
    """Seconds per forward + backward of the chain: autograd with cuDNN,
    and `chain_fwd` followed by K5. Returns (autograd, K5)."""
    dev = cuda_device()
    x, w1, w2, s1, s2, dy = _inputs(B, H, W, dtype, dev)
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, w2)]
    fused = make_chain_bwd(B, H, W, C, dtype)

    def autograd_arm():
        y = chain_fwd(*leaves, s1, s2)[2]
        torch.autograd.grad(y, leaves, dy)

    def k5_arm():
        with torch.no_grad():
            z1, a1, _ = chain_fwd(x, w1, w2, s1, s2)  # cuDNN forward
        fused(x, z1, a1, dy, w1, w2, s1, s2)

    t_ref = time_per_iter(autograd_arm, *LOOP, reps=reps)
    t_k5 = time_per_iter(k5_arm, *LOOP, reps=reps)
    floor = roofline_floor_s(B, H, W, 2) + roofline_floor_s(B, H, W, 1)
    log(f"chain {B}x{H}x{W}x{C} fwd+bwd {str(dtype).split('.')[1]}: "
        f"autograd+cuDNN {t_ref * 1e6:7.1f} us   K5-chain {t_k5 * 1e6:7.1f} "
        f"us   H100 data-sheet floor {floor * 1e6:5.1f} us   "
        f"({t_ref / t_k5:.2f}x)")
    return t_ref, t_k5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3,
                    help="timings of each loop length (median taken)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: check the plain version, skip timing")
    a = ap.parse_args(argv)

    dev = torch.device("cpu") if a.device == "cpu" else cuda_device()
    log(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    check_correctness(2, 16, 16, dev)
    if dev.type == "cpu":
        log("cpu: plain version checked, timing skipped")
        return 0
    check_correctness(4, 40, 40, dev)
    counts = bottleneck_chains(step_config())
    log(f"64-channel bottleneck chains in the 's' @640 model: "
        + ", ".join(f"{n} at {h}x{w}" for (h, w), n in counts.items()))
    times = {(h, w): bench_chain(8, h, w, a.iters)
             for h, w in ((80, 80), (40, 40))}
    missing = set(counts) - set(times)
    if missing:
        raise AssertionError(f"chains at unbenched shapes {missing}")
    saved = sum(n * (times[s][0] - times[s][1]) for s, n in counts.items())
    log(f"projected step delta if every chain switched, at "
        + " + ".join(f"{n}x{h}" for (h, _), n in counts.items())
        + f" chains: {saved * 1e3:+.3f} ms "
        f"({'saves' if saved > 0 else 'LOSES'})")
    log(f"launches: chain_bwd {launches}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
