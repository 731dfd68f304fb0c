"""Post-training int8 quantization of the serving model (counterpart of
`yolo_from_scratch_tpu/infer/quantize.py`, its canonical layout). int8
under the packed layouts is not ported yet (ROADMAP A10b: Q2 does not take
the packed 2x2 convs' (1, 0) padding): the predictors raise on it and the
CLI's `--packed ... --int8` exits 2.

- **BN folding**: each ConvBNSiLU collapses to conv(W', b') with
  W' = W * gamma / sqrt(var + eps) per out-channel and
  b' = (b0 - mean) * gamma / sqrt(var + eps) + beta, in numpy float32 as
  the JAX package folds.
- **Weights**: symmetric per-out-channel int8, scale = max|W'_c| / 127.
- **Activations**: symmetric per-tensor int8, the scale calibrated by
  running images through the float model and recording each conv input's
  abs-max (or a percentile of |x|), the max over batches.
- **Execution**: `quantize_model` returns a copy of the model in which
  every quantized ConvBNSiLU is a `QuantConvBNSiLU`: Q1 (round and clip to
  int8), Q2 (the int8 conv with an int32 accumulator, then the
  per-channel dequant, the folded bias and SiLU), both in `ops/quant.py`,
  kernels on the card. The first conv (`stem0`) stays float by default,
  and the heads' 1x1 `pred` convs are plain convs, never quantized.

Calibration keys and the quantized tree's keys are the JAX module paths
(`a/b`; the port's module `a.b`, `utils/convert.py`), so a tree from
either package compares with the other's key by key. The tree holds numpy
arrays: `w_int8` (k, k, Cin, Cout) int8, `w_scale` and `bias` (Cout,)
float32, `a_scale` a float32 scalar.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from yolo_from_scratch_tpu_torch.models.blocks import ConvBNSiLU
from yolo_from_scratch_tpu_torch.models.fused_bn import BN_EPS
from yolo_from_scratch_tpu_torch.ops.quant import (
    dequant_vectors,
    input_inverse,
    pack_weights,
    quant_conv_silu,
)


def _key(name: str) -> str:
    """The JAX module path of a port module name."""
    return name.replace(".", "/")


def conv_modules(model: nn.Module):
    """(JAX path, module) of every float ConvBNSiLU, in module order."""
    return [(_key(name), mod) for name, mod in model.named_modules()
            if isinstance(mod, ConvBNSiLU)]


def _percentile(ax, percentile):
    """`jnp.percentile(ax, p)` of a flat float32 tensor: linear
    interpolation between the two nearest ranks. `torch.quantile` refuses
    inputs above 2^24 elements (a B=8 640x640 stem activation has 26 M), so
    the ranks come from `kthvalue`."""
    n = ax.numel()
    f32 = dict(dtype=torch.float32)
    # JAX's float32 arithmetic: q / 100, then q * (float32(n) - 1)
    pos = (torch.tensor(percentile, **f32) / 100.0) * (
        torch.tensor(n, **f32) - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1.0 - w_hi
    i_lo, i_hi = (min(max(int(i), 0), n - 1) for i in (lo, hi))
    v_lo = torch.kthvalue(ax, i_lo + 1).values
    v_hi = v_lo if i_hi == i_lo else torch.kthvalue(ax, i_hi + 1).values
    return v_lo * w_lo.to(ax.device) + v_hi * w_hi.to(ax.device)


def _stat(x, percentile):
    ax = x.float().abs().reshape(-1)
    return ax.max() if percentile is None else _percentile(ax, percentile)


def make_calibration_fn(model: nn.Module, percentile=None):
    """(imgs NHWC in [0, 1] on the model's device) -> {path: statistic of
    that ConvBNSiLU's input}, abs-max by default or the given percentile
    of |x| (e.g. 99.9: rare outliers clipped, finer steps for the bulk).
    Forward pre-hooks on each ConvBNSiLU record it for the one call."""

    def calib(imgs):
        rec = {}

        def hook_for(key):
            def hook(_module, args):
                m = _stat(args[0], percentile)
                rec[key] = torch.maximum(rec[key], m) if key in rec else m
            return hook

        handles = [mod.register_forward_pre_hook(hook_for(key))
                   for key, mod in conv_modules(model)]
        try:
            with torch.inference_mode():
                model(imgs)
        finally:
            for h in handles:
                h.remove()
        return rec

    return calib


def calibrate(model: nn.Module, batches, percentile=None):
    """Run calibration batches (each a (B, S, S, 3) float array in [0, 1])
    through the float model; returns {path: a_scale}, the max statistic
    over batches, max(v, 1e-8) / 127."""
    fn = make_calibration_fn(model, percentile)
    device = next(model.parameters()).device
    maxes = {}
    for imgs in batches:
        rec = fn(torch.as_tensor(np.asarray(imgs, np.float32)).to(device))
        vals = torch.stack(list(rec.values())).tolist()
        for key, val in zip(rec, vals):
            maxes[key] = max(maxes.get(key, 0.0), val)
    return {key: max(val, 1e-8) / 127.0 for key, val in maxes.items()}


def mxu_bound_select(key, kernel_shape):
    """The JAX package's predicate for the TPU: only 3x3 convs with >= 64
    input channels (`kernel_shape` is (k, k, Cin, Cout)). Kept for parity;
    the port's default quantizes every conv but `stem0`."""
    kh, kw, cin, cout = kernel_shape
    return kh >= 3 and cin >= 64


def _np(t):
    return t.detach().to("cpu", torch.float32).numpy()


def quantize_params(state_dict, a_scales, skip=(), select=None):
    """Fold BN and quantize the weights of every calibrated ConvBNSiLU.

    `state_dict` is the port's float32 one. Returns {path: {w_int8,
    w_scale, bias, a_scale}} (numpy). Paths in `skip`, or rejected by
    `select(key, (k, k, Cin, Cout))`, stay float."""
    qtree = {}
    for key, a_scale in a_scales.items():
        if key in skip:
            continue
        prefix = key.replace("/", ".") + "." if key else ""
        kernel = _np(state_dict[prefix + "conv.weight"]).transpose(2, 3, 1, 0)
        if select is not None and not select(key, kernel.shape):
            continue
        b0 = state_dict.get(prefix + "conv.bias")
        b0 = (np.zeros(kernel.shape[-1], np.float32) if b0 is None
              else _np(b0))
        gamma = _np(state_dict[prefix + "bn.scale"])
        beta = _np(state_dict[prefix + "bn.bias"])
        mean = _np(state_dict[prefix + "bn.mean"])
        var = _np(state_dict[prefix + "bn.var"])

        fold = gamma / np.sqrt(var + BN_EPS)  # (O,)
        w = kernel * fold  # the BN scale folded into the conv weights
        bias = (b0 - mean) * fold + beta

        w_scale = np.maximum(np.max(np.abs(w), axis=(0, 1, 2)), 1e-12) / 127.0
        w_int8 = np.clip(np.round(w / w_scale), -127, 127).astype(np.int8)
        qtree[key] = {
            "w_int8": w_int8,
            "w_scale": np.asarray(w_scale, np.float32),
            "bias": np.asarray(bias, np.float32),
            "a_scale": np.float32(a_scale),
        }
    return qtree


class QuantConvBNSiLU(nn.Module):
    """The int8 body of one ConvBNSiLU (inference only): Q1 then Q2
    (`ops/quant.py`), in the compute dtype `dtype`. Holds the packed int8
    weights and the dequant vectors as buffers and `inv` as a Python
    float, so `torch.export` bakes them all in. `plain=True` runs the
    plain versions on any device (what the kernels are held against)."""

    def __init__(self, q, kernel, stride, dtype, device=None):
        super().__init__()
        self.k, self.stride, self.dtype = kernel, stride, dtype
        self.inv = input_inverse(q["a_scale"], dtype)
        scale, bias = dequant_vectors(q["a_scale"], q["w_scale"], q["bias"],
                                      dtype)
        self.register_buffer("w", pack_weights(q["w_int8"]).to(device))
        self.register_buffer("scale", scale.to(device))
        self.register_buffer("bias", bias.to(device))
        self.plain = False

    def forward(self, x, train: bool = False):
        if train:
            raise ValueError("a quantized conv serves only (train=False)")
        return quant_conv_silu(x, self.inv, self.w, self.scale, self.bias,
                               self.k, self.stride, plain=self.plain)


def quantized_copy(model: nn.Module, qtree) -> nn.Module:
    """A copy of `model` with every ConvBNSiLU in `qtree` swapped for its
    `QuantConvBNSiLU`; the model itself is left as it is."""
    qmodel = copy.deepcopy(model)
    for key, q in qtree.items():
        parent, _, child = key.replace("/", ".").rpartition(".")
        owner = qmodel.get_submodule(parent)
        old = getattr(owner, child)
        setattr(owner, child, QuantConvBNSiLU(
            q, old.conv.kernel_size[0], old.conv.stride[0], old.dtype,
            device=old.bn.scale.device))
    return qmodel.eval()


def set_plain(model: nn.Module, plain: bool) -> nn.Module:
    """Route every quantized conv of `model` to the plain versions (True)
    or the registered ops (False)."""
    for mod in model.modules():
        if isinstance(mod, QuantConvBNSiLU):
            mod.plain = plain
    return model


def quantize_model(model: nn.Module, calib_batches, skip=("stem0",),
                   percentile=None, select=None, state_dict=None):
    """One-call PTQ: calibrate `model` on `calib_batches`, quantize the
    float32 weights of `state_dict` (default: the model's own, which must
    then be float32), and return the swapped copy.

    Default skip: the first conv (`stem0`) stays float, standard
    first-layer practice; the per-head 1x1 `pred` convs are plain convs
    and stay float always."""
    a_scales = calibrate(model, calib_batches, percentile=percentile)
    qtree = quantize_params(
        model.state_dict() if state_dict is None else state_dict, a_scales,
        skip=skip, select=select)
    return quantized_copy(model, qtree)


def calib_batches_from_images(images, img_size, batch_size=8):
    """Letterbox image files, PIL images or HWC uint8 arrays into
    calibration batches of the serving input layout. Divides by 255.0, as
    the JAX package's does (the serving path multiplies by INV255; the two
    differ by at most an ulp)."""
    from PIL import Image

    from yolo_from_scratch_tpu_torch.data.letterbox import letterbox_image

    arrs = []
    for im in images:
        if isinstance(im, np.ndarray):
            pil = Image.fromarray(np.asarray(im, np.uint8))
        elif hasattr(im, "size"):
            pil = im.convert("RGB")
        else:
            pil = Image.open(im).convert("RGB")
        arr, _, _, _ = letterbox_image(pil, img_size)
        arrs.append(arr.astype(np.float32) / 255.0)
    return [np.stack(arrs[i:i + batch_size])
            for i in range(0, len(arrs), batch_size)]
