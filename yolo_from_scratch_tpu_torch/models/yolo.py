"""YOLOv5-style FPN detector (counterpart of
`yolo_from_scratch_tpu/models/yolo.py`).

stem (2 stride-2 convs) -> backbone P3/P4/P5 -> SPPF -> FPN top-down with
laterals -> PANet bottom-up -> three heads (2 ConvBNSiLU + 1x1 conv with
bias, or with `head_type="anchor_free"` the decoupled DFL head of
`models/anchor_free.py`). The public layouts are the JAX package's: images
in NHWC (B, S, S, 3), head outputs (B, H, W, A, 5+nc) in float32, or
(B, H, W, 4*REG_MAX + nc) for the anchor-free head. Inside, tensors are
NCHW (the NHWC input permuted, which is channels-last in memory).

Parameters are float32 master weights, cast to the compute dtype at use
(`models/blocks.py`); `reset_parameters(generator)` draws them from the JAX
package's initial distributions.

The space-to-depth packed layouts (`cfg.packed_stem`, `packed_interior`,
`packed_p3`; `models/packed.py`) run the same math on packed maps with the
same parameters: the stem on the 4x-packed image, (B, S/4, S/4, 48) NHWC
from the host (a (B, S, S, 3) image is packed on the device), then with
`packed_interior` the 160x160 stage 2x2-packed, and with `packed_p3` the
80x80 stage too, whose FPN upsample is a channel tile and whose head input
is unpacked once. Under a row-block mesh (`--spatial`) or a model mesh the
packed layouts are not ported; the CLI refuses them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from yolo_from_scratch_tpu_torch.config import (
    NUM_ANCHORS_PER_SCALE,
    STRIDES,
    YoloConfig,
)
from yolo_from_scratch_tpu_torch.models.anchor_free import (
    DecoupledHead,
    v8_cls_prior,
)
from yolo_from_scratch_tpu_torch.models.blocks import (
    C3,
    SPPF,
    ConvBNSiLU,
    pred_conv,
    uniform_fan_in_,
    upsample_nearest_2x,
)
from yolo_from_scratch_tpu_torch.models.packed import (
    PACK_FACTOR,
    GPackedConvBNSiLU,
    PackedC3,
    PackedConvBNSiLU,
    pack_s2d,
    unpack_nchw,
)
from yolo_from_scratch_tpu_torch.parallel.mesh import (
    level_blocks,
    row_grid,
    spatial_mesh,
)

HEAD_PRIOR = 0.01  # objectness prior of a fresh head: bias -log((1-p)/p)


def compute_dtype(cfg: YoloConfig) -> torch.dtype:
    """The torch dtype of `cfg.compute_dtype` ('float32' or 'bfloat16')."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if cfg.compute_dtype not in dtypes:
        raise ValueError(f"unsupported compute_dtype {cfg.compute_dtype!r}")
    return dtypes[cfg.compute_dtype]


def head_bias_init(num_anchors: int, num_classes: int) -> np.ndarray:
    """A fresh head's pred bias, (A * (5+nc),) float32: 0 except
    -log((1-p)/p) on each anchor's objectness channel (`_head_bias_init`)."""
    bias = np.zeros((num_anchors, 5 + num_classes), np.float32)
    bias[:, 4] = -math.log((1.0 - HEAD_PRIOR) / HEAD_PRIOR)
    return bias.reshape(-1)


def ensure_detection_biases(params, cfg: YoloConfig, log=print):
    """Repair a JAX-layout params tree whose detection-head pred bias is
    missing or None, as the JAX loader does: anchor heads only, the bias
    rebuilt by `head_bias_init` with the same warning. Returns `params`,
    repaired in place."""
    if cfg.head_type != "anchor":
        return params
    for head in ("head_p3", "head_p4", "head_p5"):
        pred = params.get(head, {}).get("pred")
        if pred is not None and pred.get("bias") is None:
            pred["bias"] = head_bias_init(NUM_ANCHORS_PER_SCALE,
                                          cfg.num_classes)
            log("Warning: Detection head bias was None, created new bias "
                "parameter")
    return params


class DetectHead(nn.Module):
    """2x ConvBNSiLU(3x3) + 1x1 conv(bias) -> (B, H, W, A, 5+nc)."""

    def __init__(self, channels, num_anchors, num_classes, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype or torch.float32
        self.num_anchors = num_anchors
        self.num_classes = num_classes
        self.conv1 = ConvBNSiLU(channels, channels, 3, **kw)
        self.conv2 = ConvBNSiLU(channels, channels, 3, **kw)
        self.pred = nn.Conv2d(channels, num_anchors * (5 + num_classes), 1,
                              bias=True, dtype=torch.float32, device=device)

    def reset_parameters(self, generator):
        """The pred conv as the JAX `DetectHead` sets it: bias 0 except
        -log(99) on each anchor's objectness channel (`_head_bias_init`).
        conv1 and conv2 reset themselves."""
        uniform_fan_in_(self.pred.weight, self.pred.in_channels, generator)
        bias = head_bias_init(self.num_anchors, self.num_classes)
        with torch.no_grad():
            self.pred.bias.copy_(torch.from_numpy(bias))

    def forward(self, x, train: bool = False):
        x = self.conv2(self.conv1(x, train), train)
        x = pred_conv(self.pred, x, self.dtype)
        b, _, h, w = x.shape
        # channel c = a * (5+nc) + k, as the JAX head's NHWC reshape
        return x.permute(0, 2, 3, 1).reshape(b, h, w, self.num_anchors,
                                             5 + self.num_classes)


class YOLO(nn.Module):
    """Full detector. `forward(images NHWC in [0,1]) -> [p3, p4, p5]`."""

    def __init__(self, cfg: YoloConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg)
        kw = dict(dtype=dt, device=device)
        cs, c3, c4, c5 = cfg.c_stem, cfg.c_p3, cfg.c_p4, cfg.c_p5
        r1, r2 = cfg.repeats(1), cfg.repeats(2)
        stem, interior = cfg.packed_stem, cfg.packed_interior
        p3 = cfg.packed_p3

        def g(cin, cout, k, s, fo=2, bias=False):  # a conv on a 2-packed map
            return GPackedConvBNSiLU(cin, cout, k, s, 2, fo, use_bias=bias,
                                     **kw)

        # backbone; the packed modules keep the unpacked ones' names,
        # parameters and registration order
        if stem:
            self.stem0 = PackedConvBNSiLU(3, cs // 2, PACK_FACTOR, **kw)
            self.stem1 = (g(cs // 2, cs, 3, 2, bias=True) if interior else
                          PackedConvBNSiLU(cs // 2, cs, 2, **kw))
        else:
            self.stem0 = ConvBNSiLU(3, cs // 2, 3, 2, use_bias=True, **kw)
            self.stem1 = ConvBNSiLU(cs // 2, cs, 3, 2, use_bias=True, **kw)
        if interior:
            self.bb_p3_c3a = PackedC3(cs, cs, r1, **kw)
            self.bb_p3_down = g(cs, c3, 3, 2, 2 if p3 else 1, bias=True)
        else:
            self.bb_p3_c3a = C3(cs, cs, r1, **kw)
            self.bb_p3_down = ConvBNSiLU(cs, c3, 3, 2, use_bias=True, **kw)
        if p3:
            self.bb_p3_c3b = PackedC3(c3, c3, r2, **kw)
            self.bb_p4_down = g(c3, c4, 3, 2, 1, bias=True)
        else:
            self.bb_p3_c3b = C3(c3, c3, r2, **kw)
            self.bb_p4_down = ConvBNSiLU(c3, c4, 3, 2, use_bias=True, **kw)
        self.bb_p4_c3 = C3(c4, c4, r2, **kw)
        self.bb_p5_down = ConvBNSiLU(c4, c5, 3, 2, use_bias=True, **kw)
        self.bb_p5_c3 = C3(c5, c5, r1, **kw)
        self.sppf = SPPF(c5, c5, **kw)
        # FPN top-down
        self.lateral_p4 = ConvBNSiLU(c4, c4, 1, **kw)
        self.lateral_p3 = (g(c3, c3, 1, 1) if p3 else
                           ConvBNSiLU(c3, c3, 1, **kw))
        self.reduce_p5_for_p4 = ConvBNSiLU(c5, c4, 1, **kw)
        self.merge_p4 = C3(2 * c4, c4, r1, **kw)
        self.reduce_p4_for_p3 = ConvBNSiLU(c4, c3, 1, **kw)
        self.merge_p3 = (PackedC3(2 * c3, c3, r1,
                                  in_segments=((2, c3), (2, c3)), **kw)
                         if p3 else C3(2 * c3, c3, r1, **kw))
        # PANet bottom-up
        self.downsample_p3_to_p4 = (g(c3, c3, 3, 2, 1) if p3 else
                                    ConvBNSiLU(c3, c3, 3, 2, **kw))
        self.panet_merge_p4 = C3(c3 + c4, c4, r1, **kw)
        self.downsample_p4_to_p5 = ConvBNSiLU(c4, c4, 3, 2, **kw)
        self.panet_merge_p5 = C3(c4 + c5, c5, r1, **kw)
        # heads, fed from p3_fpn, p4_panet and p5_panet
        na, nc = cfg.num_anchors, cfg.num_classes
        for name, c, stride in zip(("head_p3", "head_p4", "head_p5"),
                                   (c3, c4, c5), STRIDES):
            if cfg.head_type == "anchor_free":
                # the v8 class prior of each scale (see DecoupledHead)
                head = DecoupledHead(c, nc, v8_cls_prior(nc, cfg.img_size,
                                                         stride), **kw)
            else:
                head = DetectHead(c, na, nc, **kw)
            self.add_module(name, head)

    def reset_parameters(self, generator: torch.Generator):
        """Fresh weights from the JAX package's initial distributions, drawn
        on the CPU from `generator` in module order: every conv kernel and
        bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), BatchNorm scale 1, bias 0,
        mean 0, var 1, the heads' pred biases as `DetectHead` or
        `DecoupledHead` sets them."""
        for module in self.modules():
            if isinstance(module, (ConvBNSiLU, DetectHead, DecoupledHead)):
                module.reset_parameters(generator)
        return self

    def forward(self, x, train: bool = False):
        """Head outputs for NHWC x at any multiple of 32 (the multi-scale
        trainer's buckets share one model); their grids must be the
        input's size / stride. Under `cfg.packed_stem` x is the
        4x-packed image (B, S/4, S/4, 48), or a (B, S, S, 3) one, packed
        here. On a row block (`--spatial N`, inside `data_parallel` with
        a 2-D mesh) x holds this rank's block of the image's rows, and
        each grid its block of the grid's rows (`parallel/mesh.py::
        level_blocks`: size / N and gs / N where the blocks are
        equal)."""
        cfg = self.cfg
        mesh = spatial_mesh()
        if mesh is not None and cfg.packed_stem:
            raise ValueError("the packed layouts on a row block (--spatial) "
                             "are not ported")
        n_space = mesh.n_space if mesh is not None else 1
        x = x.to(compute_dtype(cfg))
        if cfg.packed_stem and x.shape[-1] == 3:
            x = pack_s2d(x, PACK_FACTOR)  # a pixel image, packed here
        size = x.shape[2] * (PACK_FACTOR if cfg.packed_stem else 1)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW

        x = self.stem1(self.stem0(x, train), train)
        x = self.bb_p3_down(self.bb_p3_c3a(x, train), train)
        p3_backbone = self.bb_p3_c3b(x, train)
        x = self.bb_p4_down(p3_backbone, train)
        p4_backbone = self.bb_p4_c3(x, train)
        x = self.bb_p5_down(p4_backbone, train)
        p5_backbone = self.sppf(self.bb_p5_c3(x, train), train)

        p4_lateral = self.lateral_p4(p4_backbone, train)
        p3_lateral = self.lateral_p3(p3_backbone, train)
        p5_red = self.reduce_p5_for_p4(p5_backbone, train)
        p4_fpn = self.merge_p4(
            torch.cat([upsample_nearest_2x(p5_red), p4_lateral], dim=1), train)
        p4_red = self.reduce_p4_for_p3(p4_fpn, train)
        if cfg.packed_p3:
            # the 2x nearest upsample in the 2x2-packed layout: every phase
            # of a packed cell reads the same source cell, a channel tile
            up = torch.cat([p4_red] * 4, dim=1)
            p3_fpn = self.merge_p3(torch.cat([up, p3_lateral], dim=1), train)
            p3_head_in = unpack_nchw(p3_fpn, 2)
        else:
            p3_fpn = p3_head_in = self.merge_p3(
                torch.cat([upsample_nearest_2x(p4_red), p3_lateral], dim=1),
                train)

        p3_down = self.downsample_p3_to_p4(p3_fpn, train)
        p4_panet = self.panet_merge_p4(torch.cat([p3_down, p4_fpn], dim=1),
                                       train)
        p4_down = self.downsample_p4_to_p5(p4_panet, train)
        # the P5 PANet merge concatenates with the post-SPPF backbone P5,
        # not an FPN P5 (as the reference does)
        p5_panet = self.panet_merge_p5(
            torch.cat([p4_down, p5_backbone], dim=1), train)

        outs = [self.head_p3(p3_head_in, train), self.head_p4(p4_panet, train),
                self.head_p5(p5_panet, train)]
        for out, stride in zip(outs, STRIDES):
            gs = size // stride
            rows = (gs if mesh is None else level_blocks(
                gs, n_space, row_grid())[mesh.space_index])
            if out.shape[1:3] != (rows, gs):
                raise ValueError(f"head grid {tuple(out.shape[1:3])} != "
                                 f"({rows}, {gs}) for an input of "
                                 f"{size} over space={n_space}")
        # heads return float32 so decode runs in full precision even when
        # the convs compute in bfloat16
        return [out.float() for out in outs]


def cast_convs_(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every conv's weight and bias to `dtype` in place, so the
    forward's cast to the compute dtype is a no-op (serving: one cast at
    load instead of one per request). BatchNorm stays float32."""
    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            module.to(dtype)
    return model


def count_params(model: nn.Module) -> int:
    """Trainable parameters (the JAX package's 'params' collection; BN
    statistics are buffers, as they are 'batch_stats' there)."""
    return sum(p.numel() for p in model.parameters())
