"""The port's tooling against the JAX package's, on the CPU: the model
level of `utils/roofline.py` (`forward_conv_costs`, `summarize`,
`param_bytes`) and `utils/metrics_log.py::profiler_trace`.

The conv walk is held to JAX's jaxpr walk conv for conv at `YoloConfig(
num_classes=1, img_size=128, width_mult=0.25)`, batch 1 and 2, float32 and
bf16: the same count and order, the output (NCHW against NHWC) and kernel
(OIHW against HWIO) shapes up to layout, the input shape, strides and
padding, and FLOPs and bytes exactly. The non-conv bytes differ by design:
JAX's walk counts `concatenate` only, because its graph computes the SPPF
max pools as `max` over `slice`s of a `pad` and the upsample as
`broadcast_in_dim` + `reshape`, primitives its walk does not count; the
port counts the concats (equal to JAX's) plus its `max_pool2d` and
`interpolate` calls, whose bytes the test asserts as the difference.
"""

import json

import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu.config import YoloConfig as JaxConfig
from yolo_from_scratch_tpu.utils import roofline as jax_roofline
from yolo_from_scratch_tpu_torch.config import YoloConfig
from yolo_from_scratch_tpu_torch.utils import roofline
from yolo_from_scratch_tpu_torch.utils.metrics_log import profiler_trace

CFG = dict(num_classes=1, img_size=128, width_mult=0.25)


def _itemsize(dtype):
    return 2 if dtype == "bfloat16" else 4


def _pool_upsample_bytes(cfg, batch):
    """The port's max pools (SPPF: three 5x5 over the P5 map of half its
    input's channels) and upsamples (two, P5 -> P4 and P4 -> P3), read +
    write of each output, from the model's own shapes."""
    from yolo_from_scratch_tpu_torch.models.yolo import YOLO

    model = YOLO(cfg, device="meta")
    p5 = cfg.img_size // 32
    pool = batch * model.sppf.conv1.conv.out_channels * p5 * p5
    up = batch * (model.reduce_p5_for_p4.conv.out_channels * (2 * p5) ** 2
                  + model.reduce_p4_for_p3.conv.out_channels * (4 * p5) ** 2)
    return 2.0 * (3 * pool + up) * _itemsize(cfg.compute_dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 2])
def test_forward_conv_costs_equal_jax(batch, dtype):
    cfg = YoloConfig(**CFG, compute_dtype=dtype)
    got, other = roofline.forward_conv_costs(cfg, batch)
    want, jax_other = jax_roofline.forward_conv_costs(
        JaxConfig(**CFG, compute_dtype=dtype), batch)
    assert len(got) == len(want) > 30
    for i, (g, w) in enumerate(zip(got, want)):
        n, c, h, wd = g.out_shape
        assert (n, h, wd, c) == w.out_shape, i
        o, ci, kh, kw = g.kernel_shape
        assert (kh, kw, ci, o) == w.kernel_shape, i
        n, c, h, wd = g.lhs_shape
        assert (n, h, wd, c) == w.lhs_shape, i
        assert g.strides == w.strides and g.padding == w.padding, i
        assert g.flops == w.flops and g.bytes_io == w.bytes_io, i
        assert g.dtype == w.dtype == dtype
    assert other - jax_other == _pool_upsample_bytes(cfg, batch)


def test_summarize_identities():
    """`tests/test_tools.py`'s checks with the H100's peak for the dtype."""
    cfg = YoloConfig(**CFG, compute_dtype="bfloat16")
    convs, other_bytes = roofline.forward_conv_costs(cfg, batch=2)
    assert all(c.flops > 0 and c.bytes_io > 0 for c in convs)
    assert other_bytes > 0
    s = roofline.summarize(cfg, batch=2, measured_img_s=100.0)
    peak = roofline.H100_PEAK_FLOPS["bfloat16"]
    assert s["peak_flops"] == peak
    assert s["fwd_t_min_ms"] >= s["fwd_flops"] / peak * 1e3 - 1e-9
    assert s["train_flops"] == 3.0 * s["fwd_flops"]
    assert s["train_t_min_ms"] == pytest.approx(3.0 * s["fwd_t_min_ms"])
    assert s["roofline_img_s"] == pytest.approx(2 / (s["train_t_min_ms"]
                                                     / 1e3))
    assert s["mfu"] == pytest.approx(s["train_flops"] * 100.0 / 2 / peak)
    assert s["roofline_frac"] == pytest.approx(
        s["train_t_min_ms"] / 1e3 / (2 / 100.0))
    assert 0 < s["mfu"] < 1
    assert "mfu" not in roofline.summarize(cfg, batch=2)
    f32 = roofline.summarize(cfg.with_(compute_dtype="float32"), batch=2)
    assert f32["peak_flops"] == roofline.H100_PEAK_FLOPS["float32"]
    assert f32["fwd_flops"] == s["fwd_flops"]
    table = roofline.markdown_table(cfg, batch=2, measured_img_s=100.0)
    assert "MFU" in table and table.count("\n| (") == len(convs)


def test_stem_flops_are_analytic():
    """The first conv is the stem: 3x3 stride 2 on RGB."""
    convs, _ = roofline.forward_conv_costs(YoloConfig(**CFG), batch=1)
    stem = convs[0]
    assert stem.kernel_shape[1:] == (3, 3, 3) and stem.strides == (2, 2)
    assert stem.flops == 2.0 * int(np.prod(stem.out_shape)) * 9 * 3


@pytest.mark.parametrize("kw", [{}, dict(head_type="anchor_free"),
                                dict(width_mult=0.5, depth_mult=0.33)])
def test_param_bytes_equal_jax(kw):
    cfg = dict(CFG, **kw)
    assert roofline.param_bytes(YoloConfig(**cfg)) == \
        jax_roofline.param_bytes(JaxConfig(**cfg))


def test_gated_convs_are_counted(monkeypatch):
    """With the fused conv backward on, the convs its gate takes run
    `conv3x3_same`: the walk counts them as before."""
    cfg = YoloConfig(**CFG, compute_dtype="bfloat16")
    plain = roofline.forward_conv_costs(cfg, 2)
    monkeypatch.setenv("YOLO_FUSED_CONV_BWD", "1")
    assert roofline.forward_conv_costs(cfg, 2) == plain


def test_profiler_trace_writes_a_trace(tmp_path):
    with profiler_trace(tmp_path / "trace") as prof:
        torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8),
                                   torch.ones(4, 3, 3, 3)).sum()
    assert prof is not None
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert any("conv" in n for n in names)


def test_profiler_trace_without_a_directory_is_a_no_op(tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiler_trace() as prof:
        torch.ones(3).sum()
    assert prof is None
    assert not list(tmp_path.iterdir())
