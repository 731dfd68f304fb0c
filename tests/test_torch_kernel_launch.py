"""The Python side of the port's TMA-fed conv backward kernels (K2,
`ops/conv_bwd.py`; K3 and K4, `benchmarks/bwdproto.py`; K5,
`benchmarks/blockbwd.py`) and the H100 bounds of `utils/roofline.py`, on
the CPU.

The kernels run only on the card; what their wrappers compute here (tile
counts, the clustered grid and the dW workspace from each kernel's exported
geometry, what a TMA tensor map can read, the weight layout the bf16
kernels read) and the bound arithmetic that `chip_smoke.py` reports are
exact, so they are held to exact values.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu_torch.benchmarks import blockbwd, bwdproto
from yolo_from_scratch_tpu_torch.ops import conv_bwd
from yolo_from_scratch_tpu_torch.utils import roofline

H100_SMS = 132
MB = 1e6
PARTIAL = 9 * 64 * 64  # one dW, 576 x 64 floats
# clusters of 4 one-block-per-SM blocks on 132 SMs: at most 33 at once
MAX_CLUSTERS = H100_SMS // 4


class _Lib:
    """Stands in for the kernel library's `<kernel>_geometry` exports, with
    the tiles, clusters and partials that `csrc/` gives each kernel."""

    GEOMETRY = {  # kernel: {bf16: (rows, columns, cluster, partial floats)}
        "conv3x3_bwd": {1: (8, 16, 4, PARTIAL), 0: (8, 8, 1, PARTIAL)},
        "conv_bwd_patch": {1: (8, 16, 4, PARTIAL), 0: (4, 8, 1, PARTIAL)},
        "conv_bwd_tap": {1: (8, 16, 4, PARTIAL), 0: (8, 8, 1, PARTIAL)},
        "chain_bwd": {1: (8, 16, 4, 2 * PARTIAL), 0: (8, 8, 1, 2 * PARTIAL)},
    }

    def __init__(self, max_clusters=MAX_CLUSTERS):
        self.max_clusters = max_clusters
        for kernel, by_type in self.GEOMETRY.items():
            setattr(self, f"{kernel}_geometry", self._export(by_type))

    def _export(self, by_type):
        def geometry(bf16, out):
            rows, cols, cluster, floats = by_type[bf16]
            out[:5] = [rows, cols, cluster, floats,
                       self.max_clusters if cluster > 1 else 0]
            return 1 if cluster > 1 and self.max_clusters < 1 else 0
        return geometry

    @staticmethod
    def conv3x3_bwd_error_string(rc):
        return b"invalid argument"


@pytest.mark.parametrize("b,h,w,tile,tiles", [
    (8, 40, 40, (8, 16), 8 * 5 * 3),
    (8, 80, 80, (8, 16), 8 * 10 * 5),
    (8, 40, 40, (8, 8), 8 * 5 * 5),
    (1, 7, 5, (8, 8), 1),
    (1, 7, 5, (4, 8), 2),
    (2, 16, 16, (8, 16), 2 * 2 * 1),
])
def test_tile_counts(b, h, w, tile, tiles):
    assert conv_bwd.tile_count(b, h, w, tile) == tiles


@pytest.mark.parametrize("kernel", sorted(_Lib.GEOMETRY))
def test_geometry_is_read_from_the_kernel(kernel):
    """The wrappers take each kernel's tile, cluster and partial size from
    its library export, and from nowhere else."""
    lib = _Lib()
    for bf16 in (0, 1):
        rows, cols, cluster, floats = _Lib.GEOMETRY[kernel][bf16]
        assert conv_bwd.geometry(lib, kernel, bf16) == conv_bwd.Geometry(
            (rows, cols), cluster, floats,
            MAX_CLUSTERS if cluster > 1 else 0)


def test_geometry_refuses_a_card_without_clusters():
    with pytest.raises(RuntimeError, match="cluster"):
        conv_bwd.geometry(_Lib(max_clusters=0), "conv3x3_bwd", 1)
    assert conv_bwd.geometry(_Lib(max_clusters=0), "conv3x3_bwd", 0).cluster == 1


@pytest.mark.parametrize("n_tiles,max_clusters,grid", [
    (400, MAX_CLUSTERS, 132),  # 80x80 B=8: every SM
    (400, 30, 120),            # a card that holds 30 clusters at once
    (120, MAX_CLUSTERS, 120),  # 40x40 B=8: one tile a block
    (4, MAX_CLUSTERS, 4),
    (1, MAX_CLUSTERS, 4),      # a whole cluster, three blocks idle
    (5, MAX_CLUSTERS, 8),
])
def test_clustered_grid(n_tiles, max_clusters, grid):
    geom = conv_bwd.Geometry((8, 16), 4, PARTIAL, max_clusters)
    got = conv_bwd.launch_grid(n_tiles, H100_SMS, geom)
    assert got == grid and got % 4 == 0
    assert conv_bwd.workspace_floats(got, geom) == grid // 4 * PARTIAL


def test_unclustered_grid_and_refusal():
    geom = conv_bwd.Geometry((8, 8), 1, PARTIAL, 0)
    assert conv_bwd.launch_grid(200, H100_SMS, geom) == 132
    assert conv_bwd.launch_grid(7, H100_SMS, geom) == 7
    assert conv_bwd.workspace_floats(132, geom) == 132 * PARTIAL
    with pytest.raises(RuntimeError, match="cluster"):
        conv_bwd.launch_grid(400, H100_SMS,
                             conv_bwd.Geometry((8, 16), 4, PARTIAL, 0))


@pytest.mark.parametrize("kernel,limit", [
    ("conv3x3_bwd", 5 * MB), ("conv_bwd_patch", 5 * MB),
    ("conv_bwd_tap", 5 * MB), ("chain_bwd", 2 * 5 * MB)])
@pytest.mark.parametrize("h", [40, 80])
def test_dw_workspace_under_5_mb(kernel, limit, h):
    """At B=8 on 132 SMs the clustered bf16 kernels write at most 33
    partials of 576 x 64 floats (4.87 MB), the chain two such dW a partial
    (9.73 MB); one partial a block would be 19.5 MB (39 MB for the
    chain)."""
    grid, floats = conv_bwd.launch_plan(_Lib(), kernel, 8, h, h, 1, H100_SMS)
    assert floats * 4 <= limit and grid <= H100_SMS
    assert PARTIAL * 4 * H100_SMS > 19 * MB


def _nhwc(b=2, h=4, w=6, dtype=torch.bfloat16):
    return torch.zeros((b, h, w, 64), dtype=dtype)


def test_tma_operand_accepts_dense_layouts():
    x = _nhwc()
    conv_bwd.check_tma_operand(x, "x", channels_last=False)
    conv_bwd.check_tma_operand(x.permute(0, 3, 1, 2), "x", channels_last=True)
    conv_bwd.check_tma_operand(_nhwc(b=1), "x", channels_last=False)


@pytest.mark.parametrize("how", ["misaligned", "channel slice", "row slice",
                                 "nchw contiguous", "transposed"])
def test_tma_operand_refusals(how):
    """What a TMA map cannot read raises; nothing is copied."""
    x = _nhwc()
    channels_last = False
    if how == "misaligned":  # base 2 bytes past a 16-byte boundary
        flat = torch.zeros(x.numel() + 8, dtype=torch.bfloat16)
        start = next(i for i in range(1, 9) if flat[i:].data_ptr() % 16)
        x = flat[start:start + x.numel()].view(x.shape)
    elif how == "channel slice":
        x = torch.zeros((2, 4, 6, 128), dtype=torch.bfloat16)[..., :64]
    elif how == "row slice":
        x = _nhwc(h=8)[:, ::2]
    elif how == "nchw contiguous":
        x, channels_last = torch.zeros((2, 64, 4, 6), dtype=torch.bfloat16), True
    elif how == "transposed":
        x = x.transpose(1, 2)
    with pytest.raises(ValueError, match="TMA|dense"):
        conv_bwd.check_tma_operand(x, "x", channels_last=channels_last)


@pytest.mark.parametrize("how", ["nchw contiguous bf16", "nchw contiguous f32",
                                 "misaligned dy", "transposed w"])
def test_k2_launch_refuses_without_copying(how):
    """K2's wrapper raises on what its kernel cannot read, before it builds
    or launches anything; the autograd backward makes the copies."""
    dt = torch.float32 if how.endswith("f32") else torch.bfloat16
    x = torch.zeros((2, 64, 4, 6), dtype=dt).to(memory_format=torch.channels_last)
    dy, w = x.clone(), torch.zeros((64, 64, 3, 3), dtype=dt)
    if how.startswith("nchw"):
        x = x.contiguous()
    elif how == "misaligned dy":
        flat = torch.zeros(dy.numel() + 8, dtype=dt)
        start = next(i for i in range(1, 9) if flat[i:].data_ptr() % 16)
        dy = flat[start:start + dy.numel()].view(2, 4, 6, 64).permute(0, 3, 1, 2)
    else:
        w = w.transpose(2, 3)
    with pytest.raises(ValueError, match="channels-last|TMA|contiguous"):
        conv_bwd._launch(x, dy, w)


def test_k3_weight_layout_gives_the_plain_backward():
    """K3's bf16 kernel reads W9T (row t*64 + ci, column co); dx as the
    kernel forms it, sum over taps of DY9_t @ W9T_t^T, is the plain
    version's dx."""
    rng = np.random.default_rng(0)
    x, dy = (torch.from_numpy(rng.standard_normal((2, 5, 7, 64))
                              .astype(np.float32)) for _ in range(2))
    w = torch.from_numpy((rng.standard_normal((3, 3, 64, 64)) * 0.05)
                         .astype(np.float32))
    w9t = bwdproto.flip9t(w, torch.float32)
    for t, (i, j) in enumerate(bwdproto.TAPS):
        torch.testing.assert_close(w9t[t * 64:(t + 1) * 64], w[2 - i, 2 - j],
                                   rtol=0, atol=0)
        torch.testing.assert_close(
            w9t[t * 64:(t + 1) * 64],
            bwdproto.flip9(w, torch.float32)[t * 64:(t + 1) * 64].T,
            rtol=0, atol=0)
    dy9 = conv_bwd._patches(dy.permute(0, 3, 1, 2))  # (B, H*W, 9C)
    dx = sum(dy9[..., t * 64:(t + 1) * 64] @ w9t[t * 64:(t + 1) * 64].T
             for t in range(9)).reshape(x.shape)
    want, _ = bwdproto.fused_bwd_patch_plain(x, dy, w)
    torch.testing.assert_close(dx, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k4_weight_layout_gives_the_plain_backward(dtype):
    """K4's wrapper hands its kernel `weight_layout(w)`: W9T in bf16 (row
    t*64 + ci, column co, the TMA-loaded wgmma operand), W9flip in float32.
    dx as the kernel forms it from that layout, nine per-tap products
    summed in float and rounded once, is the plain version's dx."""
    rng = np.random.default_rng(1)
    x, dy = (torch.from_numpy(rng.standard_normal((2, 5, 7, 64))
                              .astype(np.float32)).to(dtype) for _ in range(2))
    w = torch.from_numpy((rng.standard_normal((3, 3, 64, 64)) * 0.05)
                         .astype(np.float32)).to(dtype)
    w9 = bwdproto.weight_layout(w, dtype)
    assert w9.dtype == dtype and w9.is_contiguous() and w9.shape == (576, 64)
    blocks = [w9[t * 64:(t + 1) * 64].float() for t in range(9)]
    if dtype == torch.bfloat16:  # the kernel reads each tap block transposed
        blocks = [blk.T for blk in blocks]
    dy9 = conv_bwd._patches(dy.permute(0, 3, 1, 2)).float()
    dx = sum(dy9[..., t * 64:(t + 1) * 64] @ blocks[t] for t in range(9))
    want, _ = bwdproto.fused_bwd_tap_plain(x, dy, w)
    torch.testing.assert_close(dx.to(dtype).reshape(x.shape), want,
                               rtol=0, atol=2.0 ** -7 * want.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_weight_layout_gives_the_plain_backward(dtype):
    """K5's wrapper hands its kernel `weight_layout` of both convs. The
    chain's backward formed from those layouts as the bf16 kernel forms it
    (dz2, da1 on the one-pixel ring by per-tap products with W2T's blocks
    transposed, dz1, dx with W1T's) is the plain version's."""
    rng = np.random.default_rng(2)
    x, dy = (torch.from_numpy(rng.standard_normal((1, 6, 9, 64))
                              .astype(np.float32)).to(dtype) for _ in range(2))
    w1, w2 = (torch.from_numpy((rng.standard_normal((3, 3, 64, 64)) * 0.05)
                               .astype(np.float32)).to(dtype) for _ in range(2))
    s1, s2 = (torch.from_numpy((rng.random(64) + 0.5).astype(np.float32))
              for _ in range(2))
    z1, a1, _ = blockbwd.chain_fwd(x, w1, w2, s1, s2)

    def input_grad(g, w):
        """sum over taps of shift_t(g) @ block_t, block_t from the layout
        the kernel reads (W9T blocks transposed in bf16)."""
        w9 = bwdproto.weight_layout(w, dtype)
        g9 = conv_bwd._patches(g.permute(0, 3, 1, 2)).float()
        return sum(g9[..., t * 64:(t + 1) * 64]
                   @ (w9[t * 64:(t + 1) * 64].float().T
                      if dtype == torch.bfloat16
                      else w9[t * 64:(t + 1) * 64].float())
                   for t in range(9)).reshape(g.shape)

    dz2 = (dy.float() * s2).to(dtype)
    dz1 = (input_grad(dz2, w2) * blockbwd._silu_grad(z1.float()) * s1).to(dtype)
    dx = (input_grad(dz1, w1) + dy.float()).to(dtype)
    want = blockbwd.chain_bwd_plain(x, z1, a1, dy, w1, w2, s1, s2)[0]
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(dx, want, rtol=0,
                               atol=tol * want.float().abs().max().item())


def test_spill_check_names_every_conv_backward_kernel():
    """`chip_smoke.py` fails phase 2 on a spill in any kernel whose name
    holds one of its CONV_BWD_ENTRIES: every kernel defined in a conv
    backward source must match one, so that a renamed kernel stays
    checked."""
    import chip_smoke

    csrc = Path(bwdproto.__file__).resolve().parents[1] / "csrc"
    kernels = {src.name: re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(",
                                    src.read_text())
               for src in csrc.glob("*.cu")
               if src.name not in ("nms.cu", "int8_conv.cu")}
    assert set(kernels) == {"conv_bwd.cu", "conv_bwd_patch.cu",
                            "conv_bwd_tap.cu", "chain_bwd.cu"}
    for name, found in kernels.items():
        assert found, name
        for kernel in found:
            assert any(e in kernel for e in chip_smoke.CONV_BWD_ENTRIES), kernel


def test_spill_check_names_every_int8_kernel():
    """Phase 2 fails on a spill in a kernel whose name holds one of
    `chip_smoke.INT8_ENTRIES`: they are exactly the kernels (Q1, Q2) that
    `csrc/int8_conv.cu` defines."""
    import chip_smoke

    src = (Path(bwdproto.__file__).resolve().parents[1] / "csrc"
           / "int8_conv.cu")
    found = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(",
                       src.read_text())
    assert sorted(found) == sorted(chip_smoke.INT8_ENTRIES)


def test_spill_check_names_every_nms_kernel():
    """Phase 2 fails on a spill in a kernel whose name holds one of
    `chip_smoke.NMS_ENTRIES`, and phases 3-4 split the NMS time by the same
    names: they are exactly the kernels `csrc/nms.cu` defines."""
    import chip_smoke

    src = Path(bwdproto.__file__).resolve().parents[1] / "csrc" / "nms.cu"
    found = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(",
                       src.read_text())
    assert sorted(found) == sorted(chip_smoke.NMS_ENTRIES)


@pytest.mark.parametrize("b,h,w,dtype,us", [
    (8, 40, 40, "bfloat16", 1.91), (8, 80, 80, "bfloat16", 7.63),
    (8, 40, 40, "float32", 28.2)])
def test_conv_bwd_bound(b, h, w, dtype, us):
    """K2-K4: 4 * P * 9 * 64^2 FLOPs (P = B*H*W) against the data-sheet
    peak; compute-bound at these shapes."""
    ms, by = roofline.conv3x3_bwd_bound_ms(b, h, w, dtype)
    assert round(ms * 1e3, 2 if us < 10 else 1) == us and by == "operations"
    flops, bytes_ = roofline.conv3x3_bwd_work(b, h, w, 2)
    assert flops == 147_456 * b * h * w
    # x, dy, dx in bf16 + W9 in bf16 + dW in float32
    assert bytes_ == 3 * b * h * w * 64 * 2 + 9 * 64 * 64 * (2 + 4)


@pytest.mark.parametrize("h,us", [(40, 3.82), (80, 15.3)])
def test_chain_bwd_bound(h, us):
    ms, by = roofline.chain_bwd_bound_ms(8, h, h, "bfloat16")
    assert round(ms * 1e3, 2 if us < 10 else 1) == us and by == "operations"
    assert roofline.chain_bwd_work(8, h, h, 2)[0] == 294_912 * 8 * h * h


def test_bytes_bound_and_floor_agree():
    """A byte-heavy case is bytes-bound; the prototype benchmark's floor
    is the same bound in seconds."""
    ms, by = roofline.bound_ms(1e6, 3.35e9, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(1.0)
    assert bwdproto.roofline_floor_s(8, 40, 40, 2) == pytest.approx(
        2 * roofline.conv3x3_bwd_bound_ms(8, 40, 40, "bfloat16")[0] / 1e3)


def test_nms_iou_count():
    """Each kept pivot against every later valid candidate: pivots at 0
    and 2 of 5 boxes, the last one padding -> 3 + 1 tests."""
    keep = torch.tensor([[True, False, True, False, False]])
    valid = torch.tensor([[True, True, True, True, False]])
    assert roofline.nms_iou_count(keep, valid) == 4
    flops, bytes_ = roofline.nms_work(5, 4)
    assert flops == 4 * roofline.NMS_FLOPS_PER_IOU + 5 * roofline.NMS_FLOPS_PER_BOX
    assert bytes_ == 5 * 21


def test_nms_mask_pass_tests():
    """The mask pass tests each valid rank against every later rank, valid
    or not: ranks 0, 1 and 3 of 5 valid -> 4 + 3 + 1 tests, against the
    walk's 2 + 0 when ranks 0 and 3 are kept."""
    valid = torch.tensor([[True, True, False, True, False]])
    keep = torch.tensor([[True, False, False, True, False]])
    assert roofline.nms_mask_pass_tests(valid) == 8
    assert roofline.nms_iou_count(keep, valid) == 2
    assert roofline.nms_mask_pass_tests(torch.ones((2, 4096), dtype=torch.bool)) \
        == 2 * 4096 * 4095 // 2
