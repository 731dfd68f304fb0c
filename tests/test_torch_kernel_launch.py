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
from yolo_from_scratch_tpu_torch.ops import conv_bwd, quant
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
               if src.name not in ("nms.cu", "int8_conv.cu", "letterbox.cu")}
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


def test_spill_check_names_every_letterbox_kernel():
    """Phase 2 fails on a spill in a kernel whose name holds one of
    `chip_smoke.LETTERBOX_ENTRIES`, and phase 28 times L1 by the same
    names: they are exactly the kernels `csrc/letterbox.cu` defines."""
    import chip_smoke

    src = (Path(bwdproto.__file__).resolve().parents[1] / "csrc"
           / "letterbox.cu")
    found = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(",
                       src.read_text())
    assert sorted(found) == sorted(chip_smoke.LETTERBOX_ENTRIES)


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


# ------------------------------------------------------------------ Q2

INT8_SRC = Path(bwdproto.__file__).resolve().parents[1] / "csrc" / "int8_conv.cu"


class _Q2Lib:
    """Stands in for the kernel library's `int8_conv_geometry`: the rule of
    `q2_geometry` in `csrc/int8_conv.cu`, transcribed, with the constants
    that `test_q2_geometry_constants_are_the_kernels` reads from the
    source."""

    kSmemLimit, kSmemTwo, kResidentMax = 232448, 115712, 98304
    kMinStages, kMaxStages, kBoxMax = 3, 8, 256
    kFixed = 8 * (16 * 144 + 16 * 4) + (4 * 8 + 2) * 8 + 16 * 4 + 1024

    @staticmethod
    def _align1k(v):
        return (v + 1023) & ~1023

    def _choose_tile(self, ho, wo, k, s, mt):
        best = None
        for tw in range(1, min(wo, mt) + 1):
            if (tw - 1) * s + k > self.kBoxMax:
                break
            th = min(mt // tw, ho)
            while (th - 1) * s + k > self.kBoxMax:
                th -= 1
            tiles = -(-ho // th) * -(-wo // tw)
            halo = tiles * ((th - 1) * s + k) * ((tw - 1) * s + k)
            if best is None or (tiles, halo) <= best[:2]:
                best = (tiles, halo, th, tw)
        return best[2], best[3]

    def int8_conv_geometry(self, b, h, w, cp, n, k, s, sms, out):
        if min(b, h, w, n, s, sms, cp) <= 0 or k not in (1, 2, 3) or cp % 16:
            return 1001
        taps = k * k
        ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
        nt = 16
        while nt < n and nt < 256:
            nt *= 2
        n_tiles = -(-n // nt)
        th, tw = self._choose_tile(ho, wo, k, s, 64)
        tiles_y, tiles_x = -(-ho // th), -(-wo // tw)
        halo_h, halo_w = (th - 1) * s + k, (tw - 1) * s + k
        work = b * tiles_y * tiles_x * n_tiles
        if work >= 1 << 22:
            return 1003
        split = int(nt == 256 or work < 2 * sms)
        pipes = 1 if split else 2
        vecs = self._align1k(n_tiles * nt * 8)
        for pas in range(4):
            budget = self.kSmemLimit if pas & 1 else self.kSmemTwo
            for chunk in (128, 64, 32) if pas < 2 else (16,):
                if cp % chunk:
                    continue
                wchunk = self._align1k(
                    (taps + (chunk == 16 and taps & 1)) * nt * chunk)
                all_w = cp // chunk * wchunk
                resident = all_w if n_tiles == 1 and all_w <= self.kResidentMax else 0
                stage = self._align1k(halo_h * halo_w * chunk) + (0 if resident else wchunk)
                room = (budget - self.kFixed - vecs - resident) // pipes
                if self.kMinStages * stage > room:
                    continue
                stages = min(self.kMaxStages, room // stage)
                smem = self.kFixed + vecs + resident + pipes * stages * stage
                per_sm = min(4, 233472 // (smem + 1024))
                grid = min(-(-work // pipes), sms * per_sm)
                out[:19] = [nt, split, th, tw, chunk, stages, smem, grid, work,
                            halo_h, halo_w, n_tiles, tiles_y, tiles_x, stage,
                            self._align1k(halo_h * halo_w * chunk), resident,
                            wchunk, vecs]
                return 0
        return 1003

    @staticmethod
    def int8_conv_error_string(rc):
        return b"int8 conv geometry"


def _int8_model_shapes():
    import chip_smoke
    from yolo_from_scratch_tpu_torch import YoloConfig

    cfg = YoloConfig.from_size("s", num_classes=80, img_size=640,
                               compute_dtype="bfloat16")
    shapes = set(chip_smoke._int8_shapes(cfg)[0])
    shapes |= set(chip_smoke._int8_shapes(cfg.with_(head_type="anchor_free"))[0])
    return sorted(shapes)


def test_q2_geometry_constants_are_the_kernels():
    """The fake's constants are `csrc/int8_conv.cu`'s, so the geometry
    tests below hold the kernel's own rule."""
    text = INT8_SRC.read_text()
    consts = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;?]+);", text):
        try:  # the namespace's integer constants, not a template's
            consts[name] = eval(expr.replace("/", "//"), {}, dict(consts))
        except (NameError, SyntaxError):
            pass
    for name in ("kSmemLimit", "kSmemTwo", "kResidentMax", "kMinStages",
                 "kMaxStages", "kBoxMax", "kFixed"):
        assert consts[name] == getattr(_Q2Lib, name), name
    # two consumer warpgroups and a producer warp
    assert consts["kWarps"] == 8 and consts["kThreads"] == 288


@pytest.mark.parametrize("b", [1, 32])
def test_q2_geometry_at_every_model_shape(b):
    """At every quantized conv of both heads ('s' @640), B=1 and B=32, on
    132 SMs: N is cout (all are 16-256), at most 227 KB of shared memory,
    three stages or more a ring, tiles of at most 64 pixels whose halos
    fit a TMA box and that cover the output, a grid no larger than the
    work that fills the card at B=32."""
    shapes = _int8_model_shapes()
    assert len(shapes) == 24
    lib = _Q2Lib()
    for k, s, cin, cout, h, w in shapes:
        g = quant.conv_geometry(lib, b, h, w, quant.padded_channels(cin), cout,
                                k, s, H100_SMS)
        ho, wo = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
        assert g.nt == cout and g.n_tiles == 1, (k, s, cin, cout)
        assert g.smem <= 232448 and g.stages >= 3
        assert g.tile_h * g.tile_w <= 64 and max(g.halo_h, g.halo_w) <= 256
        assert g.tiles_y * g.tile_h >= ho and g.tiles_x * g.tile_w >= wo
        assert (g.tiles_y - 1) * g.tile_h < ho and (g.tiles_x - 1) * g.tile_w < wo
        assert g.work == b * g.tiles_y * g.tiles_x
        assert 1 <= g.grid <= g.work and g.grid * (1 if g.split else 2) >= min(
            g.work, H100_SMS)
        if b == 32:
            assert g.grid >= H100_SMS
        assert g.split == (cout == 256 or g.work < 2 * H100_SMS)
        assert Q2_CHUNKS[g.chunk] and quant.padded_channels(cin) % g.chunk == 0
        assert g.resident in (0, quant.padded_channels(cin) // g.chunk * g.chunk_wbytes)
        assert g.resident <= 98304 and g.vec_bytes == -(-cout * 8 // 1024) * 1024


Q2_CHUNKS = {16: True, 32: True, 64: True, 128: True}


@pytest.mark.parametrize("cout,nt,n_tiles", [
    (8, 16, 1), (16, 16, 1), (17, 32, 1), (48, 64, 1), (80, 128, 1),
    (255, 256, 1), (256, 256, 1), (300, 256, 2), (1024, 256, 4)])
def test_q2_geometry_n_rule(cout, nt, n_tiles):
    """N is cout rounded up to 16, 32, 64, 128 or 256, 256-wide tiles past
    that; weights stay resident only for one N tile within 96 KB."""
    g = quant.conv_geometry(_Q2Lib(), 2, 20, 20, 64, cout, 3, 1, H100_SMS)
    assert (g.nt, g.n_tiles) == (nt, n_tiles)
    assert g.work == 2 * g.tiles_y * g.tiles_x * n_tiles
    assert g.resident == (g.chunk_wbytes * 64 // g.chunk
                          if n_tiles == 1 and g.chunk_wbytes * 64 // g.chunk <= 98304
                          else 0)


def test_q2_geometry_refuses():
    """Shapes Q2 does not take come back as an error, which the reader
    raises."""
    with pytest.raises(RuntimeError, match="geometry"):
        quant.conv_geometry(_Q2Lib(), 1, 20, 20, 64, 64, 5, 1, H100_SMS)
    with pytest.raises(RuntimeError, match="geometry"):
        quant.conv_geometry(_Q2Lib(), 1, 20, 20, 24, 64, 3, 1, H100_SMS)
    # 2^22 work items and more: past the kernel's cheap division's range
    with pytest.raises(RuntimeError, match="geometry"):
        quant.conv_geometry(_Q2Lib(), 1 << 16, 64, 64, 32, 32, 1, 1, H100_SMS)


@pytest.mark.parametrize("b", [1, 2, 32])
def test_chip_smoke_q2_geometry_check_passes(b):
    """`chip_smoke.py` phase 20 (a) holds the library's geometry to N, shared
    memory, stages and cover at every model shape and its odd shapes; the
    rule passes its own check at each batch."""
    import chip_smoke

    lib = _Q2Lib()
    for k, s, cin, cout, h, w in (*_int8_model_shapes(),
                                  *chip_smoke.INT8_ODD_SHAPES):
        g = chip_smoke._q2_geometry(lib, b, k, s, cin, cout, h, w, H100_SMS)
        assert g.nt * g.n_tiles >= cout


@pytest.mark.parametrize("shape,want", [
    # (k, s, cin, cout, h, w) at B=32 on 132 SMs -> (N, split, tile, chunk,
    # stages, shared memory, grid) as the library gave them on the card
    ((3, 2, 16, 32, 320, 320), (32, 0, (8, 8), 16, 8, 108368, 264)),
    ((1, 1, 32, 16, 160, 160), (16, 0, (2, 32), 32, 8, 55120, 528)),
    ((3, 2, 32, 64, 160, 160), (64, 0, (8, 8), 32, 3, 101200, 264)),
    ((1, 1, 64, 64, 80, 80), (64, 0, (4, 16), 64, 8, 90960, 264)),
])
def test_q2_geometry_matches_the_library(shape, want):
    k, s, cin, cout, h, w = shape
    g = quant.conv_geometry(_Q2Lib(), 32, h, w, cin, cout, k, s, H100_SMS)
    assert (g.nt, g.split, (g.tile_h, g.tile_w), g.chunk, g.stages, g.smem,
            g.grid) == want


@pytest.mark.parametrize("b,shape,want", [
    # the packed 2x2 convs padded (1, 0) at 's' @640 (k 2, s 1; cin, cout
    # packed, h, w) -> (N, split, tile, chunk, stages, grid) as the library
    # gave them on the card (NVIDIA H100 80GB HBM3, `chip_smoke.py` phase
    # 27 (a))
    (32, (64, 32, 160, 160), (32, 0, (8, 8), 64, 7, 264)),
    (32, (128, 64, 80, 80), (64, 0, (8, 8), 64, 5, 264)),
    (32, (256, 64, 40, 40), (64, 0, (8, 8), 32, 4, 264)),
    (32, (256, 128, 40, 40), (128, 0, (8, 8), 32, 5, 132)),
    (1, (64, 32, 160, 160), (32, 0, (8, 8), 64, 7, 200)),
    (1, (128, 64, 80, 80), (64, 1, (8, 8), 128, 5, 100)),
    (1, (256, 64, 40, 40), (64, 1, (8, 8), 64, 4, 25)),
    (1, (256, 128, 40, 40), (128, 1, (8, 8), 32, 4, 25)),
])
def test_q2_geometry_at_the_packed_2x2_shapes(b, shape, want):
    """Q2 reads a packed 2x2 conv as its 4 taps: the halo is (tile - 1) +
    2 pixels a side, the output as large as the input (the low pad 1, no
    high pad), and the rule picks what the library picked on the card."""
    cin, cout, h, w = shape
    g = quant.conv_geometry(_Q2Lib(), b, h, w, cin, cout, 2, 1, H100_SMS)
    assert (g.nt, g.split, (g.tile_h, g.tile_w), g.chunk, g.stages,
            g.grid) == want
    assert (g.halo_h, g.halo_w) == (g.tile_h + 1, g.tile_w + 1)
    assert g.tiles_y * g.tile_h >= h and g.tiles_x * g.tile_w >= w
    assert g.chunk_wbytes == -(-4 * g.nt * g.chunk // 1024) * 1024


def test_chip_smoke_finds_the_packed_2x2_shapes():
    """`chip_smoke.py` phase 27 (a)'s shapes, from a forward of each
    packed layout on the meta device: stem1 under stem, bb_p3_down under
    interior, bb_p4_down and downsample_p3_to_p4 under p3, all 2x2 at
    stride 1 padded (1, 0)."""
    import chip_smoke

    shapes = chip_smoke._packed_q2_shapes()
    assert len(shapes) == chip_smoke.PC_Q2_SHAPES
    assert {key[3:]: tuple(v) for key, v in shapes.items()} == {
        (64, 32, 160, 160): ("stem",), (128, 64, 80, 80): ("interior",),
        (256, 128, 40, 40): ("p3",), (256, 64, 40, 40): ("p3",)}
    assert {key[:3] for key in shapes} == {(2, 1, 1)}
