"""Model / training configuration: the port's own copy of what it uses of
`yolo_from_scratch_tpu/config.py`, with the same names and values bit for
bit (`tests/test_torch_config_data.py` holds the two together), but for
`auto_fast_layout`, whose packed layout the port leaves off. It loads only
numpy.

Mirrors the reference's hyperparameter surface (reference: train.py:336-397,
1346-1352) while adding TPU-specific knobs (compute dtype, NMS capacity).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

# Default COCO anchors, pixels at 640 (reference: train.py:372-374).
DEFAULT_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),       # P3 — small objects
    ((30, 61), (62, 45), (59, 119)),      # P4 — medium objects
    ((116, 90), (156, 198), (373, 326)),  # P5 — large objects
)

# Size variants (reference: train.py:1346-1352).
YOLO_SIZES = {
    "n": {"width_mult": 0.25, "depth_mult": 0.33},
    "s": {"width_mult": 0.50, "depth_mult": 0.33},  # default
    "m": {"width_mult": 0.75, "depth_mult": 0.67},
    "l": {"width_mult": 1.00, "depth_mult": 1.00},
    "x": {"width_mult": 1.25, "depth_mult": 1.33},
}

STRIDES = (8, 16, 32)
NUM_ANCHORS_PER_SCALE = 3

# Image-normalization constant shared by the host loader and the in-step
# uint8 normalize. Both sides multiply by this SAME f32 reciprocal, which
# makes staged-uint8 and host-normalized-f32 inputs bit-identical: an f32
# multiply is correctly rounded in both numpy and XLA, whereas a
# divide-by-constant is strength-reduced by XLA to a reciprocal-multiply
# that lands ~1 ulp off numpy's true divide (measured 5.96e-8 max diff,
# amplified to ~5e-5 loss divergence over a few Adam steps).
INV255 = np.float32(1.0 / 255.0)


def auto_fast_layout(platform: str) -> dict:
    """The port's no-flags dtype and layout for a device type ('cuda' or
    'cpu'), the counterpart of the JAX package's `auto_fast_layout`:
    bfloat16 convs on the card, float32 on the CPU, and no packed layout
    on either. The JAX package packs ('p3') on every accelerator because
    packing fills the MXU's lanes; whether it pays on Hopper's tensor cores
    is for the benchmark to decide, and an explicit `--packed` wins."""
    return {
        "compute_dtype": "float32" if platform == "cpu" else "bfloat16",
        "packed_stem": False,
        "packed_interior": False,
        "packed_p3": False,
    }


def normalize_anchors(anchors: Any) -> np.ndarray:
    """Canonicalize any accepted anchor format to a (3, 3, 2) float32 array.

    Accepts: None (defaults), a list of three 3x2 anchor sets, or a single
    3x2 anchor set replicated across scales (backward compatibility with
    the reference's single-set path, reference: train.py:376-382).
    """
    if anchors is None:
        return np.asarray(DEFAULT_ANCHORS, dtype=np.float32)
    arr = np.asarray(anchors, dtype=np.float32)
    if arr.ndim == 2 and arr.shape == (NUM_ANCHORS_PER_SCALE, 2):
        arr = np.stack([arr] * 3)
    if arr.shape != (3, NUM_ANCHORS_PER_SCALE, 2):
        raise ValueError(f"anchors must canonicalize to (3, 3, 2); got {arr.shape}")
    return arr


def make_divisible(x: float, width_mult: float, divisor: int = 8) -> int:
    """Channel scaling helper (reference: train.py:345-347)."""
    return int(np.ceil(x * width_mult / divisor) * divisor)


def make_repeats(n: int, depth_mult: float) -> int:
    """Depth scaling helper (reference: train.py:349-351)."""
    return max(round(n * depth_mult), 1) if n > 1 else n


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    """Static model configuration. Hashable so it can be a jit static arg."""

    num_classes: int = 1
    img_size: int = 640
    width_mult: float = 0.50
    depth_mult: float = 0.33
    # anchors stored as a nested tuple so the dataclass stays hashable
    anchors: tuple = DEFAULT_ANCHORS
    compute_dtype: str = "float32"  # "bfloat16" for TPU throughput configs
    # "anchor" = reference-parity 3-anchor heads; "anchor_free" = the
    # YOLOv8-style decoupled head (BASELINE config 5 stretch)
    head_type: str = "anchor"
    # evaluate the stem in space-to-depth packed layout (models/packed.py):
    # numerically equivalent, ~2.4 ms faster per b8 forward on v5e; the
    # model then expects host-packed (B, S/4, S/4, 48) inputs (3-channel
    # inputs still work via a slow on-device pack). Checkpoints are
    # interchangeable with packed_stem=False.
    packed_stem: bool = False
    # extend the packed evaluation through the first C3 stage (stem1 keeps
    # its output 2x2-packed; bb_p3_c3a runs as PackedC3 at half spatial /
    # 4x channels; bb_p3_down consumes the packed map) — the 160x160
    # small-channel layouts XLA executes ~3-10x off their floors become
    # well-shaped 64-128-channel convs. Exact (same params/checkpoints);
    # requires packed_stem.
    packed_interior: bool = False
    # extend packing one level further, through the 80x80 (stride-8) P3
    # stage: bb_p3_down emits a 2x2-packed map; bb_p3_c3b, lateral_p3 and
    # merge_p3 run packed (PackedC3 / GPackedConvBNSiLU); the FPN
    # upsample becomes a channel tile; bb_p4_down / downsample_p3_to_p4
    # consume the packed maps; the head unpacks once. Decision data:
    # the dense 80x80 C3 measures fwd 313 us / fwd+vjp 508 us vs 54/186
    # packed (stagebench --packexp) — the 32-channel 3x3s underfill MXU
    # lanes 4x. Exact-equivalence move; requires packed_interior.
    packed_p3: bool = False

    def __post_init__(self):
        if self.img_size % 32 != 0:
            raise ValueError(f"img_size must be divisible by 32, got {self.img_size}")
        if self.packed_interior and not self.packed_stem:
            raise ValueError("packed_interior requires packed_stem")
        if self.packed_p3 and not self.packed_interior:
            raise ValueError("packed_p3 requires packed_interior")
        if self.head_type not in ("anchor", "anchor_free"):
            raise ValueError(f"unknown head_type {self.head_type!r}")
        arr = normalize_anchors(self.anchors if self.anchors else None)
        object.__setattr__(
            self, "anchors", tuple(tuple(tuple(float(v) for v in wh) for wh in s) for s in arr)
        )

    # ---- derived quantities -------------------------------------------------
    @property
    def grid_sizes(self) -> tuple:
        return tuple(self.img_size // s for s in STRIDES)

    @property
    def num_anchors(self) -> int:
        return NUM_ANCHORS_PER_SCALE

    @property
    def output_dim(self) -> int:
        return 5 + self.num_classes

    @property
    def anchors_array(self) -> np.ndarray:
        return np.asarray(self.anchors, dtype=np.float32)

    # channel widths (reference: train.py:353-357)
    @property
    def c_stem(self) -> int:
        return make_divisible(64, self.width_mult)

    @property
    def c_p3(self) -> int:
        return make_divisible(128, self.width_mult)

    @property
    def c_p4(self) -> int:
        return make_divisible(256, self.width_mult)

    @property
    def c_p5(self) -> int:
        return make_divisible(512, self.width_mult)

    def repeats(self, n: int) -> int:
        return make_repeats(n, self.depth_mult)

    def with_(self, **kw) -> "YoloConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_size(size: str, **kw) -> "YoloConfig":
        if size not in YOLO_SIZES:
            raise ValueError(f"unknown size {size!r}; choose from {list(YOLO_SIZES)}")
        return YoloConfig(**YOLO_SIZES[size], **kw)
