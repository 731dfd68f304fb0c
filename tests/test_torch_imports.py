"""The PyTorch port loads and serves without JAX, flax or PIL.

The card's machine has no jax, flax or PIL, so in a fresh interpreter the
port must import, build a Predictor and serve an S x S uint8 array (whose
letterbox is the identity and needs no PIL) on the CPU with none of them
in `sys.modules`.
"""

import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent

SCRIPT = """
import sys
import numpy as np
import torch

import yolo_from_scratch_tpu_torch
from yolo_from_scratch_tpu_torch import YoloConfig
from yolo_from_scratch_tpu_torch.infer.predict import Predictor
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import nms_cuda
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables, random_variables)
import yolo_from_scratch_tpu_torch.cli
import yolo_from_scratch_tpu_torch.device
import yolo_from_scratch_tpu_torch.kernels.build
import yolo_from_scratch_tpu_torch.utils.checkpoint

cfg = YoloConfig(num_classes=2, img_size=64, width_mult=0.25, depth_mult=0.33)
state = from_flax_variables(random_variables(YOLO(cfg, device="meta"), 1),
                            YOLO(cfg, device="meta"))
img = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
dets = Predictor(state, cfg, conf_threshold=0.005,
                 device=torch.device("cpu"))(img)
assert dets and all(np.isfinite(d[:5]).all() for d in dets), dets
assert nms_cuda.launches == 0
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "PIL"))
print("LOADED", loaded)
"""


def test_port_serves_without_jax_flax_or_pil():
    result = subprocess.run([sys.executable, "-c", SCRIPT],
                            capture_output=True, text=True, timeout=300,
                            cwd=REPO_ROOT)
    assert result.returncode == 0, result.stderr
    assert "LOADED []" in result.stdout, result.stdout
