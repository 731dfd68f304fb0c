"""The PyTorch port loads, serves and trains without JAX or flax.

The card's machine has no flax, and the port must need none of jax: in a
fresh interpreter the port must import, build a Predictor and serve an
S x S uint8 array (whose letterbox is the identity and needs no PIL) on the
CPU with none of jax, flax or PIL in `sys.modules`; and train one step on
the CPU from a dataset of JPEGs (PIL decodes them) with no jax or flax.
The conv-backward prototype benchmarks import with none of jax, flax or
triton, and run their CPU check as a user runs them.
"""

import subprocess
import sys
from pathlib import Path

import pytest

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


TRAIN_SCRIPT = """
import sys
import torch

from yolo_from_scratch_tpu_torch import YoloConfig
from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
from yolo_from_scratch_tpu_torch.data.device_queue import DeviceQueue
from yolo_from_scratch_tpu_torch.train.steps import (
    create_train_state, make_train_step)
from yolo_from_scratch_tpu_torch.utils.yaml_cfg import load_dataset_yaml
import yolo_from_scratch_tpu_torch.cli
import yolo_from_scratch_tpu_torch.train.loop

config = load_dataset_yaml(sys.argv[1])
cfg = YoloConfig(num_classes=config["nc"], img_size=128, width_mult=0.25,
                 depth_mult=0.33)
cpu = torch.device("cpu")
loader = DataLoader(YoloDataset(config["train"], cfg.num_classes,
                                cfg.anchors_array, cfg.img_size,
                                backend="pil"), batch_size=2)
state = create_train_state(cfg, 1e-3, seed=0, device=cpu)
images, targets, _ = next(iter(DeviceQueue(loader, cpu)))
state, metrics = make_train_step(cfg)(state, images, targets)
assert state.step == 1 and torch.isfinite(metrics["loss"]), metrics
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print("LOADED", loaded)
"""


def test_port_trains_without_jax_or_flax(temp_dataset_dir):
    result = subprocess.run(
        [sys.executable, "-c", TRAIN_SCRIPT,
         str(temp_dataset_dir / "dataset.yaml")],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT)
    assert result.returncode == 0, result.stderr
    assert "LOADED []" in result.stdout, result.stdout


PROTOTYPES = ["bwdproto", "blockbwd"]

PROTOTYPE_IMPORT = """
import sys
import importlib

importlib.import_module(sys.argv[1])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "triton"))
print("LOADED", loaded)
"""


@pytest.mark.parametrize("module", PROTOTYPES)
def test_prototype_benchmark_imports_without_jax_flax_or_triton(module):
    result = subprocess.run(
        [sys.executable, "-c", PROTOTYPE_IMPORT,
         f"yolo_from_scratch_tpu_torch.benchmarks.{module}"],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT)
    assert result.returncode == 0, result.stderr
    assert "LOADED []" in result.stdout, result.stdout


@pytest.mark.parametrize("module", PROTOTYPES)
def test_prototype_benchmark_runs_on_the_cpu(module):
    """`--device cpu` checks the plain versions at 2x16x16x64 against
    autograd and skips timing, as the JAX scripts' `--interpret` does."""
    result = subprocess.run(
        [sys.executable, "-m",
         f"yolo_from_scratch_tpu_torch.benchmarks.{module}", "--device",
         "cpu"], capture_output=True, text=True, timeout=300, cwd=REPO_ROOT)
    assert result.returncode == 0, result.stderr
    assert "correctness" in result.stderr and "2x16x16x64 (cpu)" in \
        result.stderr, result.stderr
    assert "timing skipped" in result.stderr, result.stderr
