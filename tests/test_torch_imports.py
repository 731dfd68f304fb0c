"""The PyTorch port loads, serves and trains without JAX or flax.

The card's machine has no flax, and the port must need none of jax: in a
fresh interpreter the port must import, build a Predictor and serve an
S x S uint8 array (whose letterbox is the identity and needs no PIL) on the
CPU with either head and none of jax, flax or PIL in `sys.modules`; and
train one step of either head on the CPU from a dataset of JPEGs (PIL
decodes them), with dense targets, on the compact path (mosaic,
augmentation, the sparse loss, AdamW) and through the scanned compact
trainer that `--stream` drives, with no jax or flax.
The conv-backward prototype benchmarks import with none of jax, flax or
triton, and run their CPU check as a user runs them. None of these loads
any module of the JAX package (`yolo_from_scratch_tpu`), and no source
file of the port, `chip_smoke.py` or `train_torch.py` names one in an
import.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT_DIR = REPO_ROOT / "yolo_from_scratch_tpu_torch"
JAX_PACKAGE = "yolo_from_scratch_tpu"

# appended to each subprocess script: no module of the JAX package loaded
NO_JAX_PACKAGE = """
jax_package = sorted(m for m in sys.modules
                     if m.split(".")[0] == "yolo_from_scratch_tpu")
assert not jax_package, jax_package
print("NO JAX PACKAGE")
"""

SCRIPT = """
import sys
import numpy as np
import torch

import yolo_from_scratch_tpu_torch
from yolo_from_scratch_tpu_torch import YoloConfig
from yolo_from_scratch_tpu_torch.infer.predict import Predictor
from yolo_from_scratch_tpu_torch.models import anchor_free
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
af = cfg.with_(head_type="anchor_free")
af_state = from_flax_variables(random_variables(YOLO(af, device="meta"), 2),
                               YOLO(af, device="meta"))
dets = Predictor(af_state, af, conf_threshold=0.3,
                 device=torch.device("cpu"))(img)
assert dets and all(np.isfinite(d[:5]).all() for d in dets), dets
assert nms_cuda.launches == 0
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "PIL"))
print("LOADED", loaded)
""" + NO_JAX_PACKAGE


def test_port_serves_without_jax_flax_or_pil():
    result = subprocess.run([sys.executable, "-c", SCRIPT],
                            capture_output=True, text=True, timeout=300,
                            cwd=REPO_ROOT)
    assert result.returncode == 0, result.stderr
    assert "LOADED []" in result.stdout, result.stdout
    assert "NO JAX PACKAGE" in result.stdout, result.stdout


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
import yolo_from_scratch_tpu_torch.data.cache
import yolo_from_scratch_tpu_torch.data.stream
import yolo_from_scratch_tpu_torch.train.graphs
import yolo_from_scratch_tpu_torch.train.loop
from yolo_from_scratch_tpu_torch.train.steps import (
    make_train_step_multi_compact)

config = load_dataset_yaml(sys.argv[1])
cfg = YoloConfig(num_classes=config["nc"], img_size=128, width_mult=0.25,
                 depth_mult=0.33)
cpu = torch.device("cpu")
for head in ("anchor", "anchor_free"):
    cfg = cfg.with_(head_type=head)
    loader = DataLoader(YoloDataset(config["train"], cfg.num_classes,
                                    cfg.anchors_array, cfg.img_size,
                                    backend="pil", head_type=head),
                        batch_size=2)
    state = create_train_state(cfg, 1e-3, seed=0, device=cpu)
    images, targets, _ = next(iter(DeviceQueue(loader, cpu)))
    state, metrics = make_train_step(cfg)(state, images, targets)
    assert state.step == 1 and torch.isfinite(metrics["loss"]), metrics
    # the compact path: labels expanded in the step, mosaic, augment, AdamW
    loader = DataLoader(loader.dataset, batch_size=2, compact=8)
    state = create_train_state(cfg, 1e-3, seed=0, device=cpu,
                               weight_decay=0.05)
    images, targets, _ = next(iter(DeviceQueue(loader, cpu)))
    step = make_train_step(cfg, compact_targets=True, device_mosaic=True,
                           device_augment="full", sparse_loss=True)
    state, metrics = step(state, images, targets)
    assert state.step == 1 and torch.isfinite(metrics["loss"]), metrics
    # the scanned trainer (--stream): a chunk of two steps
    chunk = [torch.stack([t, t]) for t in (images, *targets)]
    state, metrics = make_train_step_multi_compact(
        cfg, device_mosaic=True, device_augment="full")(state, *chunk)
    assert state.step == 3 and torch.isfinite(metrics["loss"]), metrics
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print("LOADED", loaded)
""" + NO_JAX_PACKAGE


def test_port_trains_without_jax_or_flax(temp_dataset_dir):
    result = subprocess.run(
        [sys.executable, "-c", TRAIN_SCRIPT,
         str(temp_dataset_dir / "dataset.yaml")],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT)
    assert result.returncode == 0, result.stderr
    assert "LOADED []" in result.stdout, result.stdout
    assert "NO JAX PACKAGE" in result.stdout, result.stdout


PROTOTYPES = ["bwdproto", "blockbwd"]

PROTOTYPE_IMPORT = """
import sys
import importlib

importlib.import_module(sys.argv[1])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "triton"))
print("LOADED", loaded)
""" + NO_JAX_PACKAGE


@pytest.mark.parametrize("module", PROTOTYPES)
def test_prototype_benchmark_imports_without_jax_flax_or_triton(module):
    result = subprocess.run(
        [sys.executable, "-c", PROTOTYPE_IMPORT,
         f"yolo_from_scratch_tpu_torch.benchmarks.{module}"],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT)
    assert result.returncode == 0, result.stderr
    assert "LOADED []" in result.stdout, result.stdout
    assert "NO JAX PACKAGE" in result.stdout, result.stdout


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


def _imported_modules(path):
    """Every module name an import statement of `path` names, absolute or
    relative (resolved against the port's package)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                names.append("yolo_from_scratch_tpu_torch")
            elif node.module:
                names.append(node.module)
                names += [f"{node.module}.{a.name}" for a in node.names]
    return names


PORT_SOURCES = sorted(PORT_DIR.rglob("*.py")) + [
    REPO_ROOT / "chip_smoke.py", REPO_ROOT / "train_torch.py"]


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=[str(p.relative_to(REPO_ROOT))
                              for p in PORT_SOURCES])
def test_port_source_imports_nothing_of_the_jax_package(path):
    """Static check: no import in the port's sources, chip_smoke.py or
    train_torch.py names `yolo_from_scratch_tpu` or one of its submodules, at module level
    or inside a function."""
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in (JAX_PACKAGE, "jax", "jaxlib", "flax")]
    assert not bad, f"{path}: imports {bad}"


def test_static_check_sees_the_port():
    """The static check above parses the whole port, including lazy
    imports inside functions (a guard against an empty glob)."""
    assert len(PORT_SOURCES) > 30
    for module in ("data/cache.py", "data/stream.py", "train/graphs.py"):
        assert PORT_DIR / module in PORT_SOURCES, module
    names = _imported_modules(PORT_DIR / "infer" / "predict.py")
    assert "yolo_from_scratch_tpu_torch.data.letterbox" in names
