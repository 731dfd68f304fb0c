"""The PyTorch port loads, serves and trains without JAX or flax.

The card's machine has no flax, and the port must need none of jax: in a
fresh interpreter the port must import, build a Predictor and serve an
S x S uint8 array (whose letterbox is the identity and needs no PIL) on the
CPU with either head and none of jax, flax or PIL in `sys.modules`; and
train one step of either head on the CPU from a dataset of JPEGs (PIL
decodes them), with dense targets, on the compact path (mosaic,
augmentation, the sparse loss, AdamW), through the scanned compact
trainer that `--stream` drives, with its per-step learning rate and EMA,
and load augmented items (`--augment`), with no jax, flax or OpenCV.
The int8 path (`infer/quantize.py`, `ops/quant.py`) quantizes and serves,
and `infer/export.py` writes an artifact that `infer/artifact.py` loads and
serves, with none of jax or flax.
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

# one intra-op thread: the test workers share the cores
torch.set_num_threads(1)

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
from yolo_from_scratch_tpu_torch.train.ema import ema_init
from yolo_from_scratch_tpu_torch.train.loop import restore_train_state
from yolo_from_scratch_tpu_torch.train.schedule import make_step_lr

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
    # the recipe knobs: a per-step learning rate and an EMA in the chunk
    (state, ema), metrics = make_train_step_multi_compact(
        cfg, step_lr=make_step_lr(8, 2, 1e-3, 1e-5), ema_decay=0.99)(
        (state, ema_init(state.model)), *chunk)
    assert state.step == 5 and torch.isfinite(metrics["loss"]), metrics
# the native loader's batch; the data-parallel, spatial and tensor-parallel
# modules
import yolo_from_scratch_tpu_torch.parallel.distributed
import yolo_from_scratch_tpu_torch.parallel.spatial
import yolo_from_scratch_tpu_torch.parallel.tensor
native = YoloDataset(config["train"], cfg.num_classes, cfg.anchors_array,
                     cfg.img_size, backend="native")
assert native.load_batch([0, 1])[0].shape == (2, 128, 128, 3)
# host --augment (the mosaic's bilinear resize without OpenCV)
aug = YoloDataset(config["train"], cfg.num_classes, cfg.anchors_array,
                  cfg.img_size, augment=True, seed=1)
for i in range(len(aug)):
    assert aug[i][0].shape == (cfg.img_size, cfg.img_size, 3)
assert "cv2" not in sys.modules
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


INT8_EXPORT_SCRIPT = """
import sys
import numpy as np
import torch

from yolo_from_scratch_tpu_torch import YoloConfig
from yolo_from_scratch_tpu_torch.infer.artifact import load_serving_artifact
from yolo_from_scratch_tpu_torch.infer.export import save_serving_artifact
from yolo_from_scratch_tpu_torch.infer.predict import BatchPredictor
from yolo_from_scratch_tpu_torch.infer.quantize import QuantConvBNSiLU
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import quant
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables, random_variables)

torch.set_num_threads(1)
cpu = torch.device("cpu")
cfg = YoloConfig(num_classes=2, img_size=64, width_mult=0.25, depth_mult=0.33)
state = from_flax_variables(random_variables(YOLO(cfg, device="meta"), 1),
                            YOLO(cfg, device="meta"))
imgs = [np.random.default_rng(i).integers(0, 256, (64, 64, 3), np.uint8)
        for i in range(2)]
live = BatchPredictor(state, cfg, conf_threshold=0.005, device=cpu,
                      quantize_calib=imgs)
assert sum(isinstance(m, QuantConvBNSiLU) for m in live.model.modules()) == 58
assert all(live(imgs))
save_serving_artifact(sys.argv[1], state, cfg, 2, conf_threshold=0.005,
                      platforms=["cpu"], quantize_calib=imgs)
assert all(load_serving_artifact(sys.argv[1])(imgs))
assert quant.conv_launches == 0 and quant.quant_launches == 0
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print("LOADED", loaded)
""" + NO_JAX_PACKAGE


def test_port_quantizes_and_exports_without_jax_or_flax(tmp_path):
    result = subprocess.run(
        [sys.executable, "-c", INT8_EXPORT_SCRIPT, str(tmp_path / "q.yexp")],
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
    REPO_ROOT / "chip_smoke.py", REPO_ROOT / "train_torch.py",
    REPO_ROOT / "eval_torch.py"]


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=[str(p.relative_to(REPO_ROOT))
                              for p in PORT_SOURCES])
def test_port_source_imports_nothing_of_the_jax_package(path):
    """Static check: no import in the port's sources, chip_smoke.py,
    train_torch.py or eval_torch.py names `yolo_from_scratch_tpu` or one of its submodules, at module level
    or inside a function."""
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in (JAX_PACKAGE, "jax", "jaxlib", "flax")]
    assert not bad, f"{path}: imports {bad}"


def test_static_check_sees_the_port():
    """The static check above parses the whole port, including lazy
    imports inside functions (a guard against an empty glob)."""
    assert len(PORT_SOURCES) > 30
    for module in ("data/cache.py", "data/stream.py", "train/graphs.py",
                   "train/ema.py", "train/schedule.py", "infer/quantize.py",
                   "infer/export.py", "infer/artifact.py", "ops/quant.py",
                   "native/__init__.py", "parallel/__init__.py",
                   "parallel/mesh.py", "parallel/distributed.py",
                   "parallel/spatial.py", "parallel/tensor.py"):
        assert PORT_DIR / module in PORT_SOURCES, module
    names = _imported_modules(PORT_DIR / "infer" / "predict.py")
    assert "yolo_from_scratch_tpu_torch.data.letterbox" in names
    # the artifact loader imports no model module, at any level
    names = _imported_modules(PORT_DIR / "infer" / "artifact.py")
    assert "yolo_from_scratch_tpu_torch.ops.quant" in names
    assert not [m for m in names if ".models" in m or ".predict" in m]
