"""mAP / detection P/R/F1 of the PyTorch port (`train/map_eval.py`, the
CLI's `--map` and `--val-det`) against the JAX package, on the CPU.

- every function on the same detection and ground-truth lists: exactly
  JAX's numbers (the same host numpy on the same floats);
- end to end over a dataset with each package's BatchPredictor (the
  served weights of tests/test_torch_predict.py): detection counts equal,
  map50 and map within 1e-4. The detections agree to 1e-2 px and 1e-5 in
  confidence; a count could only move for a score within ~1e-6 of the gate
  or an IoU within ~1e-6 of the NMS threshold, and then COUNT_NOTE says so.
"""

import json
import re

import numpy as np
import pytest
import torch
from test_torch_predict import COUNT_NOTE, _state

from yolo_from_scratch_tpu.data.dataset import YoloDataset as JaxDataset
from yolo_from_scratch_tpu.infer.predict import (
    BatchPredictor as JaxBatchPredictor,
)
from yolo_from_scratch_tpu.train import map_eval as jax_map
from yolo_from_scratch_tpu.utils.checkpoint import save_checkpoint
from yolo_from_scratch_tpu_torch import cli
from yolo_from_scratch_tpu_torch.data import YoloDataset
from yolo_from_scratch_tpu_torch.infer.predict import BatchPredictor
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.train import map_eval
from yolo_from_scratch_tpu_torch.train.steps import create_train_state
from yolo_from_scratch_tpu_torch.utils.convert import (
    random_variables,
    to_flax_variables,
)

CPU = torch.device("cpu")

# tests/test_map.py's hand-computable cases: (detections, ground truths,
# classes)
HAND_CASES = {
    "perfect": ([[(10, 10, 50, 50, 0.9, 0)], [(20, 20, 80, 80, 0.8, 0)]],
                [[(0, 10, 10, 50, 50)], [(0, 20, 20, 80, 80)]], 1),
    "none": ([[]], [[(0, 10, 10, 50, 50)]], 1),
    "false_positive_first": (
        [[(200, 200, 240, 240, 0.95, 0), (10, 10, 50, 50, 0.9, 0)]],
        [[(0, 10, 10, 50, 50)]], 1),
    "duplicate_counts_once": (
        [[(10, 10, 50, 50, 0.9, 0), (11, 11, 51, 51, 0.8, 0)]],
        [[(0, 10, 10, 50, 50)]], 1),
    "wrong_class": ([[(10, 10, 50, 50, 0.9, 0)]], [[(1, 10, 10, 50, 50)]],
                    2),
    "iou_0_68": ([[(14, 14, 54, 54, 0.9, 0)]], [[(0, 10, 10, 50, 50)]], 1),
    "overlapping_gts_both_matched": (
        [[(10, 10, 50, 50, 0.9, 0), (12, 12, 52, 52, 0.8, 0)]],
        [[(0, 10, 10, 50, 50), (0, 14, 14, 54, 54)]], 1),
    "operating_point": (
        [[(10, 10, 20, 20, 0.9, 0), (50, 50, 60, 60, 0.4, 0),
          (80, 80, 90, 90, 0.8, 0)]],
        [[(0, 10, 10, 20, 20), (0, 50, 50, 60, 60)]], 1),
}


def _synthetic(seed, n_images=12, num_classes=3):
    """Seeded detection and ground-truth lists: per image 0-5 GTs; for
    each, detections jittered around it (some of another class), plus
    random false positives, with random confidences."""
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for _ in range(n_images):
        g, d = [], []
        for _ in range(int(rng.integers(0, 6))):
            x1, y1 = rng.uniform(0, 400, 2)
            w, h = rng.uniform(10, 120, 2)
            c = int(rng.integers(0, num_classes))
            g.append((c, x1, y1, x1 + w, y1 + h))
            for _ in range(int(rng.integers(0, 3))):
                j = rng.normal(0, 0.15, 4) * (w, h, w, h)
                cls = c if rng.random() < 0.8 else int(
                    rng.integers(0, num_classes))
                d.append((x1 + j[0], y1 + j[1], x1 + w + j[2], y1 + h + j[3],
                          float(rng.random()), cls))
        for _ in range(int(rng.integers(0, 4))):
            x1, y1 = rng.uniform(0, 400, 2)
            w, h = rng.uniform(10, 120, 2)
            d.append((x1, y1, x1 + w, y1 + h, float(rng.random()),
                      int(rng.integers(0, num_classes))))
        gts.append([tuple(float(v) if i else v for i, v in enumerate(t))
                    for t in g])
        dets.append([tuple(float(v) for v in t[:5]) + (t[5],) for t in d])
    return dets, gts


CASES = {**HAND_CASES, **{f"seed{s}": (*_synthetic(s), 3) for s in range(4)}}


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_function_gives_jax_numbers(name):
    dets, gts, nc = CASES[name]
    for thr in (0.5, 0.75):
        assert map_eval.average_precision(dets, gts, thr, nc) == \
            jax_map.average_precision(dets, gts, thr, nc)
    assert map_eval.coco_map(dets, gts, nc) == jax_map.coco_map(dets, gts, nc)
    assert map_eval.coco_map(dets, gts, nc, [0.55, 0.7]) == \
        jax_map.coco_map(dets, gts, nc, [0.55, 0.7])
    for conf in (0.5, 0.1):
        assert map_eval.detection_counts(dets, gts, conf) == \
            jax_map.detection_counts(dets, gts, conf)
        assert map_eval.detection_prf1(dets, gts, conf) == \
            jax_map.detection_prf1(dets, gts, conf)
    for img_dets, img_gts in zip(dets, gts):
        if img_dets and img_gts:
            b = np.asarray([g[1:5] for g in img_gts], np.float32)
            a = np.asarray(img_dets[0][:4])
            np.testing.assert_array_equal(map_eval._iou_corner(a, b),
                                          jax_map._iou_corner(a, b))


def test_hand_cases_read_as_in_the_jax_tests():
    def ap(name, thr=0.5):
        return map_eval.average_precision(*HAND_CASES[name][:2], thr,
                                          HAND_CASES[name][2])

    assert ap("perfect")[0] == pytest.approx(1.0)
    assert ap("none")[0] == 0.0
    assert 0.0 < ap("false_positive_first")[0] < 1.0
    assert ap("duplicate_counts_once")[0] == pytest.approx(1.0)
    assert ap("wrong_class") == (0.0, {1: 0.0})
    assert ap("iou_0_68")[0] == pytest.approx(1.0)
    assert ap("iou_0_68", 0.75)[0] == 0.0
    assert ap("overlapping_gts_both_matched")[0] == pytest.approx(1.0)
    assert map_eval.detection_prf1(*HAND_CASES["operating_point"][:2]) == \
        (50.0, 50.0, 50.0)


def test_average_precision_curve_matches_jax():
    rng = np.random.default_rng(7)
    for n in (0, 1, 5, 40):
        recall = np.sort(rng.random(n))
        precision = rng.random(n)
        assert map_eval._average_precision(recall, precision) == \
            jax_map._average_precision(recall, precision)


@pytest.fixture(scope="module")
def served(cfg):
    """tests/test_torch_predict.py's `served` weights."""
    v = random_variables(YOLO(cfg, device="meta"), seed=0)
    for head in ("head_p3", "head_p4", "head_p5"):
        v["params"][head]["pred"]["bias"].reshape(3, -1)[:, 4] += 4.6
    return v


def _datasets(cfg, root, split):
    path = str(root / split / "images")
    return (YoloDataset(path, 1, cfg.anchors_array, cfg.img_size),
            JaxDataset(path, 1, cfg.anchors_array, cfg.img_size))


@pytest.fixture(scope="module")
def jax_map_numbers(cfg, served, temp_dataset_dir):
    """The JAX package's evaluate_map per split and detection counts on
    val, with its BatchPredictor as the JAX CLI's --map builds it."""
    predictor = JaxBatchPredictor(served, cfg, conf_threshold=1e-3,
                                  max_outputs=300)
    out = {split: jax_map.evaluate_map(
        predictor, _datasets(cfg, temp_dataset_dir, split)[1], num_classes=1)
        for split in ("train", "val")}
    out["counts"] = jax_map.evaluate_det_counts(
        predictor, _datasets(cfg, temp_dataset_dir, "val")[1])
    return out


def test_evaluate_map_end_to_end_matches_jax(cfg, served, temp_dataset_dir,
                                             jax_map_numbers):
    ds, _ = _datasets(cfg, temp_dataset_dir, "val")
    predictor = BatchPredictor(_state(cfg, served), cfg, conf_threshold=1e-3,
                               max_outputs=300, device=CPU)
    assert map_eval.evaluate_det_counts(predictor, ds) == \
        jax_map_numbers["counts"], COUNT_NOTE
    got = map_eval.evaluate_map(predictor, ds, num_classes=1)
    want = jax_map_numbers["val"]
    assert got["map50"] == pytest.approx(want["map50"], abs=1e-4)
    assert got["map"] == pytest.approx(want["map"], abs=1e-4)
    assert got["per_class_ap50"].keys() == want["per_class_ap50"].keys()
    for key in ("det_precision", "det_recall", "det_f1"):
        assert got[key] == want[key], COUNT_NOTE
    assert 0.0 < got["map"] <= got["map50"]
    assert map_eval.evaluate_det_prf1(predictor, ds, conf_threshold=0.5) == \
        (want["det_precision"], want["det_recall"], want["det_f1"])


class _Recorder(BatchPredictor):
    """A BatchPredictor that records each batch and detects nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, images):
        self.calls.append(list(images))
        return [[] for _ in images]


def test_last_chunk_padded_with_its_first_image(cfg, temp_dataset_dir):
    ds, _ = _datasets(cfg, temp_dataset_dir, "val")
    recorder = _Recorder()
    dets, gts = map_eval._collect_dets_and_gts(recorder, ds, batch_size=2)
    assert len(ds) == 5 and len(dets) == len(gts) == 5
    assert recorder.calls == [ds.imgs[0:2], ds.imgs[2:4],
                              [ds.imgs[4], ds.imgs[4]]]
    # GT in original coordinates from the label files, as the JAX package
    _, j_gts = jax_map._collect_dets_and_gts(lambda path: [], ds)
    assert gts == j_gts


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, cfg, served):
    path = tmp_path_factory.mktemp("map_ckpt") / "served.ckpt"
    save_checkpoint(path, served, cfg, epoch=0)
    return path


MAP_LINES = re.compile(
    r"  mAP@0\.5: (\S+)%\n  mAP@\[\.5:\.95\]: (\S+)%\n"
    r"  Detection P/R/F1 @conf0\.5: (\S+)% / (\S+)% / (\S+)%")


def test_cli_map_prints_jax_numbers(temp_dataset_dir, checkpoint,
                                    jax_map_numbers, capsys):
    assert cli.main([str(temp_dataset_dir / "dataset.yaml"), str(checkpoint),
                     "--map", "--device", "cpu", "--batch-size", "2"]) == 0
    out = capsys.readouterr().out
    train, val = out.split("\nTraining Set:\n")[1].split(
        "\nValidation Set:\n")
    for split, block in (("train", train), ("val", val)):
        m = MAP_LINES.search(block)
        assert m, block
        want = jax_map_numbers[split]
        printed = [float(v) for v in m.groups()]
        # printed to 0.01 %: half of that, plus the 1e-4 of the values
        assert printed[0] == pytest.approx(want["map50"] * 100, abs=0.015)
        assert printed[1] == pytest.approx(want["map"] * 100, abs=0.015)
        assert m.group(3, 4, 5) == tuple(
            f"{want[k]:.2f}" for k in ("det_precision", "det_recall",
                                       "det_f1")), COUNT_NOTE
    assert "Per-class" not in out  # one class


def test_cli_val_det_epoch_line_and_record(temp_dataset_dir, tmp_path,
                                           monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    metrics = tmp_path / "m.jsonl"
    assert cli.main([str(temp_dataset_dir / "dataset.yaml"), "--epochs", "1",
                     "--batch-size", "2", "--size", "n", "--img-size", "128",
                     "--device", "cpu", "--val-det", "--metrics-jsonl",
                     str(metrics)]) == 0
    line = next(x for x in capsys.readouterr().out.splitlines()
                if x.startswith("Epoch 1:"))
    assert re.fullmatch(
        r"Epoch 1: Loss: .* \| Val: Loss \S+, P \S+%, R \S+%, F1 \S+% \| "
        r"Det: P \d+\.\d%, R \d+\.\d%, F1 \d+\.\d% \| LR: \S+ \| \S+ img/s",
        line), line
    (record,) = [json.loads(x) for x in metrics.read_text().splitlines()]
    det = re.search(r"Det: P (\S+)%, R (\S+)%, F1 (\S+)%", line).groups()
    assert [f"{record[k]:.1f}" for k in ("det_precision", "det_recall",
                                         "det_f1")] == list(det)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_det_eval_serves_a_copy_and_matches_jax(cfg, temp_dataset_dir,
                                                dtype):
    """`--val-det`'s predictor holds its own model: the training model
    keeps its float32 master weights (the predictor casts its convs to
    the compute dtype), and in float32 the metric is the JAX CLI's."""
    cfg = cfg.with_(compute_dtype=dtype)
    ds, jax_ds = _datasets(cfg, temp_dataset_dir, "val")
    state = create_train_state(cfg, 1e-3, seed=3, device=CPU)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    det_eval = cli._det_eval(cfg, state.model, ds, CPU)
    with torch.no_grad():  # a training step moves the live weights
        for p in state.model.parameters():
            p.mul_(1.01)
    got = det_eval(state.model)
    for key, t in state.model.state_dict().items():
        assert t.dtype == before[key].dtype
    assert state.model.stem0.conv.weight.dtype == torch.float32
    assert len(got) == 3
    if dtype == "float32":
        variables = to_flax_variables(state.model.state_dict())
        want = jax_map.detection_prf1(*jax_map._collect_dets_and_gts(
            JaxBatchPredictor(variables, cfg, conf_threshold=0.5), jax_ds))
        assert got == want, COUNT_NOTE
