"""Evaluation, LR schedule, checkpoint writing and the train/eval CLI of
the PyTorch port against the JAX package, on the CPU.

Exact where the JAX side is exact: grid metric counts are bit-equal on the
same inputs, and so are P/R/F1 over an epoch when both models see the same
weights (a count could only move for a score or IoU within ~1e-6 of a
threshold, which these inputs keep away from); the schedule and the
checkpoint's arrays are equal. The eval loss agrees to 1e-5 relative (eval
BatchNorm uses the running statistics, so the forwards agree as in
tests/test_torch_model.py).
"""

import contextlib
import io
import re
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu import cli as jax_cli
from yolo_from_scratch_tpu.data.dataset import YoloDataset
from yolo_from_scratch_tpu.data.loader import DataLoader
from yolo_from_scratch_tpu.train.loop import eval_epoch as jax_eval_epoch
from yolo_from_scratch_tpu.train.metrics import (
    grid_metric_counts as jax_counts,
)
from yolo_from_scratch_tpu.train.schedule import lr_at_epoch as jax_lr
from yolo_from_scratch_tpu.train.steps import make_eval_step as jax_eval_step
from yolo_from_scratch_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from yolo_from_scratch_tpu_torch import cli
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops.decode import decode_predictions
from yolo_from_scratch_tpu_torch.train.loop import eval_epoch
from yolo_from_scratch_tpu_torch.train.metrics import grid_metric_counts
from yolo_from_scratch_tpu_torch.train.schedule import lr_at_epoch
from yolo_from_scratch_tpu_torch.train.steps import make_eval_step
from yolo_from_scratch_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
    to_flax_variables,
)

CPU = torch.device("cpu")
EPOCH_LINE = re.compile(
    r"Epoch 1: Loss: \d+\.\d{4} \(bbox: \d+\.\d{4}, obj: \d+\.\d{4}, "
    r"cls: \d+\.\d{4}\) \| Val: Loss \d+\.\d{4}, P \d+\.\d%, R \d+\.\d%, "
    r"F1 \d+\.\d% \| LR: \d\.\d{6} \| \d+\.\d img/s")


@pytest.fixture(scope="module")
def variables(cfg):
    """Seeded weights whose objectness sits near 0.5 (the head's obj bias
    raised by 4.6), so about half the cells count as predictions."""
    v = random_variables(YOLO(cfg, device="meta"), seed=5)
    for head in ("head_p3", "head_p4", "head_p5"):
        v["params"][head]["pred"]["bias"].reshape(3, -1)[:, 4] += 4.6
    return v


def _grid_case(rng, b, gs, nc, anchors, decode_size):
    """Random logits; object cells whose target box is the decoded
    prediction, jittered by a few percent in half of them (IoU > 0.5, a TP
    where predicted) and random elsewhere (mostly an FP)."""
    pred = rng.normal(0, 1, (b, gs, gs, 3, 5 + nc)).astype(np.float32)
    decoded = decode_predictions(torch.from_numpy(pred),
                                 torch.from_numpy(anchors),
                                 decode_size)[..., 0:4].numpy()
    target = np.zeros_like(pred)
    target[..., 4] = rng.random((b, gs, gs, 3)) < 0.3
    near = decoded * rng.uniform(0.97, 1.03, decoded.shape)
    far = np.concatenate([rng.uniform(0.1, 0.9, decoded.shape[:-1] + (2,)),
                          rng.uniform(0.05, 0.5, decoded.shape[:-1] + (2,))],
                         -1)
    target[..., 0:4] = np.where(rng.random(decoded.shape[:-1] + (1,)) < 0.5,
                                near, far)
    return pred, target


@pytest.mark.parametrize("quirk_640", [False, True])
@pytest.mark.parametrize("per_image", [False, True])
def test_grid_metric_counts_bit_equal(default_anchors, quirk_640, per_image):
    rng = np.random.default_rng(int(quirk_640) + 2 * int(per_image))
    for scale, gs in enumerate((16, 8, 4)):
        pred, target = _grid_case(rng, 2, gs, 3, default_anchors[scale],
                                  640 if quirk_640 else 128)
        got = grid_metric_counts(
            torch.from_numpy(pred), torch.from_numpy(target),
            torch.from_numpy(default_anchors[scale]), 128,
            quirk_640=quirk_640, per_image=per_image)
        want = jax_counts(pred, target, default_anchors[scale], 128,
                          quirk_640=quirk_640, per_image=per_image)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(got[0].sum()) > 0 and int(got[1].sum()) > 0


def test_eval_epoch_matches_jax(cfg, variables, temp_dataset_dir):
    ds = YoloDataset(str(temp_dataset_dir / "val" / "images"), 1,
                     cfg.anchors_array, cfg.img_size, backend="pil")
    loader = DataLoader(ds, batch_size=len(ds), prefetch=0)
    from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO

    want = jax_eval_epoch(jax_eval_step(JaxYOLO(cfg), cfg),
                          variables["params"], variables["batch_stats"],
                          loader)
    model = YOLO(cfg)
    model.load_state_dict(from_flax_variables(variables, model))
    got = eval_epoch(make_eval_step(cfg), model, loader, CPU)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1:] == want[1:]
    assert got[2] > 0  # some cells were found, the counts are not all zero


def test_lr_at_epoch_matches_jax():
    for kw in ({}, dict(warmup_epochs=5, total_epochs=60, initial_lr=3e-3,
                        min_lr=1e-5)):
        assert [lr_at_epoch(e, **kw) for e in range(101)] == \
            [jax_lr(e, **kw) for e in range(101)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_through_jax(cfg, variables, tmp_path, dtype):
    cfg = cfg.with_(compute_dtype=dtype)
    model = YOLO(cfg, device="meta")
    state = from_flax_variables(variables, model)
    flat = to_flax_variables(state)
    # to_flax_variables o from_flax_variables is the identity
    jax.tree_util.tree_map(np.testing.assert_array_equal, flat, variables)

    path = tmp_path / "port.ckpt"
    save_checkpoint(path, flat, cfg, epoch=2, extra={"step": 7})
    jax_vars, jax_cfg, meta = jax_load_checkpoint(path)
    assert jax_cfg == cfg
    assert meta["epoch"] == 2 and meta["extra"] == {"step": 7}
    assert meta["opt_state"] is None
    jax.tree_util.tree_map(np.testing.assert_array_equal, jax_vars, flat)

    back, back_cfg, back_meta = load_checkpoint(path)
    assert asdict(back_cfg) == asdict(cfg) and back_meta["epoch"] == 2
    for key, t in state.items():
        torch.testing.assert_close(back[key], t, rtol=0, atol=0)
    assert not list(tmp_path.glob("*.tmp"))


def test_cli_trains_evaluates_and_jax_reads_the_checkpoint(
        cfg, temp_dataset_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    yaml_file = str(temp_dataset_dir / "dataset.yaml")
    metrics = tmp_path / "m.jsonl"
    assert cli.main([yaml_file, "--epochs", "1", "--batch-size", "2",
                     "--size", "n", "--img-size", "128", "--device", "cpu",
                     "--metrics-jsonl", str(metrics)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:11] == [
        "Creating YOLOv5N (width=0.25, depth=0.33)",
        "Training YOLO model", "Number of classes: 1",
        "Training images: 5", "Validation images: 5", "Device: cpu", "",
        "Learning Rate Schedule:", "  Initial LR: 0.01",
        "  Minimum LR: 0.0001", "  Warmup epochs: 3"]
    assert out[11] == "  Total epochs: 1"
    assert EPOCH_LINE.fullmatch(out[12]), out[12]
    assert out[13] == ""
    saved = re.fullmatch(r"Training complete\. Model saved to "
                         r"(yolo_\d{8}_\d{6}\.ckpt)", out[14])
    assert saved, out[14]
    assert len(metrics.read_text().splitlines()) == 1

    # the JAX CLI's inspect mode reads the port-written file
    jax_cli.main([saved.group(1)])
    jax_out = capsys.readouterr().out
    n = sum(p.numel() for p in YOLO(cfg, device="meta").parameters())
    assert f"Total parameters: {n:,}" in jax_out
    assert "Image size: 128" in jax_out

    assert cli.main([yaml_file, saved.group(1), "--device", "cpu",
                     "--batch-size", "2", "--size", "n"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1] == f"Evaluating model from {saved.group(1)}"
    for title in ("Training", "Validation"):
        i = out.index(f"{title} Set:")
        assert re.fullmatch(r"  Loss: \d+\.\d{4}", out[i + 1])
        for k, name in enumerate(("Precision", "Recall", "F1 Score")):
            assert re.fullmatch(rf"  {name}: \d+\.\d\d%", out[i + 2 + k])


def _eval_numbers(argv):
    """The evaluation mode's loss and P / R / F1 lines, per split."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main([*argv, "--device", "cpu", "--batch-size", "2"]) == 0
    lines = out.getvalue().splitlines()
    numbers = []
    for title in ("Training", "Validation"):
        i = lines.index(f"{title} Set:")
        numbers.append((float(lines[i + 1].split()[-1]), lines[i + 2:i + 5]))
    return numbers


@pytest.fixture(scope="module")
def eval_checkpoint(cfg, variables, temp_dataset_dir, tmp_path_factory):
    """The evaluation mode's arguments on a checkpoint, and its numbers
    unpacked."""
    path = tmp_path_factory.mktemp("packed_eval") / "m.ckpt"
    save_checkpoint(str(path), variables, cfg)
    argv = [str(temp_dataset_dir / "dataset.yaml"), str(path)]
    return argv, _eval_numbers(argv)


# the packed layouts and their aliases, once refused with exit 2, evaluate
# (with --data-parallel at a world of one too): the same P / R / F1 as the
# unpacked model on the same checkpoint, the loss within 2e-4
@pytest.mark.parametrize("args", [["--packed-stem"],
                                  ["--packed-stem", "--data-parallel"],
                                  ["--packed", "p3"],
                                  ["--packed-interior"],
                                  ["--packed-p3"]])
def test_cli_unported_flags_exit_2(args, eval_checkpoint):
    argv, want = eval_checkpoint
    got = _eval_numbers([*argv, *args])
    assert any(p != "  Precision: 0.00%" for _, (p, *_) in want)
    for (loss, prf), (want_loss, want_prf) in zip(got, want):
        assert prf == want_prf
        assert abs(loss - want_loss) <= 2e-4


# --model-parallel answers as the JAX CLI does: without --data-parallel,
# on a world of one that N does not divide, and --distributed without a
# coordinator or torchrun's environment, each exit 1
@pytest.mark.parametrize("args,says", [
    (["--model-parallel", "8"], "--spatial/--model-parallel require "
                                "--data-parallel"),
    (["--model-parallel", "2"], "--spatial/--model-parallel require "
                                "--data-parallel"),
    (["--model-parallel", "4", "--data-parallel"],
     "1 devices do not divide into model=4"),
    (["--model-parallel", "4", "--distributed"], "torchrun"),
])
def test_cli_model_parallel_exits_as_jax(args, says, temp_dataset_dir,
                                         monkeypatch, capsys):
    from yolo_from_scratch_tpu_torch.parallel import distributed

    for key in distributed.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    assert cli.main([str(temp_dataset_dir / "dataset.yaml"), "--device",
                     "cpu", *args]) == 1
    assert says in capsys.readouterr().out


def test_synth_dataset_same_files_as_jax(tmp_path):
    """The port's copy of the color-mode generator writes the JAX
    package's files byte for byte from the same seed."""
    from yolo_from_scratch_tpu.utils.synth import make_dataset as jax_make
    from yolo_from_scratch_tpu_torch.utils.synth import make_dataset

    for maker, root in ((make_dataset, tmp_path / "port"),
                        (jax_make, tmp_path / "jax")):
        maker(root, n_train=3, n_val=2, img_size=64, seed=4, num_classes=2)
    port = sorted(p.relative_to(tmp_path / "port")
                  for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert len(port) == 11
    for rel in port:
        a, b = (tmp_path / "port" / rel), (tmp_path / "jax" / rel)
        if rel.name == "data.yaml":
            a_text = a.read_text().replace(str(tmp_path / "port"), "ROOT")
            assert a_text == b.read_text().replace(str(tmp_path / "jax"),
                                                   "ROOT")
        else:
            assert a.read_bytes() == b.read_bytes(), rel
