"""The port's CLI flags `--resume`, `--ema`, `--multi-scale` and `--augment`,
the multi-scale trainer in `fit`, and the shape mode of `utils/synth.py`,
against the JAX package's, on the CPU (nano model, 64-128 px).

- The four flags train instead of exiting 2; `--resume` prints the JAX
  CLI's resume line and its `WARNING: ... ignored on --resume` lines, and
  writes the checkpoint it resumed in place; the refusals (`--stream` with
  `--augment`, `--ema` or `--multi-scale`, `--compact-targets` with
  `--augment`) print the JAX CLI's message and exit 1, as it does.
- The multi-scale buckets are the JAX CLI's formula (0.75x / 1x / 1.25x,
  rounded to multiples of 32); `fit` trains epoch e with bucket e % 3,
  evaluates and checkpoints at the base size.
- Synth's shape mode writes the JAX package's files byte for byte for a
  seed (with distractors), as color mode does (tests/test_torch_eval.py).
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu import cli as jax_cli
from yolo_from_scratch_tpu_torch import YoloConfig, cli
from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
from yolo_from_scratch_tpu_torch.train.loop import fit
from yolo_from_scratch_tpu_torch.train.steps import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from yolo_from_scratch_tpu_torch.utils.checkpoint import read_payload

SMALL = ["--device", "cpu", "--size", "n", "--img-size", "64",
         "--batch-size", "2", "--lr", "1e-3"]
EPOCH = re.compile(r"^Epoch (\d+): Loss: ", re.M)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(capsys, argv):
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


def test_multi_scale_sizes_are_the_jax_formula():
    for size in range(32, 1281, 32):
        # yolo_from_scratch_tpu/cli.py's bucket expression
        want = sorted({max(32, round(size * f / 32) * 32)
                       for f in (0.75, 1.0, 1.25)})
        assert cli.multi_scale_sizes(size) == want, size
    assert cli.multi_scale_sizes(640) == [480, 640, 800]


def test_fit_rotates_buckets(temp_dataset_multiclass, tmp_path):
    """Four epochs over three buckets at base 128: the step and loader of
    bucket e % 3 train epoch e; evaluation sees the base size; the
    checkpoint keeps it."""
    root = temp_dataset_multiclass
    cfg = YoloConfig(num_classes=3, img_size=128, width_mult=0.25,
                     depth_mult=0.33)
    calls, evals = [], []

    def bucket(size):
        step = make_train_step(cfg.with_(img_size=size))

        def recorded(state, images, targets):
            calls.append((size, images.shape[1]))
            return step(state, images, targets)

        loader = DataLoader(YoloDataset(str(root / "train" / "images"), 3,
                                        cfg.anchors_array, size),
                            batch_size=2, prefetch=0)
        return recorded, loader

    def evaluate(model, images, targets):
        evals.append(images.shape[1])
        return make_eval_step(cfg)(model, images, targets)

    sizes = cli.multi_scale_sizes(cfg.img_size)
    assert sizes == [96, 128, 160]
    val = DataLoader(YoloDataset(str(root / "val" / "images"), 3,
                                 cfg.anchors_array, 128), batch_size=2)
    state = create_train_state(cfg, 1e-3, seed=0, device="cpu")
    state, path = fit(state, None, evaluate, None, val, cfg, device="cpu",
                      epochs=4, warmup_epochs=0, save_path=tmp_path / "m.ckpt",
                      log=lambda *_: None,
                      multi_scale=[bucket(s) for s in sizes])
    epochs = [s for s, _ in calls[::2]]  # 2 steps an epoch
    assert epochs == [96, 128, 160, 96]
    assert all(size == side for size, side in calls)
    assert set(evals) == {128} and state.step == 8
    assert read_payload(path)["img_size"] == 128


@pytest.mark.parametrize("flag", [["--ema"], ["--augment"],
                                  ["--multi-scale"], ["--resume"]],
                         ids=lambda f: f[0])
def test_flags_train_instead_of_exit_2(flag, temp_dataset_multiclass,
                                       tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    data = str(temp_dataset_multiclass / "dataset.yaml")
    if flag != ["--resume"]:
        rc, out = _run(capsys, [data, *SMALL, "--epochs", "1", *flag])
        assert rc == 0, out
        assert EPOCH.findall(out) == ["1"]
        if flag == ["--multi-scale"]:
            # 64's buckets: 0.75x and 1.25x round back to 64
            assert "Multi-scale buckets: [64] (epoch-rotated)" in out
        saved = re.search(r"Model saved to (\S+)", out).group(1)
        payload = read_payload(tmp_path / saved)
        assert ("raw_params" in payload["extra"]) == (flag == ["--ema"])
        return
    rc, out = _run(capsys, [data, *SMALL, "--epochs", "1", "--ema"])
    saved = str(tmp_path / re.search(r"Model saved to (\S+)", out).group(1))
    rc, out = _run(capsys, [data, *SMALL[:4], "--img-size", "96",
                            "--head", "anchor_free", *SMALL[6:], "--epochs",
                            "2", "--ema", "--resume", saved])
    assert rc == 0, out
    lines = out.splitlines()
    assert f"Resuming from {saved} at epoch 2" in lines
    assert ("WARNING: --img-size 96 ignored on --resume; checkpoint uses 64"
            in lines)
    assert ("WARNING: --head 'anchor_free' ignored on --resume; checkpoint "
            "uses 'anchor'" in lines)
    assert EPOCH.findall(out) == ["2"]
    assert f"Model saved to {saved}" in out
    payload = read_payload(saved)
    assert payload["extra"]["step"] == 4 and payload["epoch"] == 1
    assert payload["img_size"] == 64 and payload["head_type"] == "anchor"


REFUSALS = [["--stream", "--augment"], ["--stream", "--ema"],
            ["--stream", "--multi-scale"], ["--compact-targets", "--augment"]]


@pytest.mark.parametrize("flags", REFUSALS, ids=" ".join)
def test_refusals_equal_jax(flags, temp_dataset_multiclass, tmp_path,
                            monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    data = str(temp_dataset_multiclass / "dataset.yaml")
    argv = [data, "--size", "n", "--img-size", "64", *flags]
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as info:
        jax_cli.main(argv)
    want = [line for line in out.getvalue().splitlines()
            if line.startswith("ERROR")]
    rc, got = _run(capsys, [*argv, "--device", "cpu"])
    assert rc == info.value.code == 1
    assert [line for line in got.splitlines()
            if line.startswith("ERROR")] == want and len(want) == 1


def test_synth_shape_mode_same_files_as_jax(tmp_path):
    from yolo_from_scratch_tpu.utils.synth import make_dataset as jax_make
    from yolo_from_scratch_tpu_torch.utils import synth

    kw = dict(n_train=4, n_val=2, img_size=96, seed=11, num_classes=12,
              class_mode="shape", n_distract=2)
    for maker, root in ((synth.make_dataset, tmp_path / "port"),
                        (jax_make, tmp_path / "jax")):
        maker(root, **kw)
    port = sorted(p.relative_to(tmp_path / "port")
                  for p in (tmp_path / "port").rglob("*") if p.is_file())
    jax_files = sorted(p.relative_to(tmp_path / "jax")
                       for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert port == jax_files and len(port) == 13
    for rel in port:
        a, b = (tmp_path / "port" / rel).read_bytes(), (
            tmp_path / "jax" / rel).read_bytes()
        if rel.name == "data.yaml":  # the roots differ
            a = a.replace(str(tmp_path / "port").encode(), b"")
            b = b.replace(str(tmp_path / "jax").encode(), b"")
        assert a == b, rel
    # every class is a shape x texture pair, drawn in any colour
    for c in (0, 9, 79):
        patch, mask = synth.render_class_patch(
            c, 24, 30, (200, 100, 50), np.random.default_rng(0))
        assert patch.shape == (24, 30, 3) and mask.shape == (24, 30)
    with pytest.raises(ValueError, match="shape mode"):
        synth.make_dataset(tmp_path / "x", num_classes=81,
                           class_mode="shape")
