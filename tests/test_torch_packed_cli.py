"""The port's CLI under `--packed` and its aliases, on the CPU (width 0.25,
64 px, batch 2, one epoch a run): the JAX CLI's conflict error, the four
compositions with `--int8`, `--export`, `--model-parallel 2` and
`--spatial 2` (two gloo processes each) running on the packed model, and
the packed layouts through training (eager, `--stream` with a
packed cache, `--stream-pool`, `--resume` across layouts, `--augment`,
`--ema`, `--multi-scale`, `--device-mosaic`, two `--distributed`
processes), evaluation with `--map`, and inference, both heads.
"""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from yolo_from_scratch_tpu import cli as jax_cli
from yolo_from_scratch_tpu_torch import cli

REPO = Path(__file__).resolve().parent.parent
RUN = ["--device", "cpu", "--size", "n", "--img-size", "64",
       "--batch-size", "2", "--epochs", "1"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Six test workers share the cores: torch's default threads would
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _main(argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _ckpt(out):
    return re.search(r"Model saved to (\S+\.ckpt)", out).group(1)


@pytest.mark.parametrize("argv", [["--packed", "p3", "--packed-stem"],
                                  ["--packed", "none", "--packed-p3"],
                                  ["--packed", "stem", "--packed-interior"]])
def test_conflicting_flags_fail_with_the_jax_message(argv, capsys):
    with pytest.raises(SystemExit) as jax_exit:
        jax_cli.main(["data.yaml", *argv])
    rc, out, err = _main(["data.yaml", *argv], capsys)
    assert rc == 1
    assert err.strip() == str(jax_exit.value)
    assert "conflicting packing flags" in err


@pytest.fixture(scope="module")
def served_ckpt(tmp_path_factory):
    """A JAX-package checkpoint (width 0.25, 64 px, nc=1) of seeded weights
    whose objectness bias is raised by 4.6, so that the CLI's gate of 0.5
    keeps detections (`tests/test_torch_export.py`'s `served_ckpt`)."""
    from yolo_from_scratch_tpu.config import YoloConfig as JaxConfig
    from yolo_from_scratch_tpu.utils import checkpoint as jax_ckpt
    from yolo_from_scratch_tpu_torch import YoloConfig
    from yolo_from_scratch_tpu_torch.models.yolo import YOLO
    from yolo_from_scratch_tpu_torch.utils.convert import random_variables

    kw = dict(num_classes=1, img_size=64, width_mult=0.25, depth_mult=0.33)
    v = random_variables(YOLO(YoloConfig(**kw), device="meta"), seed=0)
    for head in ("head_p3", "head_p4", "head_p5"):
        v["params"][head]["pred"]["bias"].reshape(3, -1)[:, 4] += 4.6
    path = tmp_path_factory.mktemp("served") / "served.ckpt"
    jax_ckpt.save_checkpoint(path, v, JaxConfig(**kw))
    return path


def _two_ranks(argv, cwd):
    """`train_torch.py argv` in two gloo processes over a localhost
    coordinator: each rank's stdout."""
    base = [sys.executable, str(REPO / "train_torch.py"), *argv,
            "--distributed", "--coordinator", f"127.0.0.1:{_free_port()}",
            "--num-processes", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(base + ["--process-id", str(r)], cwd=cwd,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return outs


def _epoch(out):
    """An epoch line without its throughput."""
    return re.search(r"Epoch 1: .* \| LR: \S+", out).group(0)


@pytest.mark.parametrize("argv,flags", [
    (["img.jpg", "m.ckpt", "--packed", "p3", "--int8"],
     ("--packed p3", "--int8")),
    (["m.ckpt", "--packed-stem", "--export", "m.yexp"],
     ("--packed-stem", "--export")),
    (["data.yaml", "--packed-interior", "--data-parallel",
      "--model-parallel", "2"], ("--packed-interior", "--model-parallel")),
    (["data.yaml", "--packed", "stem", "--data-parallel", "--spatial", "2"],
     ("--packed stem", "--spatial"))])
def test_unported_compositions_exit_2(argv, flags, served_ckpt,
                                      temp_dataset_dir, tmp_path,
                                      monkeypatch, capsys):
    """The four compositions that exited 2 before they were ported now
    run to 0 on the packed model, neither naming ROADMAP A10b nor serving
    the unpacked model: `--packed p3 --int8` prints the JAX CLI's lines
    and the port's packed int8 `Predictor`'s detections; `--packed-stem
    --export` writes a packed artifact that the CLI serves as the live
    packed `BatchPredictor` does; the two mesh compositions train in two
    gloo processes to one process's epoch line, rank 0's checkpoint
    holding the whole canonical model (which `--resume` under the model
    mesh continues); `--packed p3 --int8` also runs `--map` and
    `--export`. The test keeps the name it had while these compositions
    exited 2, so that its cases stay the same test IDs."""
    from yolo_from_scratch_tpu_torch.infer.artifact import (
        load_serving_artifact,
    )
    from yolo_from_scratch_tpu_torch.infer.predict import (
        BatchPredictor,
        Predictor,
    )
    from yolo_from_scratch_tpu_torch.utils.checkpoint import load_checkpoint

    monkeypatch.chdir(tmp_path)
    image = str(sorted((temp_dataset_dir / "val" / "images").glob(
        "*.jpg"))[0])
    yaml_file = str(temp_dataset_dir / "dataset.yaml")
    sub = {"img.jpg": image, "m.ckpt": str(served_ckpt),
           "data.yaml": yaml_file, "m.yexp": str(tmp_path / "m.yexp")}
    argv = [sub.get(a, a) for a in argv]
    state, cfg, _ = load_checkpoint(served_ckpt)
    if "--int8" in argv:
        rc, out, _ = _main([*argv, "--device", "cpu"], capsys)
        assert rc == 0
        jax_cli.main(argv)
        want = capsys.readouterr().out.splitlines()
        got = out.splitlines()
        pcfg = cfg.with_(packed_stem=True, packed_interior=True,
                         packed_p3=True)
        dets = Predictor(state, pcfg, device="cpu",
                         quantize_calib=[image])(image)
        assert dets
        lines = [f"  {i + 1}. Box: ({d[0]:.1f}, {d[1]:.1f}, {d[2]:.1f}, "
                 f"{d[3]:.1f}), Confidence: {d[4]:.3f}, Class: {int(d[5])}"
                 for i, d in enumerate(dets)]
        assert got[-len(lines):] == lines
        # the lines before the detections: the JAX CLI's after its model
        # banner, up to the count
        assert want[0].startswith("Creating YOLOv5")
        start = [ln for ln in got if not ln.startswith(("  ", "Detected"))]
        assert start == [ln for ln in want[1:]
                         if not ln.startswith(("  ", "Detected"))]
        # --map and --export of the packed int8 model run too
        rc, out, _ = _main([yaml_file, str(served_ckpt), "--device", "cpu",
                            "--packed", "p3", "--int8", "--map",
                            "--batch-size", "2"], capsys)
        assert rc == 0
        assert len(re.findall(r"  mAP@0\.5: \d+\.\d\d%", out)) == 2
        rc, out, _ = _main([yaml_file, str(served_ckpt), "--device", "cpu",
                            "--packed", "p3", "--export", sub["m.yexp"],
                            "--int8"], capsys)
        assert rc == 0 and out.strip().splitlines()[-1].endswith(", int8")
        meta = load_serving_artifact(sub["m.yexp"]).meta
        assert meta["packed_stem"] is True and meta["int8"] is True
    elif "--export" in argv:
        rc, out, _ = _main([*argv, "--device", "cpu"], capsys)
        assert rc == 0 and "Exported" in out
        art = load_serving_artifact(sub["m.yexp"])
        assert art.meta["packed_stem"] is True
        assert tuple(art.stage([image])[0].shape) == (8, 16, 16, 48)
        rc, out, _ = _main([image, sub["m.yexp"]], capsys)
        assert rc == 0
        live = BatchPredictor(state, cfg.with_(packed_stem=True),
                              device="cpu")([image])[0]
        assert live and f"Detected {len(live)} object(s):" in out
        for i, d in enumerate(live):
            assert (f"  {i + 1}. Box: ({d[0]:.1f}, {d[1]:.1f}, {d[2]:.1f}, "
                    f"{d[3]:.1f}), Confidence: {d[4]:.3f}") in out
    else:
        ranks = _two_ranks([*argv, *RUN], tmp_path)
        mesh = ("2-D mesh: data=1 x model=2" if "--model-parallel" in argv
                else "2-D mesh: data=1 x space=2")
        assert all(mesh in out for out in ranks)
        assert _epoch(ranks[0]) == _epoch(ranks[1])
        one = [a for a in argv if a not in ("--data-parallel", "2",
                                            "--model-parallel", "--spatial")]
        rc, out, _ = _main([*one, *RUN], capsys)
        assert rc == 0 and _epoch(out) == _epoch(ranks[0])
        # rank 0's checkpoint holds the whole canonical model, as one
        # process's does (the model mesh's slices gathered)
        mesh_ckpt = tmp_path / _ckpt(ranks[0])
        mesh_state = load_checkpoint(mesh_ckpt)[0]
        one_state = load_checkpoint(tmp_path / _ckpt(out))[0]
        assert {k: v.shape for k, v in mesh_state.items()} == {
            k: v.shape for k, v in one_state.items()}
        if "--model-parallel" in argv:
            # --resume slices the full-size checkpoint onto the cut model
            resumed = _two_ranks([*argv, *RUN[:-1], "2", "--resume",
                                  str(mesh_ckpt)], tmp_path)
            assert f"Resuming from {mesh_ckpt} at epoch 2" in resumed[0]
            assert len({re.search(r"Epoch 2: .* \| LR: \S+", o).group(0)
                        for o in resumed}) == 1
    assert "A10b" not in out and all(f.split()[0] in " ".join(argv)
                                     for f in flags)


def test_auto_is_unpacked_and_none_composes(capsys):
    args = cli.build_parser().parse_args(["--int8"])
    assert cli._resolve_packing(args) is None
    assert args.packed == "none" and not any(args.layout.values())
    args = cli.build_parser().parse_args(["--packed-p3"])
    assert cli._resolve_packing(args) is None
    assert args.packed == "p3" and all(args.layout.values())


@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
def test_packed_train_resume_eval_infer(head, temp_dataset_dir, tmp_path,
                                        monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    yaml_file = str(temp_dataset_dir / "dataset.yaml")
    image = str(sorted((temp_dataset_dir / "val" / "images").glob(
        "*.jpg"))[0])
    rc, out, _ = _main([yaml_file, *RUN, "--head", head, "--packed", "p3",
                        "--val-det"], capsys)
    assert rc == 0 and " | Det: P " in out
    ckpt = _ckpt(out)
    # a packed checkpoint resumes unpacked, and then packed again
    rc, out, _ = _main([yaml_file, *RUN[:-1], "2", "--resume", ckpt], capsys)
    assert rc == 0 and f"Resuming from {ckpt} at epoch 2" in out
    rc, out, _ = _main([yaml_file, *RUN[:-1], "3", "--resume", ckpt,
                        "--packed-stem"], capsys)
    assert rc == 0 and f"Resuming from {ckpt} at epoch 3" in out
    rc, out, _ = _main([yaml_file, ckpt, "--device", "cpu", "--map",
                        "--batch-size", "2", "--packed", "p3"], capsys)
    assert rc == 0 and "mAP@0.5:" in out
    rc, out, _ = _main([image, ckpt, "--device", "cpu", "--packed", "p3"],
                       capsys)
    assert rc == 0 and f"Running inference on {image}" in out


def test_packed_stream_and_pool(temp_dataset_dir, tmp_path, monkeypatch,
                                capsys):
    monkeypatch.chdir(tmp_path)
    yaml_file = str(temp_dataset_dir / "dataset.yaml")
    cache = tmp_path / "cache"
    rc, out, _ = _main([yaml_file, *RUN, "--packed", "p3", "--stream",
                        "--stream-chunk", "2", "--compact-targets",
                        "--device-mosaic", "--device-augment",
                        "--sparse-loss", "--cache-dir", str(cache)], capsys)
    assert rc == 0, out
    meta = json.loads((cache / "meta.json").read_text())
    assert meta["packed"] and meta["image_shape"] == [16, 16, 48]
    rc, out, _ = _main([yaml_file, *RUN, "--packed-interior", "--stream",
                        "--stream-pool", "4", "--compact-targets", "--head",
                        "anchor_free", "--cache-dir", str(cache)], capsys)
    assert rc == 0 and "ingest" in out


def test_packed_recipe(temp_dataset_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rc, out, _ = _main([str(temp_dataset_dir / "dataset.yaml"), *RUN,
                        "--img-size", "96", "--packed", "stem", "--augment",
                        "--ema", "--multi-scale"], capsys)
    assert rc == 0 and "Multi-scale buckets: [64, 96, 128]" in out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_packed_two_processes(temp_dataset_dir, tmp_path):
    """--packed p3 --distributed over two gloo processes, the device mosaic
    drawing partners from the gathered packed batch: one epoch line, the
    same on both ranks."""
    base = [sys.executable, str(REPO / "train_torch.py"),
            str(temp_dataset_dir / "dataset.yaml"), *RUN, "--packed", "p3",
            "--compact-targets", "--device-mosaic", "--distributed",
            "--coordinator", f"127.0.0.1:{_free_port()}",
            "--num-processes", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(base + ["--process-id", str(r)], cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    lines = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            lines.append(re.search(r"Epoch 1: .* \| LR: ", out).group(0))
    finally:
        for p in procs:
            p.kill()
    assert lines[0] == lines[1]
