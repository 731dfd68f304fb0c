"""The port's CLI under `--packed` and its aliases, on the CPU (width 0.25,
64 px, batch 2, one epoch a run): the JAX CLI's conflict error, the
compositions not ported yet (ROADMAP A10b) exiting 2 with both flags
named, and the packed layouts through training (eager, `--stream` with a
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


@pytest.mark.parametrize("argv,flags", [
    (["img.jpg", "m.ckpt", "--packed", "p3", "--int8"],
     ("--packed p3", "--int8")),
    (["m.ckpt", "--packed-stem", "--export", "m.yexp"],
     ("--packed-stem", "--export")),
    (["data.yaml", "--packed-interior", "--data-parallel",
      "--model-parallel", "2"], ("--packed-interior", "--model-parallel")),
    (["data.yaml", "--packed", "stem", "--data-parallel", "--spatial", "2"],
     ("--packed stem", "--spatial"))])
def test_unported_compositions_exit_2(argv, flags, capsys):
    rc, out, _ = _main(argv, capsys)
    assert rc == 2
    assert all(f in out for f in flags) and "A10b" in out


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
