"""Frozen serving artifacts of the port (`infer/export.py`,
`infer/artifact.py`), the counterparts of tests/test_export.py, on the CPU
at the tier-1 test config (the 'cpu' platform: the program calls the
registered ops, which run the plain versions there).

Tolerances, and why:

- artifact vs the live `BatchPredictor`'s program on the same staged
  batch: rtol 1e-5, atol 1e-4 (tests/test_export.py's), same count. The
  artifact's loader divides by 255.0 as the JAX package's does, the live
  path multiplies by INV255; the two inputs can differ by an ulp, which at
  random weights can flip an NMS decision among near-tied boxes, so the
  float program is held on the loader's own staged batch. The int8 program
  absorbs that ulp in its first rounding and is also held end to end on
  the images.
- the CLI against the JAX CLI on one checkpoint: the same lines, each
  detection's printed numbers within their print precision (0.1 px,
  0.001), the forwards agreeing to ~1e-6.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu import cli as jax_cli
from yolo_from_scratch_tpu.infer.export import MAGIC as JAX_MAGIC
from yolo_from_scratch_tpu.infer.export import (
    load_serving_artifact as jax_load_serving_artifact,
)
from yolo_from_scratch_tpu.utils import checkpoint as jax_ckpt
from yolo_from_scratch_tpu_torch import YoloConfig, cli
from yolo_from_scratch_tpu_torch.infer.export import (
    MAGIC,
    check_platforms,
    export_serving,
    load_serving_artifact,
    save_serving_artifact,
)
from yolo_from_scratch_tpu_torch.infer.predict import BatchPredictor
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import nms_cuda, quant
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)

REPO_ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
KW = dict(conf_threshold=1e-3, max_outputs=512)


@pytest.fixture(scope="module")
def port_cfg():
    torch.set_num_threads(1)
    return YoloConfig(num_classes=1, img_size=128, width_mult=0.25,
                      depth_mult=0.33)


@pytest.fixture(scope="module")
def state(port_cfg):
    return from_flax_variables(random_variables(YOLO(port_cfg, device="meta"),
                                                seed=0),
                               YOLO(port_cfg, device="meta"))


@pytest.fixture(scope="module")
def images(temp_dataset_dir):
    return [str(p) for p in
            sorted((temp_dataset_dir / "val" / "images").glob("*.jpg"))[:3]]


@pytest.fixture(scope="module")
def artifact_path(port_cfg, state, tmp_path_factory):
    path = tmp_path_factory.mktemp("export") / "model.yexp"
    save_serving_artifact(path, state, port_cfg, batch_size=2,
                          platforms=["cpu"], **KW)
    return path


def _assert_same(got, want):
    assert len(got) == len(want)
    for ds, db in zip(got, want):
        assert len(ds) == len(db)
        a, b = np.asarray(sorted(ds)), np.asarray(sorted(db))
        if len(a):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)


def _dets(out, n):
    from yolo_from_scratch_tpu_torch.infer.detections import (
        detections_per_image,
    )

    return detections_per_image(*(t.cpu() for t in out), n)


def test_artifact_matches_live_predictor(port_cfg, state, images,
                                         artifact_path):
    live = BatchPredictor(state, port_cfg, device=CPU, **KW)
    art = load_serving_artifact(artifact_path)
    staged = art.stage(images[:2])
    before = nms_cuda.launches
    got = _dets(art.run(*staged), 2)
    assert nms_cuda.launches == before  # the CPU program: plain versions
    _assert_same(got, _dets(live.postprocess(*staged), 2))
    assert all(got)


def test_int8_artifact_roundtrip(port_cfg, state, images, tmp_path):
    """The frozen int8 program (calibrated on the images) equals the live
    int8 `BatchPredictor`, on the staged batch and end to end."""
    path = tmp_path / "int8.yexp"
    header = save_serving_artifact(path, state, port_cfg, batch_size=2,
                                   platforms=["cpu"],
                                   quantize_calib=images[:2], **KW)
    assert header["int8"] is True
    art = load_serving_artifact(path)
    assert art.meta["int8"] is True
    live = BatchPredictor(state, port_cfg, device=CPU,
                          quantize_calib=images[:2], **KW)
    staged = art.stage(images[:2])
    _assert_same(_dets(art.run(*staged), 2),
                 _dets(live.postprocess(*staged), 2))
    _assert_same(art(images[:2]), live(images[:2]))
    assert quant.conv_launches == 0 and quant.quant_launches == 0


def test_artifact_partial_batch_padding(images, artifact_path):
    """One image through a batch-2 artifact: the padded row is dropped and
    the image's detections are those of a full batch's row 0."""
    art = load_serving_artifact(artifact_path)
    out = art(images[:1])
    assert len(out) == 1
    assert out[0] == art(images[:2])[0]


def test_artifact_rejects_oversize_batch(images, artifact_path):
    art = load_serving_artifact(artifact_path)
    with pytest.raises(ValueError, match="frozen batch size"):
        art(images[:3])


def test_artifact_meta_roundtrip(port_cfg, artifact_path):
    """The header has the JAX artifact's keys, `cuda_nms` in place of
    `pallas_nms`."""
    m = load_serving_artifact(artifact_path).meta
    assert set(m) == {"format", "batch_size", "img_size", "num_classes",
                      "packed_stem", "head_type", "conf_threshold",
                      "iou_threshold", "topk", "max_outputs", "platforms",
                      "cuda_nms", "int8"}
    assert m["batch_size"] == 2 and m["img_size"] == port_cfg.img_size
    assert m["num_classes"] == port_cfg.num_classes
    assert m["head_type"] == "anchor" and m["packed_stem"] is False
    assert m["platforms"] == ["cpu"] and m["cuda_nms"] is False
    assert m["topk"] == 3 * (16 ** 2 + 8 ** 2 + 4 ** 2)
    assert m["max_outputs"] == 512 and m["int8"] is False


def test_bad_magic_rejected_both_ways(tmp_path, artifact_path):
    """The port's loader refuses junk ("bad magic") and names a JAX
    artifact as one; the JAX package's loader refuses the port's file."""
    junk = tmp_path / "junk.yexp"
    junk.write_bytes(b"NOTANARTIFACT" + b"\0" * 64)
    with pytest.raises(ValueError, match="bad magic"):
        load_serving_artifact(junk)
    jax_file = tmp_path / "jax.yexp"
    jax_file.write_bytes(JAX_MAGIC + b"\x02\0\0\0{}" + b"\0" * 64)
    with pytest.raises(ValueError, match="jax.export artifact"):
        load_serving_artifact(jax_file)
    assert MAGIC != JAX_MAGIC and not MAGIC.startswith(JAX_MAGIC)
    with pytest.raises(ValueError, match="bad magic"):
        jax_load_serving_artifact(artifact_path)


SELF_CONTAINED = """
import sys
from yolo_from_scratch_tpu_torch.infer.artifact import load_serving_artifact

art = load_serving_artifact(sys.argv[1])
out = art([sys.argv[2]])
assert isinstance(out, list) and len(out) == 1 and out[0], out
loaded = sorted(m for m in sys.modules
                if m.startswith("yolo_from_scratch_tpu_torch.models")
                or m.split(".")[0] in ("jax", "jaxlib", "flax",
                                       "yolo_from_scratch_tpu"))
print("LOADED", loaded)
"""


def test_artifact_is_selfcontained(artifact_path, images):
    """A fresh interpreter serves from the file with torch and the port's
    registered ops alone: no model module, no jax, nothing of the JAX
    package."""
    result = subprocess.run(
        [sys.executable, "-c", SELF_CONTAINED, str(artifact_path),
         images[0]], capture_output=True, text=True, timeout=300,
        cwd=REPO_ROOT)
    assert result.returncode == 0, result.stderr
    assert "LOADED []" in result.stdout, result.stdout


@pytest.mark.parametrize("platforms,match", [
    (["cuda", "cpu"], "one program for one platform"),
    (["tpu"], "JAX package's jax.export"),
    (["tpu", "cpu"], "JAX package's jax.export"),
    (["rocm"], "unknown platform")])
def test_platform_lists_refused(port_cfg, state, platforms, match):
    with pytest.raises(ValueError, match=match):
        export_serving(state, port_cfg, 2, platforms=platforms)
    assert check_platforms(None) == "cuda"
    assert check_platforms(["cpu"]) == "cpu"


@pytest.fixture(scope="module")
def served_ckpt(port_cfg, tmp_path_factory):
    """A JAX-package checkpoint of seeded weights whose objectness bias is
    raised by 4.6, so the CLI's gate of 0.5 keeps detections
    (tests/test_torch_predict.py's `served`)."""
    from yolo_from_scratch_tpu.config import YoloConfig as JaxConfig

    v = random_variables(YOLO(port_cfg, device="meta"), seed=0)
    for head in ("head_p3", "head_p4", "head_p5"):
        v["params"][head]["pred"]["bias"].reshape(3, -1)[:, 4] += 4.6
    path = tmp_path_factory.mktemp("served") / "served.ckpt"
    jax_ckpt.save_checkpoint(path, v, JaxConfig(
        num_classes=1, img_size=128, width_mult=0.25, depth_mult=0.33))
    return path


DET = re.compile(r"  \d+\. Box: \(([-\d.]+), ([-\d.]+), ([-\d.]+), "
                 r"([-\d.]+)\), Confidence: ([\d.]+), Class: (\d+)")


def _split(lines):
    """(lines without detections, sorted detection numbers)."""
    rest = [ln for ln in lines if not DET.fullmatch(ln)]
    dets = sorted(tuple(float(g) for g in DET.fullmatch(ln).groups())
                  for ln in lines if DET.fullmatch(ln))
    return rest, np.asarray(dets)


def test_cli_lines_match_jax(served_ckpt, images, tmp_path, capsys):
    """Export, inspect and artifact inference through the port's CLI print
    the JAX CLI's lines on the same checkpoint: `nms cuda`/`plain` in place
    of `pallas`/`lax`, `cuda_nms` in place of `pallas_nms`."""
    jax_art, port_art = tmp_path / "jax.yexp", tmp_path / "port.yexp"
    jax_cli.main([str(served_ckpt), "--export", str(jax_art),
                  "--export-platforms", "cpu"])
    want = capsys.readouterr().out.splitlines()
    assert cli.main([str(served_ckpt), "--export", str(port_art),
                     "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    exported = r"Exported {} -> {} \([\d,]+ bytes\)"
    assert re.fullmatch(exported.format(re.escape(str(served_ckpt)),
                                        re.escape(str(jax_art))), want[1])
    assert re.fullmatch(exported.format(re.escape(str(served_ckpt)),
                                        re.escape(str(port_art))), got[1])
    assert got[0] == want[0] and len(got) == len(want) == 3
    assert got[2] == want[2].replace("nms lax", "nms plain")

    jax_cli.main([str(jax_art)])
    want = capsys.readouterr().out.splitlines()
    assert cli.main([str(port_art)]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0].replace("jax.yexp", "port.yexp")
    assert got[1:] == sorted(got[1:])  # sorted by key, as the JAX CLI's
    assert sorted(got[1:]) == sorted(
        ln.replace("pallas_nms", "cuda_nms") for ln in want[1:])

    jax_cli.main([images[0], str(jax_art)])
    want, want_dets = _split(capsys.readouterr().out.splitlines())
    assert cli.main([images[0], str(port_art)]) == 0
    got, got_dets = _split(capsys.readouterr().out.splitlines())
    assert got == [ln.replace("jax.yexp", "port.yexp") for ln in want]
    assert len(got_dets) == len(want_dets) > 0
    np.testing.assert_allclose(got_dets[:, :4], want_dets[:, :4], rtol=0,
                               atol=0.1 + 1e-6)
    np.testing.assert_allclose(got_dets[:, 4:], want_dets[:, 4:], rtol=0,
                               atol=1e-3 + 1e-9)


def test_cli_export_int8_needs_yaml(served_ckpt, tmp_path, capsys):
    """`--export --int8` without a YAML exits 1 with the JAX CLI's
    message; a multi-platform list exits 1 and says why."""
    assert cli.main([str(served_ckpt), "--export", str(tmp_path / "a.yexp"),
                     "--int8", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "ERROR: --export --int8 needs a dataset YAML" in out
    assert cli.main([str(served_ckpt), "--export", str(tmp_path / "b.yexp"),
                     "--export-platforms", "cuda,cpu"]) == 1
    assert "one program for one platform" in capsys.readouterr().out
    assert not (tmp_path / "a.yexp").exists()


@pytest.fixture(scope="module")
def random_ckpt(port_cfg, tmp_path_factory):
    """A JAX-package checkpoint of the seeded weights as they are (the
    objectness prior keeps every score under the CLI's gate)."""
    from yolo_from_scratch_tpu.config import YoloConfig as JaxConfig

    v = random_variables(YOLO(port_cfg, device="meta"), seed=0)
    path = tmp_path_factory.mktemp("random") / "random.ckpt"
    jax_ckpt.save_checkpoint(path, v, JaxConfig(
        num_classes=1, img_size=128, width_mult=0.25, depth_mult=0.33))
    return path


def test_cli_int8_request_lines_match_jax(random_ckpt, images, capsys):
    """`image.jpg model.ckpt --int8` (calibrated on the image) prints the
    JAX CLI's lines."""
    jax_cli.main([images[0], str(random_ckpt), "--int8"])
    want = capsys.readouterr().out.splitlines()
    before = (quant.quant_launches, quant.conv_launches)
    assert cli.main([images[0], str(random_ckpt), "--int8", "--device",
                     "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got == want[1:]  # the JAX CLI's "Creating YOLOv5S" line first
    assert want[0].startswith("Creating YOLOv5")
    assert got[-1] == "No objects detected."
    assert (quant.quant_launches, quant.conv_launches) == before


def test_cli_map_int8_calibrates_on_train_images(temp_dataset_dir,
                                                 random_ckpt, monkeypatch,
                                                 capsys):
    """`data.yaml model.ckpt --map --int8` serves the int8 model
    calibrated on the first 16 train-split images, the JAX CLI's list,
    and prints the mAP lines for both splits."""
    from yolo_from_scratch_tpu.data.dataset import YoloDataset as JaxDataset
    from yolo_from_scratch_tpu_torch.infer import predict

    seen = []

    class Spy(predict.BatchPredictor):
        def __init__(self, *args, **kwargs):
            seen.append(kwargs.get("quantize_calib"))
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(predict, "BatchPredictor", Spy)
    yaml_file = str(temp_dataset_dir / "dataset.yaml")
    assert cli.main([yaml_file, str(random_ckpt), "--map", "--int8",
                     "--device", "cpu", "--batch-size", "2"]) == 0
    out = capsys.readouterr().out
    want = JaxDataset(str(temp_dataset_dir / "train" / "images"), 1,
                      img_size=128).imgs[:16]
    assert seen == [[str(p) for p in want]]
    assert len(re.findall(r"  mAP@0\.5: \d+\.\d\d%", out)) == 2
    assert len(re.findall(r"  mAP@\[\.5:\.95\]: \d+\.\d\d%", out)) == 2
