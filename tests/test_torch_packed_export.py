"""Frozen serving artifacts of a packed model (`--packed ... --export`,
float and `--int8`), on the CPU platform (the program's registered ops run
the plain versions of K1, Q1 and Q2 there), width 0.25, 128 px, nc=1.

Each artifact is read back in a fresh interpreter, which imports no model
module (`infer/artifact.py`), and serves the images there:

- its header says `"packed_stem": true` and its program takes the
  4x-packed batch (B, S/4, S/4, 48) float32, not the (B, S/2, S/2, 12)
  that the JAX package's `export_serving` declares (which its packed model
  cannot take: the JAX export of a packed config fails);
- its loader's staged batch is `pack_s2d_host` of the letterboxed batch;
- its detections on that batch equal the port's live packed
  `BatchPredictor` program's (rtol 1e-5, atol 1e-4:
  `tests/test_torch_export.py`'s bound), float and int8, and end to end on
  the images for int8 (its first rounding absorbs the loader's 255.0
  against the live path's INV255, as there);
- the float artifact's detections on the staged batch equal the JAX
  package's live packed `BatchPredictor` program's on it (the JAX package
  has no packed artifact to compare with): the keep masks bit for bit,
  boxes within 1e-3 px and scores within 1e-5
  (`tests/test_torch_packed_serve.py`'s bound for the live predictors).
  The int8 artifact's scores are held to JAX's live packed int8 predictor
  within 2e-3 (the bound of the int8 probabilities,
  `tests/test_torch_packed_int8.py`), box for box where both keep them.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_export import _assert_same, _dets
from test_torch_predict import _assert_same_detections

from yolo_from_scratch_tpu.infer.predict import (
    BatchPredictor as JaxBatchPredictor,
)
from yolo_from_scratch_tpu_torch import YoloConfig
from yolo_from_scratch_tpu_torch.data.letterbox import pack_s2d_host
from yolo_from_scratch_tpu_torch.infer.artifact import stage_images
from yolo_from_scratch_tpu_torch.infer.export import save_serving_artifact
from yolo_from_scratch_tpu_torch.infer.predict import BatchPredictor
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
# the live packed predictors' comparison's thresholds
# (`tests/test_torch_packed_serve.py`): at the gate of 1e-3 a thousand
# near-tied candidates reach NMS, where a 1e-7 score difference between
# the packages may flip a keep
KW = dict(conf_threshold=0.5, max_outputs=300)
P3 = dict(packed_stem=True, packed_interior=True, packed_p3=True)

# the fresh interpreter: each artifact's header, its program's input
# shape, its staged batch and its detections (on the staged batch and end
# to end)
READER = r"""
import io, json, sys
import numpy as np
import torch
from yolo_from_scratch_tpu_torch.infer.artifact import (
    load_serving_artifact, read_artifact)

torch.set_num_threads(1)
images, out = json.loads(sys.argv[1]), {}
for path in sys.argv[2:]:
    header, payload = read_artifact(path)
    prog = torch.export.load(io.BytesIO(payload))
    name = prog.graph_signature.user_inputs[0]
    node = next(n for n in prog.graph.nodes if n.name == name)
    art = load_serving_artifact(path)
    staged = art.stage(images)
    with torch.inference_mode():
        raw = art.run(*staged)
    out[path] = dict(header=header, shape=list(node.meta["val"].shape),
                     dtype=str(node.meta["val"].dtype),
                     staged=[t.tolist() for t in staged],
                     raw=[t.tolist() for t in raw], dets=art(images))
print(json.dumps(out))
"""


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Six test workers share the cores: torch's default threads would
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(temp_dataset_dir, tmp_path_factory):
    """The seeded weights (objectness near 0.5, as `tests/
    test_torch_predict.py` serves them), both artifacts of the packed p3
    config and what the fresh interpreter read from them."""
    torch.set_num_threads(1)
    cfg = YoloConfig(num_classes=1, img_size=128, width_mult=0.25,
                     depth_mult=0.33, **P3)
    variables = random_variables(YOLO(cfg, device="meta"), seed=0)
    for head in ("head_p3", "head_p4", "head_p5"):
        variables["params"][head]["pred"]["bias"].reshape(3, -1)[:, 4] += 4.6
    state = from_flax_variables(variables, YOLO(cfg, device="meta"))
    images = [str(p) for p in sorted(
        (temp_dataset_dir / "val" / "images").glob("*.jpg"))[:2]]
    tmp = tmp_path_factory.mktemp("packed_export")
    paths = {"float": str(tmp / "float.yexp"), "int8": str(tmp / "int8.yexp")}
    headers = {
        kind: save_serving_artifact(
            path, state, cfg, batch_size=2, platforms=["cpu"],
            quantize_calib=images if kind == "int8" else None, **KW)
        for kind, path in paths.items()}
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", READER, json.dumps(images),
                          *paths.values()], capture_output=True, text=True,
                         env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    read = json.loads(run.stdout)
    return dict(cfg=cfg, state=state, variables=variables, images=images,
                headers=headers,
                read={kind: read[p] for kind, p in paths.items()})


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_packed_artifact_header_and_input(setup, kind):
    got = setup["read"][kind]
    assert got["header"] == setup["headers"][kind]
    assert got["header"]["packed_stem"] is True
    assert got["header"]["int8"] is (kind == "int8")
    assert got["shape"] == [2, 32, 32, 48] and got["dtype"] == "torch.float32"
    staged = stage_images(setup["images"], 128, 2, CPU)
    want = pack_s2d_host(staged[0].numpy())
    np.testing.assert_array_equal(np.asarray(got["staged"][0], np.float32),
                                  want)
    for g, w in zip(got["staged"][1:], staged[1:]):
        np.testing.assert_array_equal(np.asarray(g, np.float32), w.numpy())


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_packed_artifact_matches_live_predictor(setup, kind):
    got = setup["read"][kind]
    live = BatchPredictor(setup["state"], setup["cfg"], device=CPU,
                          quantize_calib=(setup["images"] if kind == "int8"
                                          else None), **KW)
    staged = [torch.tensor(t, dtype=torch.float32) for t in got["staged"]]
    art_dets = _dets([torch.tensor(t) for t in got["raw"]], 2)
    _assert_same(art_dets, _dets(live.postprocess(*staged), 2))
    assert all(art_dets)
    if kind == "int8":
        _assert_same([[tuple(d) for d in ds] for ds in got["dets"]],
                     live(setup["images"]))


def test_packed_artifact_matches_jax_live_predictor(setup):
    got = setup["read"]["float"]
    ref = JaxBatchPredictor(setup["variables"], setup["cfg"], **KW)
    want = ref._post(setup["variables"], *(jnp.asarray(np.asarray(
        t, np.float32)) for t in got["staged"]))
    raw = [np.asarray(t) for t in got["raw"]]
    want = [np.asarray(t) for t in want]
    np.testing.assert_array_equal(raw[3], want[3])
    for i in range(2):
        dets = [[(*b, s, c) for b, s, c, v in zip(*(t[i] for t in out)) if v]
                for out in (raw, want)]
        assert dets[0]
        _assert_same_detections(*dets, box_tol=1e-3)


def test_packed_int8_artifact_near_jax_int8(setup):
    """Scores of the int8 artifact against the JAX package's live packed
    int8 predictor (calibrated on the same images): every box that both
    keep within 2e-3 of score, and most boxes kept by both."""
    got = setup["read"]["int8"]
    ref = JaxBatchPredictor(setup["variables"], setup["cfg"],
                            quantize_calib=setup["images"], **KW)
    want = ref(setup["images"])
    matched = total = 0
    for g, w in zip(got["dets"], want):
        w = np.asarray(w, np.float64).reshape(-1, 6)
        total += len(g)
        for d in g:
            near = np.all(np.abs(w[:, :4] - np.asarray(d[:4])) < 0.5, axis=1)
            if near.any():
                matched += 1
                assert np.abs(w[near, 4] - d[4]).min() < 2e-3
    assert total and matched >= 0.9 * total
