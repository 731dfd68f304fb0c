"""The port's viewer (`eval_torch.py`) against the JAX package's
(`eval.py`): `tests/test_viewer.py`'s five headless checks of the frame
composition on the port's module, the frames of both pixel-equal for the
same inputs, `load_ground_truth` equal, and the viewer's main loop drawing
a request of the port's `Predictor` on the CPU."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

cv2 = pytest.importorskip("cv2")

import eval as jax_viewer  # noqa: E402
import eval_torch  # noqa: E402
from eval_torch import (  # noqa: E402
    GT_COLOR,
    LEGEND_HEIGHT,
    PANEL_HEIGHT,
    PRED_COLOR,
    compose_frame,
    load_ground_truth,
)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    gt = [(0, 50.0, 50.0, 120.0, 120.0), (1, 200.5, 10.2, 300.9, 90.7)]
    dets = [(60.0, 60.0, 130.0, 130.0, 0.87, 0),
            (210.4, 20.6, 290.1, 88.8, 0.512, 1)]
    return img, gt, dets, ["cone", "ball"]


def _frame():
    img = np.zeros((240, 320, 3), np.uint8)
    gt = [(0, 50.0, 50.0, 120.0, 120.0)]
    dets = [(60.0, 60.0, 130.0, 130.0, 0.87, 0)]
    return compose_frame(img, gt, dets, ["cone"], idx=2, total=10,
                         split="val", filename="x.jpg")


def test_frame_has_panel_and_legend():
    frame = _frame()
    assert frame.shape == (240 + PANEL_HEIGHT + LEGEND_HEIGHT, 320, 3)
    assert (frame[0, 0] == 40).all()
    assert (frame[-1, -1] == 40).all()


def test_legend_has_both_colors():
    legend = _frame()[-LEGEND_HEIGHT:]
    assert (legend == np.array(GT_COLOR, np.uint8)).all(axis=-1).any()
    assert (legend == np.array(PRED_COLOR, np.uint8)).all(axis=-1).any()


def test_panel_contains_text_pixels():
    panel = _frame()[:PANEL_HEIGHT]
    assert (panel == 255).all(axis=-1).any()


def test_boxes_drawn_in_image_region():
    body = _frame()[PANEL_HEIGHT:-LEGEND_HEIGHT]
    assert (body == np.array(GT_COLOR, np.uint8)).all(axis=-1).any()
    assert (body == np.array(PRED_COLOR, np.uint8)).all(axis=-1).any()


def test_load_ground_truth_scaling(tmp_path):
    p = tmp_path / "a.txt"
    p.write_text("1 0.5 0.5 0.5 0.5\n")
    assert load_ground_truth(p, 200, 100) == [(1, 50.0, 25.0, 150.0, 75.0)]


@pytest.mark.parametrize("seed", [0, 1])
def test_frames_pixel_equal_to_the_jax_viewer(seed):
    img, gt, dets, names = _inputs(seed)
    for module in (eval_torch, jax_viewer):
        assert module.PANEL_HEIGHT == PANEL_HEIGHT
    np.testing.assert_array_equal(
        eval_torch.draw_boxes(img.copy(), gt, dets, names),
        jax_viewer.draw_boxes(img.copy(), gt, dets, names))
    got, want = (m.compose_frame(img.copy(), gt, dets, names, idx=3,
                                 total=7, split="train", filename="y.png")
                 for m in (eval_torch, jax_viewer))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_load_ground_truth_equals_the_jax_viewer(tmp_path):
    p = tmp_path / "l.txt"
    p.write_text("0 0.5078 0.5208 0.3906 0.4167\n2 0.1 0.9 0.05 0.02\n"
                 "bad line\n3 0.7 0.3 0.2 0.1\n")
    assert load_ground_truth(p, 640, 480) == \
        jax_viewer.load_ground_truth(p, 640, 480)
    assert load_ground_truth(tmp_path / "none.txt", 8, 8) == []


def test_main_draws_the_ports_predictions(tmp_path, monkeypatch, capsys):
    """`main` on a port checkpoint with `--device cpu`: one frame shown
    (a headless stand-in for `cv2.imshow`), then Q quits."""
    from yolo_from_scratch_tpu_torch.config import YoloConfig
    from yolo_from_scratch_tpu_torch.models.yolo import YOLO
    from yolo_from_scratch_tpu_torch.utils.checkpoint import save_checkpoint
    from yolo_from_scratch_tpu_torch.utils.convert import (
        from_flax_variables,
        random_variables,
        to_flax_variables,
    )
    from yolo_from_scratch_tpu_torch.utils.synth import make_dataset

    yaml_path = make_dataset(tmp_path / "ds", n_train=1, n_val=1,
                             img_size=64, seed=0, num_classes=2)
    cfg = YoloConfig(num_classes=2, img_size=64, width_mult=0.25,
                     depth_mult=0.33)
    state = from_flax_variables(random_variables(
        YOLO(cfg, device="meta"), seed=0), YOLO(cfg))
    ckpt = tmp_path / "m.ckpt"
    save_checkpoint(ckpt, to_flax_variables(state), cfg)
    shown = []
    monkeypatch.setattr(cv2, "imshow", lambda name, f: shown.append(f))
    monkeypatch.setattr(cv2, "waitKey", lambda t: ord("q"))
    monkeypatch.setattr(cv2, "destroyAllWindows", lambda: None)
    monkeypatch.setattr(sys, "argv", ["eval_torch.py", str(ckpt),
                                      str(yaml_path), "--device", "cpu"])
    eval_torch.main()
    assert len(shown) == 1
    assert shown[0].shape[0] == 64 + PANEL_HEIGHT + LEGEND_HEIGHT
    assert "2 images" in capsys.readouterr().out
