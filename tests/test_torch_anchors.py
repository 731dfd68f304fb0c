"""K-means anchors and `--compute-anchors` of the PyTorch port against the
JAX package, on the CPU.

The JAX package seeds k-means++ from `jax.random.PRNGKey(0)`, which torch
cannot replay, so the packages are held where they must agree:
- Lloyd's iterations from the SAME initial centers: assignments equal,
  centers within 1e-4 relative, inertia within 1e-5 relative (float32 sums
  of up to a few hundred points in another order);
- `compute_optimal_anchors` (and the CLI) on nine well-separated size
  clusters, where every seeding of either package ends in the same
  clusters: rounded anchors and stdout equal.
A three-cluster dataset does not do: with k=9 how the three split depends
on the seeding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from yolo_from_scratch_tpu import cli as jax_cli
from yolo_from_scratch_tpu.utils import anchors as jax_anchors
from yolo_from_scratch_tpu_torch import cli
from yolo_from_scratch_tpu_torch.utils import anchors

CPU = torch.device("cpu")
# nine (w, h) box sizes in pixels at 640, the default anchors
CLUSTERS = ((10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119),
            (116, 90), (156, 198), (373, 326))
# each cluster's boxes: its center and 8 neighbours 1 px away (the mean is
# the center, within-cluster distances <= 2 px^2 against >= 100 between)
OFFSETS = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1),
           (1, -1), (-1, 1))


def _write_dataset(root, boxes_per_image):
    (root / "train" / "images").mkdir(parents=True)
    (root / "train" / "labels").mkdir(parents=True)
    for i, boxes in enumerate(boxes_per_image):
        lines = [f"0 0.5 0.5 {w / 640} {h / 640}" for w, h in boxes]
        (root / "train" / "labels" / f"{i}.txt").write_text(
            "\n".join(lines) + "\n")
    path = root / "data.yaml"
    path.write_text(yaml.safe_dump({
        "nc": 1, "names": ["x"], "train": str(root / "train" / "images"),
        "val": str(root / "train" / "images")}))
    return path


@pytest.fixture(scope="module")
def nine_clusters(tmp_path_factory):
    """9 label files, one a cluster offset: each holds one box of every
    cluster (81 boxes)."""
    boxes = [[(w + dx, h + dy) for w, h in CLUSTERS] for dx, dy in OFFSETS]
    return _write_dataset(tmp_path_factory.mktemp("nine"), boxes)


def _blobs(seed):
    rng = np.random.default_rng(seed)
    means = np.float32([[20, 30], [60, 40], [45, 90], [120, 110]])
    pts = np.concatenate([rng.normal(m, 6.0, (40, 2)) for m in means])
    return pts.astype(np.float32)


@pytest.mark.parametrize("case", ["points", "far", "duplicate"])
def test_lloyd_from_the_same_centers_matches_jax(case):
    """From centers drawn among the points; with one center far from
    every point (its cluster stays empty and it stays where it was); with
    two equal centers (argmin ties go to the first, so after one step the
    second has no points and has not moved)."""
    pts = _blobs(1)
    rng = np.random.default_rng(2)
    init = pts[rng.choice(len(pts), 5, replace=False)].copy()
    if case == "far":
        init[4] = (900.0, 900.0)
    elif case == "duplicate":
        init[4] = init[1]
    want_c, want_i = (np.asarray(a) for a in jax_anchors._lloyd(
        jnp.asarray(pts), jnp.asarray(init)))
    got_c, got_i = anchors._lloyd(torch.from_numpy(pts),
                                  torch.from_numpy(init))
    got_c, got_i = got_c.numpy(), got_i.numpy()

    def assign(c):
        return ((pts[:, None] - c[None]) ** 2).sum(-1).argmin(1)

    np.testing.assert_array_equal(assign(got_c), assign(want_c))
    np.testing.assert_allclose(got_c, want_c, rtol=1e-4)
    np.testing.assert_allclose(got_i, want_i, rtol=1e-5)
    if case == "far":
        np.testing.assert_array_equal(got_c[4], init[4])
        assert not (assign(got_c) == 4).any()
    if case == "duplicate":
        one, _ = anchors._lloyd(torch.from_numpy(pts), torch.from_numpy(init),
                                iters=1)
        j_one, _ = jax_anchors._lloyd(jnp.asarray(pts), jnp.asarray(init),
                                      iters=1)
        np.testing.assert_array_equal(one[4].numpy(), init[4])
        np.testing.assert_array_equal(np.asarray(j_one)[4], init[4])
        assert not (one[1].numpy() == init[1]).all()


def test_collect_dataset_wh_bit_equal(nine_clusters):
    got, files = anchors.collect_dataset_wh(nine_clusters, img_size=640)
    want, j_files = jax_anchors.collect_dataset_wh(nine_clusters,
                                                   img_size=640)
    assert got.dtype == want.dtype == np.float32 and got.shape == (81, 2)
    np.testing.assert_array_equal(got, want)
    assert files == j_files and len(files) == 9


def test_kmeans_same_seed_same_centers():
    pts = _blobs(3)
    a = anchors.kmeans(pts, 4, seed=5, device=CPU)
    b = anchors.kmeans(pts, 4, seed=5, device=CPU)
    assert a.shape == (4, 2) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    order = np.argsort(a[:, 0])
    np.testing.assert_allclose(a[order], [[20, 30], [45, 90], [60, 40],
                                          [120, 110]], atol=3.0)


def test_compute_optimal_anchors_matches_jax(nine_clusters, capsys):
    want = jax_anchors.compute_optimal_anchors(nine_clusters, img_size=640)
    want_out = capsys.readouterr().out
    got = anchors.compute_optimal_anchors(nine_clusters, img_size=640,
                                          device=CPU)
    assert got == want == [list(map(list, CLUSTERS[i:i + 3]))
                           for i in (0, 3, 6)]
    assert capsys.readouterr().out == want_out
    assert "Anchor 9: [373.0, 326.0] (area: 121598)" in want_out


def test_no_boxes_returns_none(tmp_path, capsys):
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    path = tmp_path / "empty.yaml"
    path.write_text(yaml.safe_dump({"nc": 1, "train": str(tmp_path / "images"),
                                    "val": str(tmp_path / "images")}))
    assert anchors.compute_optimal_anchors(path, device=CPU) is None
    out = capsys.readouterr().out
    assert out == f"ERROR: No boxes found in {tmp_path / 'labels'}\n"
    assert jax_anchors.compute_optimal_anchors(path) is None
    assert capsys.readouterr().out == out


def test_cli_compute_anchors_stdout_matches_jax(nine_clusters, capsys):
    args = [str(nine_clusters), "--compute-anchors", "--img-size", "640"]
    with pytest.raises(SystemExit) as exit_info:
        jax_cli.main(args)
    assert exit_info.value.code == 0
    want = capsys.readouterr().out
    assert cli.main([*args, "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert want.startswith(f"Computing optimal anchors for {nine_clusters} "
                           f"at img_size=640...\n")
    assert "Recommended anchor configuration:" in want
    assert cli.main(["--compute-anchors", "--device", "cpu"]) == 1
