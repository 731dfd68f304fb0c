"""The port's data parallelism (`parallel/`, `data/loader.py`'s shards, the
data-parallel step of `train/steps.py`, `train/loop.py`, the CLI's
`--data-parallel` / `--distributed`) against the JAX package, on the CPU.

The host-side rules are copies and are held bit for bit: `shard_indices`,
the sharded loader, `pad_batch_to_multiple`, `local_shard_indices`. The
step runs in two processes joined by `gloo` through a file store in the
test's directory (no TCP port), each on its half of a global batch of 4
(64 px, width 0.25, nc=3, float32, lr 1e-5), and is held to the JAX step
sharded on a 2-device virtual mesh from the same numpy-seeded inputs and
weights (JAX's loss and gradient jitted over the mesh, then its clip +
Adam). Tolerances, and why: those of `tests/test_torch_compact_step.py`
for one step against JAX (the JAX package's float32 fast variance in
train-mode BatchNorm; Adam turns gradient noise into +-lr steps): the
global loss (the ranks' parts summed) within 1e-4 relative; the summed
gradient before the clip within 2e-2 of each tensor's largest magnitude
(2e-4 absolute for the conv biases in front of a BatchNorm, whose
gradient is rounding noise); every parameter's change within 2 * lr of
JAX's and 90% of each tensor's within 0.05 * lr (but those biases); the
BatchNorm statistics 1e-3 relative and 1e-4 of each tensor's largest
magnitude. The two ranks' weights, gradients and statistics are equal
bit for bit. Evaluation counts are exact: the sharded `--val-det` and
grid counts on an odd split equal one process's.
"""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_train import PRE_BN_BIASES

from yolo_from_scratch_tpu.config import YoloConfig
from yolo_from_scratch_tpu.data import loader as jax_loader
from yolo_from_scratch_tpu.data.assign_device import pack_labels
from yolo_from_scratch_tpu.data.dataset import assign_targets
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu.parallel import distributed as jax_dist
from yolo_from_scratch_tpu.parallel import mesh as jax_mesh
from yolo_from_scratch_tpu.train.steps import _make_expand as jax_expand
from yolo_from_scratch_tpu.train.steps import _make_loss_fn
from yolo_from_scratch_tpu.train.steps import make_optimizer as jax_optimizer
from yolo_from_scratch_tpu_torch import cli
from yolo_from_scratch_tpu_torch.data import loader as port_loader
from yolo_from_scratch_tpu_torch.data.assign_device import prefix_valid
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops.augment import augment_compact_batch
from yolo_from_scratch_tpu_torch.parallel import distributed as port_dist
from yolo_from_scratch_tpu_torch.parallel import mesh as port_mesh
from yolo_from_scratch_tpu_torch.train.steps import DrawSpec
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)

NC, IMG, B, K, WORLD = 3, 64, 4, 8, 2
LR = 1e-5
SEED = 5  # the augmentation's
JOIN_S = 300
REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n,pc", [(103, 8), (12, 2), (13, 2), (5, 2),
                                  (17, 1), (3, 4)])
def test_shard_indices_bit_equal_jax(n, pc):
    perm = np.random.default_rng(n).permutation(n)
    for pi in range(pc):
        got = port_loader.shard_indices(perm, pi, pc)
        want = jax_loader.shard_indices(perm, pi, pc)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            port_dist.local_shard_indices(n, pi, pc),
            jax_dist.local_shard_indices(n, pi, pc))
    covered = np.concatenate([port_loader.shard_indices(perm, pi, pc)
                              for pi in range(pc)])
    assert set(covered.tolist()) == set(range(n))
    assert len(covered) == pc * -(-n // pc)


class _IdxDataset:
    """Item i is an image filled with i: a batch names its indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        img = np.full((2, 2, 3), i, np.float32)
        return img, [np.full((1, 1, 3, 6), i, np.float32) for _ in range(3)]


@pytest.mark.parametrize("n,pc,bs", [(12, 2, 3), (13, 2, 3), (2, 2, 4),
                                     (11, 3, 2)])
def test_loader_shards_bit_equal_jax(n, pc, bs):
    """The sharded loaders yield JAX's batches over two shuffled epochs:
    the same number of equal batches on every process."""
    counts = set()
    for pi in range(pc):
        kw = dict(batch_size=bs, shuffle=True, seed=7, prefetch=0,
                  process_shard=(pi, pc))
        got = port_loader.DataLoader(_IdxDataset(n), **kw)
        want = jax_loader.DataLoader(_IdxDataset(n), **kw)
        assert len(got) == len(want)
        for _ in range(2):
            batches = list(zip(got, want, strict=True))
            for (gi, gt), (wi, wt) in batches:
                np.testing.assert_array_equal(gi, wi)
                assert gi.shape[0] == bs
                for a, b in zip(gt, wt, strict=True):
                    np.testing.assert_array_equal(a, b)
            counts.add(len(batches))
    assert len(counts) == 1


def test_unpadded_val_shards_partition_the_split():
    seen = []
    for pi in range(WORLD):
        loader = port_loader.DataLoader(_IdxDataset(5), batch_size=2,
                                        prefetch=0, process_shard=(pi, WORLD),
                                        pad_shard=False)
        seen += [int(v) for images, _ in loader for v in images[:, 0, 0, 0]]
    assert sorted(seen) == list(range(5))


def test_pad_and_shard_batch():
    arr = np.arange(15).reshape(5, 3).astype(np.float32)
    for multiple in (1, 2, 8):
        got = port_mesh.pad_batch_to_multiple(arr, multiple)
        want = jax_mesh.pad_batch_to_multiple(arr, multiple)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    mesh = port_mesh.Mesh(1, 2, torch.device("cpu"))
    images, (t,) = port_mesh.shard_batch(mesh, arr[:4], [arr[:4] * 2])
    np.testing.assert_array_equal(images, arr[2:4])
    np.testing.assert_array_equal(t, arr[2:4] * 2)
    with pytest.raises(ValueError, match="does not divide"):
        port_mesh.shard_batch(mesh, arr, [arr])
    with pytest.raises(ValueError, match="1 devices do not divide"):
        port_mesh.make_mesh_2d(2)


def test_world_of_one_without_a_group(monkeypatch):
    for key in port_dist.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="together"):
        port_dist.init_distributed("127.0.0.1:9999", 2)
    with pytest.raises(ValueError, match="together"):
        port_dist.init_distributed(None, None, 0)
    with pytest.raises(ValueError, match="torchrun"):
        port_dist.init_distributed(device="cpu")
    with pytest.raises(ValueError, match="not in"):
        port_dist.init_distributed("127.0.0.1:9999", 2, 2, device="cpu")
    assert not torch.distributed.is_initialized()
    assert port_dist.global_eval_reduce(3, 4, 5, 1.25, 7) == (3, 4, 5, 1.25,
                                                               7)
    assert port_dist.global_batch_size(8) == 8
    mesh = port_mesh.make_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    # no group: nothing is reduced
    x = torch.arange(4.0)
    with port_mesh.data_parallel(mesh):
        assert port_mesh.active_mesh() is None
        assert port_mesh.global_sum(x) is x
        assert port_mesh.global_mean(x) == x.mean()


@pytest.mark.parametrize("argv,rc,says", [
    (["--distributed", "--coordinator", "127.0.0.1:1"], 1, "together"),
    (["--distributed", "--num-processes", "2"], 1, "together"),
    (["--distributed"], 1, "torchrun"),
    # --packed-stem --data-parallel trains (a world of one); --packed with
    # --spatial meets the mesh's own rule, as the unpacked model does: one
    # process does not divide into space=2 (the JAX CLI's line)
    (["--packed-stem", "--data-parallel", "--device", "cpu", "--size", "n",
      "--img-size", "64", "--batch-size", "2", "--epochs", "1"], 0,
     "Data-parallel mesh over 1 process(es)"),
    (["--packed", "p3", "--spatial", "2", "--data-parallel", "--device",
      "cpu"], 1, "1 devices do not divide into space=2"),
    (["--model-parallel", "2"], 1, "--spatial/--model-parallel require "
                                   "--data-parallel"),
])
def test_cli_flag_rules(argv, rc, says, temp_dataset_dir, tmp_path, capsys,
                        monkeypatch):
    for key in port_dist.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)  # a training writes its checkpoint here
    assert cli.main([str(temp_dataset_dir / "dataset.yaml"), *argv]) == rc
    assert says in capsys.readouterr().out


@pytest.mark.parametrize("world,flags", [
    (2, []), (2, ["--compact-targets"]), (4, ["--sparse-loss",
                                              "--compact-targets"])])
def test_cli_refuses_stream_pool_across_processes(
        world, flags, temp_dataset_dir, monkeypatch, capsys):
    """At a world of several processes `--stream --stream-pool` answers as
    the JAX CLI does with any mesh: exit 1 and its line (the mesh is
    faked: the refusal comes before any collective)."""
    monkeypatch.setattr(port_mesh, "make_mesh", lambda device: port_mesh.Mesh(
        1, world, torch.device("cpu"), group=object()))
    rc = cli.main([str(temp_dataset_dir / "dataset.yaml"), "--device", "cpu",
                   "--data-parallel", "--stream", "--stream-pool", "4",
                   *flags])
    out = capsys.readouterr().out
    assert rc == 1, out
    assert "--stream-pool is single-device" in out
    assert "not ported" not in out


def test_cli_stream_pool_refuses_a_mesh(temp_dataset_dir, capsys):
    rc = cli.main([str(temp_dataset_dir / "dataset.yaml"), "--device", "cpu",
                   "--data-parallel", "--stream", "--stream-pool", "4"])
    assert rc == 1
    assert "--stream-pool is single-device" in capsys.readouterr().out


# --- two ranks ------------------------------------------------------------

WORKER = r"""
import sys
import torch
import torch.distributed as dist
from yolo_from_scratch_tpu_torch import cli
from yolo_from_scratch_tpu_torch.config import YoloConfig
from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.parallel.mesh import make_mesh
from yolo_from_scratch_tpu_torch.train import loop, metrics, steps

rank, store, job_path, out_path = sys.argv[1:5]
rank = int(rank)
torch.set_num_threads(2)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
mesh = make_mesh("cpu")
job = torch.load(job_path, weights_only=False)
out = {"steps": {}}
clip = steps.clip_by_global_norm_
seen = {}


def recording_clip(grads, *a, **kw):
    seen["grads"] = [g.clone() for g in grads]
    return clip(grads, *a, **kw)


steps.clip_by_global_norm_ = recording_clip
for name, spec in job["steps"].items():
    cfg = YoloConfig(**spec["cfg"])
    model = YOLO(cfg)
    model.load_state_dict(spec["state"])
    state = steps.TrainState(model, steps.make_optimizer(model.parameters(),
                                                         spec["lr"]))
    step = steps.make_train_step(cfg, mesh=mesh, **spec["kw"])
    b = spec["images"].shape[0] // 2
    rows = slice(rank * b, (rank + 1) * b)
    state, m = step(state, torch.from_numpy(spec["images"][rows]),
                    [torch.from_numpy(t[rows]) for t in spec["targets"]])
    names = [n for n, _ in model.named_parameters()]
    out["steps"][name] = {
        "metrics": {k: v.item() for k, v in m.items()},
        "grads": dict(zip(names, seen["grads"])),
        "state": {k: v.clone() for k, v in model.state_dict().items()}}

# the accumulating step: n_accum micro-batches, each this rank's rows of
# a global micro-batch
acc = job["accum"]
cfg = YoloConfig(**acc["cfg"])
model = YOLO(cfg)
model.load_state_dict(acc["state"])
state = steps.TrainState(model, steps.make_optimizer(model.parameters(),
                                                     acc["lr"]))
b = acc["images"].shape[1] // 2
rows = slice(rank * b, (rank + 1) * b)
state, m = steps.make_train_step_accum(cfg, acc["images"].shape[0],
                                       mesh=mesh)(
    state, *(torch.from_numpy(a[:, rows]) for a in (acc["images"],
                                                   *acc["targets"])))
out["accum"] = {"loss": m["loss"].item(), "grads": dict(zip(
    [n for n, _ in model.named_parameters()], seen["grads"]))}

# evaluation on an odd split: the raw counts (prf1 and the loop's copy of
# it report them unchanged here)
metrics.prf1 = loop.prf1 = lambda tp, fp, fn: (tp, fp, fn)
det = job["det"]
cfg = YoloConfig(**det["cfg"])
model = YOLO(cfg)
model.load_state_dict(det["state"])
ds = YoloDataset(det["val"], cfg.num_classes, cfg.anchors_array,
                 cfg.img_size, backend="pil")
out["det"] = cli._det_eval(cfg, model, ds, "cpu", mesh)(model)
loader = DataLoader(ds, batch_size=2, process_shard=(rank, 2),
                    pad_shard=False)
eval_step = steps.make_eval_step(cfg)
out["eval"] = loop.eval_epoch(eval_step, model.eval(), loader, "cpu", mesh)
torch.save(out, out_path)
dist.destroy_process_group()
"""


def _cfg(head="anchor"):
    return YoloConfig(num_classes=NC, img_size=IMG, width_mult=0.25,
                      depth_mult=0.33, head_type=head)


def _compact(rng):
    images = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    boxes, classes = [], []
    for n in (5, 3, 1, 4):
        boxes.append(np.concatenate([rng.uniform(0.2, 0.8, (n, 2)),
                                     rng.uniform(0.05, 0.5, (n, 2))],
                                    1).astype(np.float32))
        classes.append(rng.integers(0, NC, n))
    return images, boxes, classes


def _jobs():
    """The three steps' inputs: (port job, JAX inputs) by name. The JAX
    inputs are the step's expanded batch: images float32 and the loss's
    targets."""
    rng = np.random.default_rng(0)
    port, ref = {}, {}
    # the dense anchor step: float32 images, host targets
    cfg = _cfg()
    images, boxes, classes = _compact(rng)
    images = images.astype(np.float32) / 255
    dense = [np.stack(t) for t in zip(*(
        assign_targets(b, c, cfg.anchors_array, IMG, NC)
        for b, c in zip(boxes, classes)))]
    port["dense"] = (cfg, images, dense, {})
    ref["dense"] = (cfg, images, dense, {})
    # the compact anchor step with the sparse loss and the device
    # augmentation: the port draws the global batch's flips and jitter
    # (step 0) and each rank takes its rows; the reference takes the same
    # draws on the whole batch, then JAX's sparse loss
    images, boxes, classes = _compact(rng)
    labels, counts = pack_labels(boxes, classes, K)
    port["sparse"] = (cfg, images, [labels, counts], dict(
        compact_targets=True, sparse_loss=True, device_augment="full",
        augment_seed=SEED))
    t_labels, t_counts = torch.from_numpy(labels), torch.from_numpy(counts)
    valid = prefix_valid(t_counts, K)
    draws = DrawSpec(SEED, False, True, True).draw(0, B)["augment"]
    aug_images, aug_labels = augment_compact_batch(
        torch.from_numpy(images).float() * (1 / 255.0), t_labels, valid,
        *draws)
    ref["sparse"] = (cfg, aug_images.numpy(), (aug_labels.numpy(),
                                               valid.numpy()),
                     dict(sparse=True))
    # the compact anchor-free step: JAX's own expand builds the GT set
    cfg = _cfg("anchor_free")
    images, boxes, classes = _compact(rng)
    labels, counts = pack_labels(boxes, classes, K)
    port["af"] = (cfg, images, [labels, counts], dict(compact_targets=True))
    ref["af"] = (cfg, *jax_expand(cfg, True)(0, images, (labels, counts)),
                 dict(af_compact=True))
    return port, ref


def _jax_step(cfg, variables, images, targets, loss_kw):
    """JAX's data-parallel step on a 2-device mesh: (loss, gradients, new
    params, new batch_stats)."""
    mesh = jax_mesh.make_mesh(jax.devices()[:WORLD])
    batch, rep = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    loss_fn = _make_loss_fn(JaxYOLO(cfg), cfg, False, **loss_kw)
    (total, (new_bs, *_)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(
        jax.device_put(variables["params"], rep),
        jax.device_put(variables["batch_stats"], rep),
        jax.device_put(np.asarray(images), batch),
        jax.tree_util.tree_map(lambda t: jax.device_put(np.asarray(t), batch),
                               targets))
    tx = jax_optimizer(LR)

    def adam(grads, params):
        # jitted: op by op, each leaf's update compiles on its own
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    params = jax.jit(adam)(grads, variables["params"])
    return float(total), *jax.device_get((grads, params, new_bs))


def _det_split(root):
    """An odd val split (5 images) for the sharded evaluation."""
    from yolo_from_scratch_tpu_torch.utils.synth import make_dataset

    make_dataset(root, n_train=2, n_val=5, img_size=IMG, seed=3,
                 num_classes=NC)
    return str(root / "val" / "images")


def _run_ranks(cmds, cwd, env=None):
    """Start every command at once; wait for all within JOIN_S seconds
    (then kill them); returns their (rc, stdout, stderr)."""
    procs = [subprocess.Popen(c, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for c in cmds]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=JOIN_S)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            p.kill()
    return results


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results, and the inputs they were given."""
    tmp = tmp_path_factory.mktemp("ranks")
    port, ref = _jobs()
    job = {"steps": {}}
    variables = {}
    for name, (cfg, images, targets, kw) in port.items():
        variables[name] = random_variables(YOLO(cfg, device="meta"), seed=3)
        job["steps"][name] = dict(
            cfg=dict(num_classes=NC, img_size=IMG, width_mult=0.25,
                     depth_mult=0.33, head_type=cfg.head_type),
            state=from_flax_variables(variables[name], YOLO(cfg)), lr=LR,
            images=images, targets=targets, kw=kw)
    det_cfg = _cfg()
    det_vars = random_variables(YOLO(det_cfg, device="meta"), seed=4)
    for head in ("head_p3", "head_p4", "head_p5"):  # detections at 0.5
        det_vars["params"][head]["pred"]["bias"].reshape(3, -1)[:, 4] += 4.6
    job["det"] = dict(cfg=dict(num_classes=NC, img_size=IMG,
                               width_mult=0.25, depth_mult=0.33),
                      state=from_flax_variables(det_vars, YOLO(det_cfg)),
                      val=_det_split(tmp / "det"))
    cfg, images, targets, _ = port["dense"]
    job["accum"] = dict(
        job["steps"]["dense"],
        images=images.reshape(2, WORLD, *images.shape[1:]),
        targets=[t.reshape(2, WORLD, *t.shape[1:]) for t in targets])
    torch.save(job, tmp / "job.pt")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(REPO))
    results = _run_ranks([[sys.executable, "-c", WORKER, str(r),
                           str(tmp / "store"), str(tmp / "job.pt"),
                           str(tmp / f"rank{r}.pt")] for r in range(WORLD)],
                         tmp, env)
    for rc, _, err in results:
        assert rc == 0, err[-3000:]
    return ([torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)], job, ref, variables)


@pytest.mark.parametrize("name", ["dense", "sparse", "af"])
def test_two_rank_step_matches_jax_sharded_step(two_ranks, name):
    ranks, job, ref, variables = two_ranks
    got = [r["steps"][name] for r in ranks]
    # the ranks hold the same state and gradient
    for key in ("grads", "state"):
        for k, v in got[0][key].items():
            assert torch.equal(v, got[1][key][k]), (key, k)
    cfg, images, targets, loss_kw = ref[name]
    loss, grads, params, batch_stats = _jax_step(cfg, variables[name],
                                                 images, targets, loss_kw)
    total = sum(r["metrics"]["loss"] for r in got)
    np.testing.assert_allclose(total, loss, rtol=1e-4)
    model = YOLO(cfg, device="meta")
    want_grads = from_flax_variables(
        {"params": grads, "batch_stats": batch_stats}, model)
    for k, g in got[0]["grads"].items():
        want = want_grads[k].numpy()
        atol = 2e-4 if k in PRE_BN_BIASES else 2e-2 * np.abs(want).max()
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=atol,
                                   err_msg=k)
    want = from_flax_variables({"params": params,
                                "batch_stats": batch_stats}, model)
    start = job["steps"][name]["state"]
    for k, t in got[0]["state"].items():
        if k.endswith((".bn.mean", ".bn.var")):
            np.testing.assert_allclose(
                t.numpy(), want[k].numpy(), rtol=1e-3,
                atol=1e-4 * want[k].abs().max().item(), err_msg=k)
            continue
        diff = np.abs((t - start[k]).numpy() - (want[k] - start[k]).numpy())
        assert diff.max() <= 2 * LR, (k, diff.max() / LR)
        if k not in PRE_BN_BIASES:
            assert np.quantile(diff, 0.9) <= 0.05 * LR, (
                k, np.quantile(diff, 0.9) / LR)


def test_two_rank_accum_step_matches_one_process(two_ranks):
    """`make_train_step_accum(n_accum=2)` over two ranks, each micro-batch
    split between them, against one process on the global micro-batches:
    phase 8's tolerances (the port against itself, float32: only the
    summation order differs), the ranks' gradients equal."""
    from yolo_from_scratch_tpu_torch.train import steps

    ranks, job, _, _ = two_ranks
    acc = job["accum"]
    cfg = YoloConfig(**acc["cfg"])
    model = YOLO(cfg)
    model.load_state_dict(acc["state"])
    state = steps.TrainState(model, steps.make_optimizer(model.parameters(),
                                                         LR))
    clip, seen = steps.clip_by_global_norm_, {}

    def recording_clip(grads, *a, **kw):
        seen["grads"] = [g.clone() for g in grads]
        return clip(grads, *a, **kw)

    steps.clip_by_global_norm_ = recording_clip
    try:
        state, m = steps.make_train_step_accum(cfg, 2)(state, *(
            torch.from_numpy(a) for a in (acc["images"], *acc["targets"])))
    finally:
        steps.clip_by_global_norm_ = clip
    got = [r["accum"] for r in ranks]
    np.testing.assert_allclose(sum(r["loss"] for r in got), m["loss"].item(),
                               rtol=1e-4)
    for (k, g), want in zip(got[0]["grads"].items(), seen["grads"]):
        assert torch.equal(g, got[1]["grads"][k]), k
        if k not in PRE_BN_BIASES:
            torch.testing.assert_close(g, want, rtol=0,
                                       atol=1e-3 * want.abs().max().item())


def test_sharded_eval_counts_equal_one_process(two_ranks):
    """--val-det's counts and the grid counts of an odd split (5 images:
    3 on rank 0, 2 on rank 1) equal one process's: no image twice."""
    from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
    from yolo_from_scratch_tpu_torch.train import loop
    from yolo_from_scratch_tpu_torch.train.metrics import prf1
    from yolo_from_scratch_tpu_torch.train.steps import make_eval_step

    ranks, job, _, _ = two_ranks
    det = job["det"]
    cfg = YoloConfig(**det["cfg"])
    model = YOLO(cfg)
    model.load_state_dict(det["state"])
    ds = YoloDataset(det["val"], NC, cfg.anchors_array, IMG, backend="pil")
    assert len(ds) == 5
    from yolo_from_scratch_tpu_torch.infer.predict import BatchPredictor
    from yolo_from_scratch_tpu_torch.train.map_eval import evaluate_det_counts

    want = evaluate_det_counts(BatchPredictor(det["state"], cfg,
                                              conf_threshold=0.5,
                                              device="cpu"), ds)
    assert sum(want) > 0
    assert ranks[0]["det"] == ranks[1]["det"] == tuple(want)
    single = loop.eval_epoch(make_eval_step(cfg), model.eval(),
                             DataLoader(ds, batch_size=2), "cpu")
    for r in ranks:
        assert prf1(*r["eval"][1:]) == single[1:]
    assert sum(ranks[0]["eval"][1:]) > 0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_trains_two_processes(temp_dataset_dir, tmp_path):
    """`train_torch.py --distributed` in two processes over a localhost
    coordinator: both print the global epoch line, one checkpoint."""
    base = [sys.executable, str(REPO / "train_torch.py"),
            str(temp_dataset_dir / "dataset.yaml"), "--device", "cpu",
            "--size", "n", "--img-size", str(IMG), "--batch-size", "2",
            "--epochs", "1", "--val-det", "--distributed", "--coordinator",
            f"127.0.0.1:{_free_port()}", "--num-processes", str(WORLD)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    results = _run_ranks([base + ["--process-id", str(r)]
                          for r in range(WORLD)], tmp_path, env)
    lines = []
    for r, (rc, out, err) in enumerate(results):
        assert rc == 0, err[-3000:]
        assert f"Distributed: process {r}/{WORLD}, backend gloo" in out
        assert f"Data-parallel mesh over {WORLD} process(es)" in out
        epoch = re.search(r"Epoch 1: .* \| LR: ", out)
        assert epoch and " | Det: P " in epoch.group(0), out
        lines.append(epoch.group(0))
    assert lines[0] == lines[1]
    assert len(list(tmp_path.glob("yolo_*.ckpt"))) == 1
