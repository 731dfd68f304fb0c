"""`--spatial N` on a P5 grid that N does not divide: the port's block
plan (`parallel/mesh.py::row_split`, `level_blocks`) and every consumer of
it, against the JAX package and one process, on the CPU.

The plan splits the P5 grid g = img_size / 32: rank s of a space group
holds g // N + (s < g % N) P5 rows, and k times as many rows of a level k
times finer. The meshes (data x space @ image size, P5 rows a rank):

- 1 x 2 @96 (2 / 1), 2 x 2 @96 (2 / 1 in each data shard);
- 1 x 4 @160 (2 / 1 / 1 / 1);
- 1 x 4 @96 (1 / 1 / 1 / 0): a rank that holds no rows.

They run at once in processes joined by `gloo` through file stores. Each
rank checks

- the halo exchange alone (a 2-row halo at P5, whose rows come from
  ranks further away and from beyond an empty block) exactly, forward
  and backward; a stride-1 and a stride-2 3x3 conv within 1e-6 of the
  largest magnitude forward and backward, a 5x5 pool's forward exactly
  and its backward within 1e-6 (`tests/test_torch_spatial.py::
  test_halo_exchange_matches_unsharded`'s bounds); the row gather of the
  anchor-free head exactly, forward and backward;
- train-mode BatchNorm's statistics over data x space (1e-6), each
  block's dx (1e-6 of the max) and the summed scale and bias gradients
  (1e-5 of the max);
- one step of the compact anchor head (dense maps built in the step),
  the compact anchor head with the sparse loss and device augmentation,
  and the compact anchor-free head, width 0.25, nc=3, float32, a global
  batch of 4. At 96 against JAX's step on its 1 x 2 mesh (the images
  sharded on `space`, the compact labels on `data`, the dense maps built
  inside the jitted step, whose P5 rows GSPMD pads: the grid JAX trains
  and the port now does), one compile a path, the reference of the three
  meshes at 96 (each compile of JAX's sharded step takes ~25 s on this
  CPU, so the other mesh shapes reuse it: JAX's step on any 2-D mesh is
  its single-device step, `tests/test_sharding.py`), at
  `tests/test_torch_spatial.py::test_spatial_step_matches_jax`'s
  tolerances: the global loss within 1e-4 relative, the gradient within
  2e-2 of each tensor's largest magnitude (2e-4 absolute for the conv
  biases in front of a BatchNorm), every parameter's change within 2 * lr
  of JAX's and 90% of each tensor's within 0.05 * lr, the BatchNorm
  statistics 1e-3 relative and 1e-4 of the largest magnitude; all ranks'
  gradients and weights bit-equal. At 160 (1 x 4) against one process
  of the port: the loss within 1e-6 relative (anchor-free 1e-5), the
  gradients within 1e-3 of each tensor's largest magnitude, the
  BatchNorm statistics within 1e-5 of it;
- the grid counts of an odd val split through the spatial eval step on
  compact labels, both heads, equal one process's.

`--multi-scale --compact-targets` under `--spatial 2` at 128 trains the
buckets 96 / 128 / 160 (3 / 4 / 5 P5 rows) in two processes: the same
epoch lines on both ranks, their losses within the printed digit of one
process's.
"""

import os
import pickle
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_train import PRE_BN_BIASES

from yolo_from_scratch_tpu.config import YoloConfig
from yolo_from_scratch_tpu.data.assign_device import pack_labels
from yolo_from_scratch_tpu_torch import cli
from yolo_from_scratch_tpu_torch.data.assign_device import prefix_valid
from yolo_from_scratch_tpu_torch.models.fused_bn import bn_silu_train
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops.augment import augment_compact_batch
from yolo_from_scratch_tpu_torch.parallel import mesh as port_mesh
from yolo_from_scratch_tpu_torch.train.steps import DrawSpec
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)

NC, B, K = 3, 4, 8
LR = 1e-5
SEED = 5  # the augmentation's
JOIN_S = 300
REPO = Path(__file__).resolve().parents[1]
# (data, space, image size)
MESHES = ((1, 2, 96), (2, 2, 96), (1, 4, 160), (1, 4, 96))
IDS = ["1x2@96", "2x2@96", "1x4@160", "1x4@96"]
N_VAL = 5  # the odd val split of the sharded evaluation
OP_TOL = 1e-6  # the convs and the pools' backward, of the largest magnitude
MS_IMG = 128  # --multi-scale: buckets 96 / 128 / 160
# JAX's reference mesh: its step on (1, 2) at 96 is the reference of the
# three meshes at 96 (the same global batch; JAX's step on a 2-D mesh
# equals its single-device step, `tests/test_sharding.py`)
JAX_MESH = (1, 2, 96)
EPOCH = re.compile(r"Epoch \d+: Loss: ([0-9.]+) .*")


@pytest.mark.parametrize("grid,n,want", [
    (3, 2, [2, 1]), (3, 4, [1, 1, 1, 0]), (5, 4, [2, 1, 1, 1]),
    (19, 2, [10, 9]), (20, 3, [7, 7, 6]), (20, 2, [10, 10]),
    (20, 4, [5, 5, 5, 5]), (4, 1, [4]), (1, 8, [1, 0, 0, 0, 0, 0, 0, 0])])
def test_block_plan(grid, n, want):
    """Blocks differ by one row at most, the longer first, and sum to the
    grid; each level holds its factor times them; where n divides the
    grid they are the equal split of every level."""
    blocks = port_mesh.row_split(grid, n)
    assert blocks == want
    assert sum(blocks) == grid and max(blocks) - min(blocks) <= 1
    assert blocks == sorted(blocks, reverse=True)
    for f in (1, 2, 4, 8, 32):
        assert port_mesh.level_blocks(grid * f, n, grid) == [
            f * r for r in blocks]
        if grid % n == 0:
            assert port_mesh.level_blocks(grid * f, n, grid) == \
                port_mesh.level_blocks(grid * f, n)


def test_block_plan_slices_and_refusals():
    """`space_rows` cuts the plan's rows, the equal split without a grid;
    a level that is no multiple of the grid, or an unequal split without
    a grid, raises."""
    x = np.arange(2 * 96 * 3).reshape(2, 96, 3)
    ranks = [port_mesh.Mesh(s, 4, torch.device("cpu"), n_space=4)
             for s in range(4)]
    cut = [port_mesh.space_rows(m, x, 3) for m in ranks]
    assert [c.shape[1] for c in cut] == [32, 32, 32, 0]
    np.testing.assert_array_equal(np.concatenate(cut, 1), x)
    even = [port_mesh.space_rows(m, x[:, :64], 4) for m in ranks]
    assert [c.shape[1] for c in even] == [16] * 4
    np.testing.assert_array_equal(
        np.concatenate(even, 1),
        np.concatenate([port_mesh.space_rows(m, x[:, :64]) for m in ranks],
                       1))
    with pytest.raises(ValueError):
        port_mesh.level_blocks(10, 2, 3)
    with pytest.raises(ValueError):
        port_mesh.space_rows(ranks[0], x[:, :6], None)


# --- the ranks ------------------------------------------------------------

WORKER = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from yolo_from_scratch_tpu_torch.config import YoloConfig
from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
from yolo_from_scratch_tpu_torch.models.blocks import maxpool_same
from yolo_from_scratch_tpu_torch.models.fused_bn import bn_silu_train
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.parallel.mesh import (
    batch_sharding, batch_sharding_for, data_parallel, image_sharding,
    make_mesh_2d)
from yolo_from_scratch_tpu_torch.parallel.spatial import (
    fit_rows, gather_rows, halo_rows)
from yolo_from_scratch_tpu_torch.train import loop, metrics, steps

rank, world, n_space, store, job_path, out_path = sys.argv[1:7]
rank, world, n_space = int(rank), int(world), int(n_space)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
mesh = make_mesh_2d(n_space, "cpu")
job = torch.load(job_path, weights_only=False)
grid = job["grid"]
out = {"steps": {}, "ops": {}}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


# the halo exchange, the ops on it and the row gather, as the model runs them
for name, x_full, w, dy in job["ops"]:
    x = image_sharding(mesh, x_full, grid)
    x = (torch.from_numpy(np.ascontiguousarray(x)) if name == "gather"
         else nchw(x)).requires_grad_()
    with data_parallel(mesh, grid):
        if name == "halo":
            y = halo_rows(x, 2, 2, 0.0, mesh)
        elif name == "conv_s1":
            y = fit_rows(lambda t: F.conv2d(t, w, padding=(0, 1)),
                         halo_rows(x, 1, 1, 0.0, mesh), 3)
        elif name == "conv_s2":
            y = fit_rows(lambda t: F.conv2d(t, w, stride=2, padding=(0, 1)),
                         halo_rows(x, 1, 0, 0.0, mesh), 3)
        elif name == "pool":
            y = maxpool_same(x, 5)
        else:
            y = gather_rows(x, mesh)
    if name == "halo":
        # this rank's tile of the padded dy (rows start .. start + h + 4)
        start = job["starts"][mesh.space_index]
        g = nchw(batch_sharding(mesh, dy))[:, :, start:start + y.shape[2]]
    elif name == "gather":
        g = torch.from_numpy(batch_sharding(mesh, dy))
    else:
        g = nchw(image_sharding(mesh, dy, grid))
    y.backward(g)
    out["ops"][name] = (y.detach(), x.grad)

# train-mode BatchNorm on row blocks of a P4 level: statistics over data x
# space
x = nchw(image_sharding(mesh, job["bn"][0], grid)).requires_grad_()
scale, bias = (torch.from_numpy(t).requires_grad_() for t in job["bn"][1:3])
with data_parallel(mesh, grid):
    y, mu, var = bn_silu_train(x, scale, bias)
    y.backward(nchw(image_sharding(mesh, job["bn"][3], grid)))
out["bn"] = (y.detach(), mu, var, x.grad, scale.grad, bias.grad)

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
    images = image_sharding(mesh, spec["images"], grid)
    targets = [batch_sharding_for(mesh, t, grid) for t in spec["targets"]]
    state, m = step(state, torch.from_numpy(np.ascontiguousarray(images)),
                    [torch.from_numpy(np.ascontiguousarray(t))
                     for t in targets])
    names = [k for k, _ in model.named_parameters()]
    out["steps"][name] = {
        "metrics": {k: v.item() for k, v in m.items()},
        "grads": dict(zip(names, seen["grads"])),
        "state": {k: v.clone() for k, v in model.state_dict().items()}}

# evaluation of an odd split on compact labels: each data shard its
# unpadded slice, each rank its rows; the raw counts
metrics.prf1 = loop.prf1 = lambda tp, fp, fn: (tp, fp, fn)
ev = job["eval"]
out["eval"] = {}
for head in ("anchor", "anchor_free"):
    cfg = YoloConfig(**ev["cfg"], head_type=head)
    model = YOLO(cfg)
    model.load_state_dict(ev["state"][head])
    ds = YoloDataset(ev["val"], cfg.num_classes, cfg.anchors_array,
                     cfg.img_size, backend="pil", head_type=head)
    loader = DataLoader(ds, batch_size=2, compact=ev["k"],
                        process_shard=(mesh.data_index, mesh.n_data),
                        pad_shard=False)
    eval_step = steps.make_eval_step(cfg, compact_targets=True, mesh=mesh)
    out["eval"][head] = loop.eval_epoch(eval_step, model.eval(), loader,
                                        "cpu", mesh)
torch.save(out, out_path)
dist.barrier()
dist.destroy_process_group()
"""


def _cfg(img, head="anchor"):
    return YoloConfig(num_classes=NC, img_size=img, width_mult=0.25,
                      depth_mult=0.33, head_type=head)


def _cfg_kw(img, head="anchor"):
    return dict(num_classes=NC, img_size=img, width_mult=0.25,
                depth_mult=0.33, head_type=head)


def _compact(rng, img):
    images = rng.integers(0, 256, (B, img, img, 3), dtype=np.uint8)
    boxes, classes = [], []
    for n in (5, 3, 1, 4):
        boxes.append(np.concatenate([rng.uniform(0.2, 0.8, (n, 2)),
                                     rng.uniform(0.05, 0.5, (n, 2))],
                                    1).astype(np.float32))
        classes.append(rng.integers(0, NC, n))
    labels, counts = pack_labels(boxes, classes, K)
    return images, labels, counts


def _jobs(img):
    """The three compact steps at `img`: (port job, JAX inputs) by name.
    JAX's inputs: (cfg, images, targets, loss keywords, whether its
    expansion runs in the step)."""
    rng = np.random.default_rng(img)
    port, ref = {}, {}
    cfg = _cfg(img)
    images, labels, counts = _compact(rng, img)
    port["compact"] = (cfg, images, [labels, counts],
                       dict(compact_targets=True))
    ref["compact"] = (cfg, images, (labels, counts), {}, True)
    images, labels, counts = _compact(rng, img)
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
                     dict(sparse=True), False)
    cfg = _cfg(img, "anchor_free")
    images, labels, counts = _compact(rng, img)
    port["af"] = (cfg, images, [labels, counts], dict(compact_targets=True))
    ref["af"] = (cfg, images, (labels, counts), dict(af_compact=True), True)
    return port, ref


def _ops(grid):
    """The halo cases at the levels of a P5 grid of `grid` rows: (name, x
    NHWC, w or None, dy), and BatchNorm's (x, scale, bias, dy) at P4."""
    rng = np.random.default_rng(11 + grid)
    p5, p4 = grid, 2 * grid
    ops = []
    x = rng.standard_normal((2, p5, p5, 4)).astype(np.float32)
    ops.append(("halo", x, None, rng.standard_normal(
        (2, p5 + 4, p5, 4)).astype(np.float32)))
    for name, rows in (("conv_s1", p4), ("conv_s2", p4), ("pool", p5),
                       ("gather", p4)):
        x = rng.standard_normal((2, rows, rows, 4)).astype(np.float32)
        w = (torch.from_numpy(rng.standard_normal((5, 4, 3, 3))
                              .astype(np.float32))
             if name.startswith("conv") else None)
        y = _op_reference(name, x, w)
        ops.append((name, x, w, rng.standard_normal(y.shape).astype(
            np.float32)))
    bn = (rng.standard_normal((4, p4, p4, 5)).astype(np.float32),
          rng.uniform(0.5, 1.5, 5).astype(np.float32),
          rng.uniform(-0.5, 0.5, 5).astype(np.float32),
          rng.standard_normal((4, p4, p4, 5)).astype(np.float32))
    return ops, bn


def _op_reference(name, x, w):
    """The unsharded op of a halo case on NHWC x, NHWC out (the gather:
    the tensor itself)."""
    if name == "gather":
        return torch.from_numpy(x)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    return _op_reference_nchw(name, t, w).permute(0, 2, 3, 1)


JAX_WORKER = r"""
import os
import pickle
import sys

import jax

jax.config.update("jax_platforms", "cpu")
import optax

from yolo_from_scratch_tpu.models.yolo import YOLO
from yolo_from_scratch_tpu.parallel import mesh as jax_mesh
from yolo_from_scratch_tpu.train.steps import _make_expand, _make_loss_fn
from yolo_from_scratch_tpu.train.steps import make_optimizer

with open(sys.argv[1], "rb") as f:
    cfg, variables, images, targets, loss_kw, in_step, n_space, lr = \
        pickle.load(f)
jmesh = jax_mesh.make_mesh_2d(n_space, devices=jax.devices()[:n_space])
loss_fn = _make_loss_fn(YOLO(cfg), cfg, False, **loss_kw)
expand = _make_expand(cfg, True) if in_step else None


def grad_fn(params, batch_stats, images, targets):
    if expand is not None:
        images, targets = expand(0, images, targets)
    return jax.value_and_grad(loss_fn, has_aux=True)(
        params, batch_stats, images, targets)


put = jax.device_put
(total, (new_bs, *_)), grads = jax.jit(grad_fn)(
    variables["params"], variables["batch_stats"],
    put(images, jax_mesh.image_sharding(jmesh)),
    tuple(put(t, jax_mesh.batch_sharding_for(jmesh, t)) for t in targets))
tx = make_optimizer(lr)


def adam(grads, params):
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates)


params = jax.jit(adam)(grads, variables["params"])
with open(sys.argv[2], "wb") as f:
    pickle.dump((float(total), *jax.device_get((grads, params, new_bs))), f)
"""


def _start_jax_steps(ref, variables, tmp, env):
    """JAX's steps on its mesh JAX_MESH, one process a path (a compile
    each, ~25 s apiece on this CPU, so they run beside each other and the
    ranks): the images sharded on data x space, the compact labels on
    data, the expansion in the jitted step where asked. Returns {name:
    (process, output path)}."""
    started = {}
    for name, (cfg, images, targets, kw, in_step) in ref.items():
        job, out = tmp / f"jax_{name}.pkl", tmp / f"jax_{name}_out.pkl"
        with open(job, "wb") as f:
            pickle.dump((cfg, variables[name], images, targets, kw, in_step,
                         JAX_MESH[1], LR), f)
        started[name] = (subprocess.Popen(
            [sys.executable, "-c", JAX_WORKER, str(job), str(out)],
            cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env), out)
    return started


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_args(yaml_path):
    return [str(yaml_path), "--device", "cpu", "--size", "n", "--img-size",
            str(MS_IMG), "--batch-size", "2", "--epochs", "3",
            "--multi-scale", "--compact-targets", str(K), "--lr", "1e-3",
            "--warmup-epochs", "0", "--seed", "3"]


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Every rank's results on the four meshes, the jobs they ran and
    JAX's references, by mesh; the --multi-scale CLI's outputs."""
    from yolo_from_scratch_tpu_torch.utils.synth import make_dataset

    tmp = tmp_path_factory.mktemp("spatial_uneven")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    jobs, procs, outs = {}, [], {}
    for n_data, n_space, img in MESHES:
        grid = img // 32
        port, ref = _jobs(img)
        ops, bn = _ops(grid)
        starts = np.cumsum([0] + port_mesh.level_blocks(
            grid, n_space, grid))[:-1]
        job = {"grid": grid, "ops": ops, "bn": bn, "starts": starts,
               "steps": {}}
        variables = {}
        for name, (cfg, images, targets, kw) in port.items():
            variables[name] = random_variables(YOLO(cfg, device="meta"),
                                               seed=3)
            job["steps"][name] = dict(
                cfg=_cfg_kw(img, cfg.head_type),
                state=from_flax_variables(variables[name], YOLO(cfg)),
                lr=LR, images=images, targets=targets, kw=kw)
        det = make_dataset(tmp / f"det{img}", n_train=2, n_val=N_VAL,
                           img_size=img, seed=3, num_classes=NC)
        states = {}
        for head in ("anchor", "anchor_free"):
            v = random_variables(YOLO(_cfg(img, head), device="meta"), seed=4)
            if head == "anchor":  # detections at the gate of 0.5
                for h in ("head_p3", "head_p4", "head_p5"):
                    v["params"][h]["pred"]["bias"].reshape(3, -1)[:, 4] += 4.6
            states[head] = from_flax_variables(v, YOLO(_cfg(img, head)))
        job["eval"] = dict(cfg=dict(num_classes=NC, img_size=img,
                                    width_mult=0.25, depth_mult=0.33),
                           state=states, k=K,
                           val=str(det.parent / "val" / "images"))
        mesh = (n_data, n_space, img)
        jobs[mesh] = (job, ref, variables)
        world = n_data * n_space
        sub = tmp / f"m{n_data}x{n_space}_{img}"
        sub.mkdir()
        torch.save(job, sub / "job.pt")
        outs[mesh] = [sub / f"rank{r}.pt" for r in range(world)]
        procs += [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(world), str(n_space),
             str(sub / "store"), str(sub / "job.pt"), str(sub / f"rank{r}.pt")],
            cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for r in range(world)]
    # --multi-scale --compact-targets under --spatial 2, two processes
    yaml_path = make_dataset(tmp / "ms", n_train=4, n_val=2, img_size=MS_IMG,
                             seed=1, num_classes=NC)
    coordinator = f"127.0.0.1:{_free_port()}"
    cli_procs = [subprocess.Popen(
        [sys.executable, str(REPO / "train_torch.py"), *_cli_args(yaml_path),
         "--data-parallel", "--spatial", "2", "--distributed",
         "--coordinator", coordinator, "--num-processes", "2",
         "--process-id", str(r)], cwd=tmp / "ms", stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for r in range(2)]
    # JAX's steps on its 1 x 2 mesh at 96 while the ranks run (JAX_MESH)
    jax_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jax_procs = _start_jax_steps(*jobs[JAX_MESH][1:], tmp, jax_env)
    try:
        results = [p.communicate(timeout=JOIN_S) for p in procs]
        cli_results = [p.communicate(timeout=JOIN_S) for p in cli_procs]
        refs = {}
        for name, (p, out) in jax_procs.items():
            _, err = p.communicate(timeout=JOIN_S)
            assert p.returncode == 0, err[-3000:]
            with open(out, "rb") as f:
                refs[name] = pickle.load(f)
    finally:
        for p in procs + cli_procs + [p for p, _ in jax_procs.values()]:
            p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    got = {m: [torch.load(f, weights_only=False) for f in files]
           for m, files in outs.items()}
    cli_outs = []
    for p, (out, err) in zip(cli_procs, cli_results):
        assert p.returncode == 0, (out[-2000:], err[-3000:])
        cli_outs.append(out)
    return dict(got=got, jobs=jobs, refs=refs, cli=cli_outs,
                ms_yaml=yaml_path, tmp=tmp)


def _blocks(ranks, n_space, take, dim=2):
    """The whole tensor from every rank's row block (rows at `dim`): the
    blocks joined within a data shard, the shards along the batch."""
    shards = [torch.cat([take(ranks[d * n_space + s]) for s in
                         range(n_space)], dim=dim)
              for d in range(len(ranks) // n_space)]
    return torch.cat(shards, dim=0)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
@pytest.mark.parametrize("op", ["halo", "conv_s1", "conv_s2", "pool",
                                "gather"])
def test_halo_exchange_and_gather_match_unsharded(meshes, mesh, op):
    n_data, n_space, img = mesh
    ranks = meshes["got"][mesh]
    job = meshes["jobs"][mesh][0]
    _, x, w, dy = next(c for c in job["ops"] if c[0] == op)
    b = x.shape[0] // n_data
    if op == "halo":
        # each rank's tile is its rows of the padded tensor, bit for bit;
        # dx the sum of the tiles' dy over the rows each covers
        pad = F.pad(torch.from_numpy(x).permute(0, 3, 1, 2), (0, 0, 2, 2))
        dx = torch.zeros_like(pad)
        dyt = torch.from_numpy(dy).permute(0, 3, 1, 2)
        for r, out in enumerate(ranks):
            d, s = divmod(r, n_space)
            start, rows = job["starts"][s], out["ops"][op][0].shape[2]
            batch = slice(d * b, (d + 1) * b)
            assert torch.equal(out["ops"][op][0],
                               pad[batch, :, start:start + rows])
            dx[batch, :, start:start + rows] += dyt[batch, :,
                                                    start:start + rows]
        got = _blocks(ranks, n_space, lambda r: r["ops"][op][1])
        torch.testing.assert_close(got, dx[:, :, 2:-2], rtol=0, atol=0)
        return
    if op == "gather":
        # every rank of a data shard holds its whole images; dx its rows
        for r, out in enumerate(ranks):
            d = r // n_space
            assert torch.equal(out["ops"][op][0],
                               torch.from_numpy(x[d * b:(d + 1) * b]))
        got = _blocks(ranks, n_space, lambda r: r["ops"][op][1], dim=1)
        assert torch.equal(got, torch.from_numpy(dy))
        return
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = _op_reference_nchw(op, xt, w)
    y.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    got_y = _blocks(ranks, n_space, lambda r: r["ops"][op][0])
    got_dx = _blocks(ranks, n_space, lambda r: r["ops"][op][1])
    if op == "pool":
        assert torch.equal(got_y, y.detach())
    for a, ref in ((got_y, y.detach()), (got_dx, xt.grad)):
        torch.testing.assert_close(a, ref, rtol=0,
                                   atol=OP_TOL * ref.abs().max().item())


def _op_reference_nchw(name, t, w):
    if name == "conv_s1":
        return F.conv2d(t, w, padding=1)
    if name == "conv_s2":
        return F.conv2d(t, w, stride=2, padding=1)
    return F.max_pool2d(t, 5, 1, 2)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_batchnorm_statistics_span_the_world(meshes, mesh):
    """Unequal blocks weigh each rank by its elements: the statistics of
    the whole batch on every rank (1e-6), dx of each block (1e-6 of the
    max), the summed scale and bias gradients (1e-5 of the max)."""
    _, n_space, _ = mesh
    ranks = meshes["got"][mesh]
    x, scale, bias, dy = meshes["jobs"][mesh][0]["bn"]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    st, bt = (torch.from_numpy(t).requires_grad_() for t in (scale, bias))
    y, mu, var = bn_silu_train(xt, st, bt)
    y.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    tol = dict(rtol=0, atol=1e-6)
    for r in ranks:
        torch.testing.assert_close(r["bn"][1], mu, **tol)
        torch.testing.assert_close(r["bn"][2], var, **tol)
        assert torch.equal(r["bn"][1], ranks[0]["bn"][1])
    torch.testing.assert_close(_blocks(ranks, n_space, lambda r: r["bn"][0]),
                               y.detach(), **tol)
    torch.testing.assert_close(_blocks(ranks, n_space, lambda r: r["bn"][3]),
                               xt.grad, rtol=0,
                               atol=1e-6 * xt.grad.abs().max().item())
    for i, want in ((4, st.grad), (5, bt.grad)):
        torch.testing.assert_close(sum(r["bn"][i] for r in ranks), want,
                                   rtol=0, atol=1e-5 * want.abs().max().item())


def _single_step(job, name):
    """One process's step of the port on the whole batch of `job`'s step
    `name`: (loss, gradients, state)."""
    from yolo_from_scratch_tpu_torch.train import steps

    spec = job["steps"][name]
    cfg = YoloConfig(**spec["cfg"])
    model = YOLO(cfg)
    model.load_state_dict(spec["state"])
    state = steps.TrainState(model, steps.make_optimizer(model.parameters(),
                                                         LR))
    clip, seen = steps.clip_by_global_norm_, {}

    def recording_clip(grads, *a, **kw):
        seen["grads"] = [g.clone() for g in grads]
        return clip(grads, *a, **kw)

    steps.clip_by_global_norm_ = recording_clip
    try:
        state, m = steps.make_train_step(cfg, **spec["kw"])(
            state, torch.from_numpy(spec["images"]),
            [torch.from_numpy(t) for t in spec["targets"]])
    finally:
        steps.clip_by_global_norm_ = clip
    return (m["loss"].item(),
            dict(zip([k for k, _ in model.named_parameters()], seen["grads"])),
            model.state_dict())


def _ranks_equal(got):
    for other in got[1:]:
        for key in ("grads", "state"):
            for k, v in got[0][key].items():
                assert torch.equal(v, other[key][k]), (key, k)


@pytest.mark.parametrize("mesh", [m for m in MESHES if m[2] == 96],
                         ids=[i for i in IDS if i.endswith("@96")])
@pytest.mark.parametrize("name", ["compact", "sparse", "af"])
def test_uneven_step_matches_jax(meshes, mesh, name):
    """The three compact steps at 96 (2 / 1 and 1 / 1 / 1 / 0 P5 rows)
    against JAX's step on its 1 x 2 mesh, which pads the shards."""
    got = [r["steps"][name] for r in meshes["got"][mesh]]
    _ranks_equal(got)
    job = meshes["jobs"][mesh][0]
    cfg = _cfg(mesh[2], "anchor_free" if name == "af" else "anchor")
    loss, grads, params, batch_stats = meshes["refs"][name]
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


@pytest.mark.parametrize("name", ["compact", "sparse", "af"])
def test_uneven_step_at_160_matches_one_process(meshes, name):
    """The three compact steps on 1 x 4 @160 (2 / 1 / 1 / 1 P5 rows)
    against one process of the port (itself held to JAX's step by
    `tests/test_torch_compact_step.py`, `test_torch_sparse_loss.py` and
    `test_torch_anchor_free.py`): the loss within 1e-5 relative, the
    gradients within 1e-3 of each tensor's largest magnitude (the pre-BN
    biases left out: float noise around 0), the BatchNorm statistics
    within 1e-5 of it (phase 22's tolerances on the card)."""
    mesh = (1, 4, 160)
    got = [r["steps"][name] for r in meshes["got"][mesh]]
    _ranks_equal(got)
    loss, grads, state = _single_step(meshes["jobs"][mesh][0], name)
    total = sum(r["metrics"]["loss"] for r in got)
    rtol = 1e-5 if name == "af" else 1e-6
    np.testing.assert_allclose(total, loss, rtol=rtol)
    for k, g in got[0]["grads"].items():
        if k not in PRE_BN_BIASES:
            torch.testing.assert_close(
                g, grads[k], rtol=0, atol=1e-3 * grads[k].abs().max().item())
    for k, t in got[0]["state"].items():
        if k.endswith((".bn.mean", ".bn.var")):
            torch.testing.assert_close(
                t, state[k], rtol=0, atol=1e-5 * state[k].abs().max().item())


_SINGLE_EVAL = {}


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
def test_uneven_eval_counts_equal_one_process(meshes, mesh, head):
    """The grid counts of the odd split on compact labels through the
    spatial eval step equal one process's on every rank, exactly."""
    from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
    from yolo_from_scratch_tpu_torch.train import loop
    from yolo_from_scratch_tpu_torch.train.steps import make_eval_step

    ev = meshes["jobs"][mesh][0]["eval"]
    key = (mesh[2], head)
    if key not in _SINGLE_EVAL:  # the two meshes at 96 share one split
        cfg = _cfg(mesh[2], head)
        model = YOLO(cfg)
        model.load_state_dict(ev["state"][head])
        ds = YoloDataset(ev["val"], NC, cfg.anchors_array, cfg.img_size,
                         backend="pil", head_type=head)
        assert len(ds) == N_VAL
        original = loop.prf1
        loop.prf1 = lambda tp, fp, fn: (tp, fp, fn)
        try:
            _SINGLE_EVAL[key] = loop.eval_epoch(
                make_eval_step(cfg, compact_targets=True), model.eval(),
                DataLoader(ds, batch_size=2, compact=K), "cpu")
        finally:
            loop.prf1 = original
    single = _SINGLE_EVAL[key]
    for r in meshes["got"][mesh]:
        _, *counts = r["eval"][head]
        assert tuple(counts) == single[1:]
    if head == "anchor":
        assert sum(counts) > 0


def test_cli_multi_scale_compact_under_uneven_blocks(meshes, tmp_path,
                                                     monkeypatch, capsys):
    """`--multi-scale --compact-targets --spatial 2` at 128 trains the
    buckets 96 / 128 / 160 on both ranks (3 and 5 P5 rows split 2 / 1 and
    3 / 2): the same epoch lines on both, their losses within the printed
    digit (1e-4) of one process's run of the same global batch."""
    outs = meshes["cli"]
    for out in outs:
        assert "Multi-scale buckets: [96, 128, 160] (epoch-rotated)" in out
        assert "2-D mesh: data=1 x space=2 over 2 process(es)" in out
    lines = [EPOCH.findall(out) for out in outs]
    assert len(lines[0]) == 3 and lines[0] == lines[1]
    monkeypatch.chdir(tmp_path)
    assert cli.main(_cli_args(meshes["ms_yaml"])) == 0
    single = EPOCH.findall(capsys.readouterr().out)
    assert len(single) == 3
    for a, b in zip(lines[0], single):
        assert abs(float(a) - float(b)) <= 1e-4 + 1e-9, (a, b)
