"""The port's spatial partitioning (`--spatial N`: `parallel/mesh.py`'s 2-D
`data x space` mesh, `parallel/spatial.py`'s halo exchange and row
gather, the row-sharded model, losses, metrics and steps, the CLI) against
the JAX package, on the CPU.

The host-side rules are held bit for bit: `make_mesh_2d`'s rank layout
and its ValueError against JAX's on the 8-device virtual mesh, and this
rank's slices of a host batch against the addressable shards of JAX's
`image_sharding`, `target_sharding` and `batch_sharding_for`.

The rest runs in processes joined by `gloo` through a file store in the
test's directory, on three meshes at once: 1 x 2, 2 x 2 and 1 x 4 (data
x space). Each rank checks

- the halo exchange alone, forward and backward, against the unsharded
  op: a stride-1 and a stride-2 3x3 conv within 1e-6 of the largest
  magnitude, a 5x5 pool's forward exactly and its backward within 1e-6
  (an input row near a block's edge sums the windows of two blocks, its
  own first, in another order than the unsharded pool), and the pool at
  one row a rank, whose halo of 2 comes from ranks further away;
- train-mode BatchNorm on row blocks against the whole batch (statistics
  over data x space at 1e-6);
- one step of the dense anchor head, the compact anchor head with the
  sparse loss and device augmentation, and the compact anchor-free head,
  128 px, width 0.25, nc=3, float32, a global batch of 4. The JAX
  reference is its single-device step on the same batch, jitted once a
  path: compiling the step over each of the three meshes took about 12 s
  a path and mesh on this CPU, and `tests/test_sharding.py`
  (`test_gradients_2d_spatial_sharding_match`) pins JAX's 2-D mesh step
  to its single-device step at 2e-4. Tolerances are
  `tests/test_torch_parallel.py`'s: the global loss (the ranks' parts
  summed) within 1e-4 relative; the summed gradient within 2e-2 of each
  tensor's largest magnitude (2e-4 absolute for the conv biases in front
  of a BatchNorm); every parameter's change within 2 * lr of JAX's and
  90% of each tensor's within 0.05 * lr; the BatchNorm statistics 1e-3
  relative and 1e-4 of the largest magnitude. All ranks' gradients,
  weights and statistics are equal bit for bit.

Evaluation is exact: the grid counts of an odd split through the spatial
eval step (both heads), and the CLI's evaluation mode with
`--data-parallel --spatial 2`, equal one process's. The CLI trains in two
processes with `--distributed --spatial 2`, and the new flag rules exit
as the JAX CLI's do.
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
import torch.nn.functional as F
from test_torch_train import PRE_BN_BIASES

from yolo_from_scratch_tpu.config import YoloConfig
from yolo_from_scratch_tpu.data.assign_device import pack_labels
from yolo_from_scratch_tpu.data.dataset import assign_targets
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu.parallel import mesh as jax_mesh
from yolo_from_scratch_tpu.train.steps import _make_expand as jax_expand
from yolo_from_scratch_tpu.train.steps import _make_loss_fn
from yolo_from_scratch_tpu.train.steps import make_optimizer as jax_optimizer
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
    to_flax_variables,
)

NC, IMG, B, K = 3, 128, 4, 8
LR = 1e-5
SEED = 5  # the augmentation's
JOIN_S = 300
REPO = Path(__file__).resolve().parents[1]
MESHES = ((1, 2), (2, 2), (1, 4))  # (data, space)
N_VAL = 5  # the odd val split of the sharded evaluation
# the halo cases: (name, NHWC shape of the input, what runs on it)
OPS = (("conv_s1", (4, 8, 6, 4)), ("conv_s2", (4, 8, 6, 4)),
       ("pool", (4, 8, 6, 4)), ("pool_wide", (4, 4, 6, 4)))
# the convs and the pools' backward, of the largest magnitude; the pools'
# forward exact
OP_TOL = 1e-6


@pytest.mark.parametrize("k,n", [(2, 2), (4, 2), (4, 4), (8, 2), (8, 4),
                                 (8, 8), (6, 3)])
def test_make_mesh_2d_layout_equals_jax(k, n):
    """Rank r sits where JAX's reshape puts device r: the port's (data,
    space) indices of every rank equal the device grid's."""
    grid = jax_mesh.make_mesh_2d(n, devices=jax.devices()[:k]).devices
    for d in range(grid.shape[0]):
        for s in range(grid.shape[1]):
            r = jax.devices().index(grid[d, s])
            mesh = port_mesh.Mesh(r, k, torch.device("cpu"), n_space=n)
            assert (mesh.data_index, mesh.space_index) == (d, s)
            assert (mesh.n_data, mesh.n_space) == grid.shape


@pytest.mark.parametrize("k,n", [(8, 3), (4, 3), (2, 4)])
def test_make_mesh_2d_refuses_as_jax(k, n, monkeypatch):
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh_2d(n, devices=jax.devices()[:k])
    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(port_mesh.dist, "get_world_size", lambda: k)
    with pytest.raises(ValueError) as got:
        port_mesh.make_mesh_2d(n)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k,n", [(4, 2), (4, 4), (8, 2), (2, 1)])
def test_row_slices_equal_jax_shards(k, n):
    """Each rank's slice of images, dense targets, compact labels and
    counts equals the addressable shard JAX places on its device."""
    rng = np.random.default_rng(k * 10 + n)
    images = rng.random((8, 16, 12, 3)).astype(np.float32)
    targets = rng.random((8, 8, 8, 3, 6)).astype(np.float32)
    labels = rng.random((8, K, 5)).astype(np.float32)
    counts = rng.integers(0, K, 8).astype(np.int32)
    jmesh = jax_mesh.make_mesh_2d(n, devices=jax.devices()[:k])
    cases = ((images, jax_mesh.image_sharding(jmesh),
              port_mesh.image_sharding),
             (targets, jax_mesh.target_sharding(jmesh),
              port_mesh.target_sharding))
    cases += tuple((a, jax_mesh.batch_sharding_for(jmesh, a),
                    port_mesh.batch_sharding_for)
                   for a in (images, targets, labels, counts))
    for arr, sharding, port_fn in cases:
        placed = jax.device_put(arr, sharding)
        for shard in placed.addressable_shards:
            r = jax.devices().index(shard.device)
            mesh = port_mesh.Mesh(r, k, torch.device("cpu"), n_space=n)
            got = port_fn(mesh, arr)
            assert got.dtype == arr.dtype
            np.testing.assert_array_equal(got, np.asarray(shard.data))
            if port_fn is port_mesh.image_sharding:
                got_i, (got_t, got_l, got_c) = port_mesh.shard_batch(
                    mesh, images, [targets, labels, counts])
                np.testing.assert_array_equal(got_i, got)
                np.testing.assert_array_equal(
                    got_t, port_mesh.target_sharding(mesh, targets))
                np.testing.assert_array_equal(
                    got_l, port_mesh.batch_sharding(mesh, labels))
                np.testing.assert_array_equal(
                    got_c, port_mesh.batch_sharding(mesh, counts))


def test_no_space_axis_changes_nothing():
    """A 1-D mesh is its own data view; `local_rows` is the identity
    outside a 2-D mesh; `space_rows` leaves a batch whole."""
    mesh = port_mesh.Mesh(1, 2, torch.device("cpu"), group=object())
    assert mesh.data_view() is mesh and not mesh.spatial
    x = np.arange(8.0).reshape(2, 4)
    assert port_mesh.space_rows(mesh, x) is x
    assert port_mesh.local_rows(5) == (0, 5)
    with port_mesh.data_parallel(mesh):
        assert port_mesh.local_rows(5) == (0, 5)
        assert port_mesh.spatial_mesh() is None
    spatial = port_mesh.Mesh(3, 4, torch.device("cpu"), group=object(),
                             n_space=2, space_group=object())
    with port_mesh.data_parallel(spatial):
        assert port_mesh.local_rows(5) == (5, 10)
        assert port_mesh.spatial_mesh() is spatial


# --- the ranks ------------------------------------------------------------

WORKER = r"""
import contextlib
import io
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from yolo_from_scratch_tpu_torch import cli
from yolo_from_scratch_tpu_torch.config import YoloConfig
from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
from yolo_from_scratch_tpu_torch.models.blocks import maxpool_same
from yolo_from_scratch_tpu_torch.models.fused_bn import bn_silu_train
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.parallel.mesh import (
    batch_sharding_for, data_parallel, image_sharding, make_mesh_2d)
from yolo_from_scratch_tpu_torch.parallel.spatial import halo_rows
from yolo_from_scratch_tpu_torch.train import loop, metrics, steps

rank, world, n_space, store, job_path, out_path = sys.argv[1:7]
rank, world, n_space = int(rank), int(world), int(n_space)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
mesh = make_mesh_2d(n_space, "cpu")
job = torch.load(job_path, weights_only=False)
out = {"steps": {}, "ops": {}}

# the subgroups: who is in this rank's space group and data group
for key, group in (("space", mesh.space_group), ("data", mesh.data_group)):
    member = torch.zeros(world)
    member[rank] = 1.0
    if group is not None:
        dist.all_reduce(member, group=group)
    out[key] = member.nonzero().flatten().tolist()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


# the halo exchange alone: this rank's block of the output and of dx
for name, x_full, w, dy_full in job["ops"]:
    x = nchw(image_sharding(mesh, x_full)).requires_grad_()
    with data_parallel(mesh):
        if name == "conv_s1":
            y = F.conv2d(halo_rows(x, 1, 1, 0.0, mesh), w, padding=(0, 1))
        elif name == "conv_s2":
            y = F.conv2d(halo_rows(x, 1, 0, 0.0, mesh), w, stride=2,
                         padding=(0, 1))
        else:
            y = maxpool_same(x, 5)
    y.backward(nchw(image_sharding(mesh, dy_full)))
    out["ops"][name] = (y.detach(), x.grad)

# train-mode BatchNorm on row blocks: statistics over data x space
x = nchw(image_sharding(mesh, job["bn"][0])).requires_grad_()
scale, bias = (torch.from_numpy(t).requires_grad_() for t in job["bn"][1:3])
with data_parallel(mesh):
    y, mu, var = bn_silu_train(x, scale, bias)
    y.backward(nchw(image_sharding(mesh, job["bn"][3])))
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
    images = image_sharding(mesh, spec["images"])
    targets = [batch_sharding_for(mesh, t) for t in spec["targets"]]
    state, m = step(state, torch.from_numpy(np.ascontiguousarray(images)),
                    [torch.from_numpy(np.ascontiguousarray(t))
                     for t in targets])
    names = [k for k, _ in model.named_parameters()]
    out["steps"][name] = {
        "metrics": {k: v.item() for k, v in m.items()},
        "grads": dict(zip(names, seen["grads"])),
        "state": {k: v.clone() for k, v in model.state_dict().items()}}

if "cli" in job:
    # the CLI's evaluation mode on this process group
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(job["cli"])
    out["cli"] = (rc, buf.getvalue())
# the accumulating step: n_accum micro-batches, each sliced as a batch
acc = job["accum"]
cfg = YoloConfig(**acc["cfg"])
model = YOLO(cfg)
model.load_state_dict(acc["state"])
state = steps.TrainState(model, steps.make_optimizer(model.parameters(),
                                                     acc["lr"]))
micro = [np.stack([np.ascontiguousarray(image_sharding(mesh, m))
                   for m in a]) for a in (acc["images"], *acc["targets"])]
state, m = steps.make_train_step_accum(cfg, len(acc["images"]), mesh=mesh)(
    state, *(torch.from_numpy(a) for a in micro))
out["accum"] = {"loss": m["loss"].item(), "grads": dict(zip(
    [n for n, _ in model.named_parameters()], seen["grads"]))}

# host --augment: the first batch of this rank's data shard, its draws
aug = DataLoader(YoloDataset(job["eval"]["val"], 3, None, 128, backend="pil",
                             augment=True, seed=7),
                 batch_size=2, shuffle=True, seed=7, prefetch=0,
                 process_shard=(mesh.data_index, mesh.n_data))
out["augment"] = next(iter(aug))[0]

# evaluation of an odd split: each data shard its unpadded slice, each
# rank its rows; the raw counts (prf1 reports them unchanged here)
metrics.prf1 = loop.prf1 = lambda tp, fp, fn: (tp, fp, fn)
ev = job["eval"]
out["eval"] = {}
for head, compact in (("anchor", 0), ("anchor_free", ev["k"])):
    cfg = YoloConfig(**ev["cfg"], head_type=head)
    model = YOLO(cfg)
    model.load_state_dict(ev["state"][head])
    ds = YoloDataset(ev["val"], cfg.num_classes, cfg.anchors_array,
                     cfg.img_size, backend="pil", head_type=head)
    loader = DataLoader(ds, batch_size=2, compact=compact,
                        process_shard=(mesh.data_index, mesh.n_data),
                        pad_shard=False)
    eval_step = steps.make_eval_step(cfg, compact_targets=bool(compact),
                                     mesh=mesh)
    out["eval"][head] = loop.eval_epoch(eval_step, model.eval(), loader,
                                        "cpu", mesh)
torch.save(out, out_path)
dist.destroy_process_group()
"""


def _cfg(head="anchor"):
    return YoloConfig(num_classes=NC, img_size=IMG, width_mult=0.25,
                      depth_mult=0.33, head_type=head)


def _cfg_kw(head="anchor"):
    return dict(num_classes=NC, img_size=IMG, width_mult=0.25,
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
    """The three steps' inputs: (port job, JAX inputs) by name, as
    `tests/test_torch_parallel.py` makes them at 128 px."""
    rng = np.random.default_rng(0)
    port, ref = {}, {}
    cfg = _cfg()
    images, boxes, classes = _compact(rng)
    images = images.astype(np.float32) / 255
    dense = [np.stack(t) for t in zip(*(
        assign_targets(b, c, cfg.anchors_array, IMG, NC)
        for b, c in zip(boxes, classes)))]
    port["dense"] = (cfg, images, dense, {})
    ref["dense"] = (cfg, images, dense, {})
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
    cfg = _cfg("anchor_free")
    images, boxes, classes = _compact(rng)
    labels, counts = pack_labels(boxes, classes, K)
    port["af"] = (cfg, images, [labels, counts], dict(compact_targets=True))
    ref["af"] = (cfg, *jax_expand(cfg, True)(0, images, (labels, counts)),
                 dict(af_compact=True))
    return port, ref


def _ops():
    """The halo cases' (name, x NHWC, w or None, dy NHWC) and BatchNorm's
    (x, scale, bias, dy), from one seed."""
    rng = np.random.default_rng(11)
    ops = []
    for name, shape in OPS:
        x = rng.standard_normal(shape).astype(np.float32)
        w = (torch.from_numpy(rng.standard_normal((5, 4, 3, 3))
                              .astype(np.float32))
             if name.startswith("conv") else None)
        y = _op_reference(name, torch.from_numpy(x).permute(0, 3, 1, 2), w)
        dy = rng.standard_normal(y.permute(0, 2, 3, 1).shape).astype(
            np.float32)
        ops.append((name, x, w, dy))
    bn = (rng.standard_normal((4, 16, 6, 5)).astype(np.float32),
          rng.uniform(0.5, 1.5, 5).astype(np.float32),
          rng.uniform(-0.5, 0.5, 5).astype(np.float32),
          rng.standard_normal((4, 16, 6, 5)).astype(np.float32))
    return ops, bn


def _op_reference(name, x, w):
    """The unsharded op of a halo case on NCHW x."""
    if name == "conv_s1":
        return F.conv2d(x, w, padding=1)
    if name == "conv_s2":
        return F.conv2d(x, w, stride=2, padding=1)
    return F.max_pool2d(x, 5, 1, 2)


def _det_split(root):
    """An odd val split (N_VAL images) for the sharded evaluation."""
    from yolo_from_scratch_tpu_torch.utils.synth import make_dataset

    return make_dataset(root, n_train=2, n_val=N_VAL, img_size=IMG, seed=3,
                        num_classes=NC)


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


def _jax_step(cfg, variables, images, targets, loss_kw):
    """JAX's single-device step: (loss, gradients, new params, new
    batch_stats)."""
    loss_fn = _make_loss_fn(JaxYOLO(cfg), cfg, False, **loss_kw)
    (total, (new_bs, *_)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                variables["batch_stats"], np.asarray(images),
                                jax.tree_util.tree_map(np.asarray, targets))
    tx = jax_optimizer(LR)

    def adam(grads, params):
        # jitted: op by op, each leaf's update compiles on its own
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    params = jax.jit(adam)(grads, variables["params"])
    return float(total), *jax.device_get((grads, params, new_bs))


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Every rank's results on the three meshes, the job they ran and the
    JAX references, by mesh."""
    tmp = tmp_path_factory.mktemp("spatial")
    port, ref = _jobs()
    job = {"steps": {}, "eval": {}}
    job["ops"], job["bn"] = _ops()
    variables = {}
    for name, (cfg, images, targets, kw) in port.items():
        variables[name] = random_variables(YOLO(cfg, device="meta"), seed=3)
        job["steps"][name] = dict(
            cfg=_cfg_kw(cfg.head_type),
            state=from_flax_variables(variables[name], YOLO(cfg)), lr=LR,
            images=images, targets=targets, kw=kw)
    cfg, images, targets, _ = port["dense"]
    job["accum"] = dict(
        job["steps"]["dense"],
        images=images.reshape(2, B // 2, *images.shape[1:]),
        targets=[t.reshape(2, B // 2, *t.shape[1:]) for t in targets])
    yaml_path = _det_split(tmp / "det")
    states = {}
    for head in ("anchor", "anchor_free"):
        v = random_variables(YOLO(_cfg(head), device="meta"), seed=4)
        if head == "anchor":  # detections at the gate of 0.5
            for h in ("head_p3", "head_p4", "head_p5"):
                v["params"][h]["pred"]["bias"].reshape(3, -1)[:, 4] += 4.6
        states[head] = from_flax_variables(v, YOLO(_cfg(head)))
    job["eval"] = dict(cfg=dict(num_classes=NC, img_size=IMG,
                                width_mult=0.25, depth_mult=0.33),
                       state=states, val=str(tmp / "det" / "val" / "images"),
                       k=K)
    from yolo_from_scratch_tpu_torch.utils.checkpoint import save_checkpoint

    ckpt = tmp / "eval.ckpt"
    save_checkpoint(ckpt, to_flax_variables(states["anchor"]), _cfg())
    eval_argv = [str(yaml_path), str(ckpt), "--device", "cpu",
                 "--batch-size", "2", "--compact-targets", str(K)]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    cmds, outs = [], {}
    for n_data, n_space in MESHES:
        world = n_data * n_space
        sub = tmp / f"m{n_data}x{n_space}"
        sub.mkdir()
        mesh_job = dict(job)
        if (n_data, n_space) == (1, 2):
            mesh_job["cli"] = eval_argv + ["--data-parallel", "--spatial",
                                           "2"]
        torch.save(mesh_job, sub / "job.pt")
        outs[(n_data, n_space)] = [sub / f"rank{r}.pt" for r in range(world)]
        cmds += [[sys.executable, "-c", WORKER, str(r), str(world),
                  str(n_space), str(sub / "store"), str(sub / "job.pt"),
                  str(sub / f"rank{r}.pt")] for r in range(world)]
    procs = [subprocess.Popen(c, cwd=tmp, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for c in cmds]
    try:
        # the JAX references while the ranks run
        jax_ref = {name: _jax_step(cfg, variables[name], images, targets,
                                   loss_kw)
                   for name, (cfg, images, targets, loss_kw) in ref.items()}
        results = [p.communicate(timeout=JOIN_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    got = {m: [torch.load(f, weights_only=False) for f in files]
           for m, files in outs.items()}
    return got, job, jax_ref, eval_argv


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2", "1x4"])
def test_subgroups_follow_the_layout(meshes, mesh):
    got, *_ = meshes
    n_data, n_space = mesh
    for r, out in enumerate(got[mesh]):
        d, s = divmod(r, n_space)
        assert out["space"] == ([d * n_space + i for i in range(n_space)])
        assert out["data"] == ([i * n_space + s for i in range(n_data)]
                               if n_data > 1 else [r])


def _blocks(ranks, n_space, take):
    """The whole NCHW tensor from every rank's row block: blocks joined
    along the rows within a data shard, shards along the batch."""
    shards = [torch.cat([take(ranks[d * n_space + s]) for s in
                         range(n_space)], dim=2)
              for d in range(len(ranks) // n_space)]
    return torch.cat(shards, dim=0)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2", "1x4"])
@pytest.mark.parametrize("op", [name for name, _ in OPS])
def test_halo_exchange_matches_unsharded(meshes, mesh, op):
    """Forward and backward of the row blocks joined equal the unsharded
    op's within OP_TOL of the largest magnitude, the pools' forward bit
    for bit (at 4 rows a rank and at 1, whose halo of 2 spans two
    neighbours)."""
    got, job, _, _ = meshes
    _, x, w, dy = next(c for c in job["ops"] if c[0] == op)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    want = _op_reference(op, xt, w)
    want.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    ranks = got[mesh]
    y = _blocks(ranks, mesh[1], lambda r: r["ops"][op][0])
    dx = _blocks(ranks, mesh[1], lambda r: r["ops"][op][1])
    if op.startswith("pool"):
        assert torch.equal(y, want.detach())
    for a, b in ((y, want.detach()), (dx, xt.grad)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=OP_TOL * b.abs().max().item())


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2", "1x4"])
def test_batchnorm_statistics_span_the_world(meshes, mesh):
    """`models/fused_bn.py` on row blocks: the statistics of the whole
    batch (its all-reduce over data x space, shares 1 / world), the same
    on every rank; dx of each block and the scale and bias gradients
    summed over the ranks equal the whole batch's."""
    got, job, _, _ = meshes
    x, scale, bias, dy = job["bn"]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    st, bt = (torch.from_numpy(t).requires_grad_() for t in (scale, bias))
    y, mu, var = bn_silu_train(xt, st, bt)
    y.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    ranks = got[mesh]
    tol = dict(rtol=0, atol=1e-6)
    for r in ranks:
        torch.testing.assert_close(r["bn"][1], mu, **tol)
        torch.testing.assert_close(r["bn"][2], var, **tol)
        assert torch.equal(r["bn"][1], ranks[0]["bn"][1])
    torch.testing.assert_close(_blocks(ranks, mesh[1], lambda r: r["bn"][0]),
                               y.detach(), **tol)
    torch.testing.assert_close(_blocks(ranks, mesh[1], lambda r: r["bn"][3]),
                               xt.grad, rtol=0,
                               atol=1e-6 * xt.grad.abs().max().item())
    for i, want in ((4, st.grad), (5, bt.grad)):
        torch.testing.assert_close(sum(r["bn"][i] for r in ranks), want,
                                   rtol=0, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2", "1x4"])
@pytest.mark.parametrize("name", ["dense", "sparse", "af"])
def test_spatial_step_matches_jax(meshes, mesh, name):
    got_all, job, jax_ref, _ = meshes
    got = [r["steps"][name] for r in got_all[mesh]]
    for other in got[1:]:
        for key in ("grads", "state"):
            for k, v in got[0][key].items():
                assert torch.equal(v, other[key][k]), (key, k)
    cfg = _cfg("anchor_free" if name == "af" else "anchor")
    loss, grads, params, batch_stats = jax_ref[name]
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


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2", "1x4"])
def test_host_augment_draws_alike_in_a_space_group(meshes, mesh):
    """The ranks of a space group load their data shard's images with the
    same --augment draws (mosaic, flip, jitter), so an image's row blocks
    come from one augmented image; the data shards load other images."""
    got, *_ = meshes
    n_data, n_space = mesh
    for d in range(n_data):
        group = got[mesh][d * n_space:(d + 1) * n_space]
        for r in group[1:]:
            np.testing.assert_array_equal(r["augment"], group[0]["augment"])
    if n_data > 1:
        assert not np.array_equal(got[mesh][0]["augment"],
                                  got[mesh][n_space]["augment"])


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2", "1x4"])
def test_spatial_accum_step_matches_one_process(meshes, mesh):
    """`make_train_step_accum(n_accum=2)` on the mesh, each micro-batch of
    2 split as a batch, against one process on the whole micro-batches:
    the loss within 1e-5 relative, the summed gradients within 1e-3 of
    each tensor's largest magnitude (phase 8's tolerance: the port against
    itself in float32), the ranks' gradients equal."""
    from yolo_from_scratch_tpu_torch.train import steps

    got_all, job, _, _ = meshes
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
    got = [r["accum"] for r in got_all[mesh]]
    np.testing.assert_allclose(sum(r["loss"] for r in got), m["loss"].item(),
                               rtol=1e-5)
    for (k, g), want in zip(got[0]["grads"].items(), seen["grads"]):
        for other in got[1:]:
            assert torch.equal(g, other["grads"][k]), k
        if k not in PRE_BN_BIASES:
            torch.testing.assert_close(g, want, rtol=0,
                                       atol=1e-3 * want.abs().max().item())


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2", "1x4"])
@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
def test_spatial_eval_counts_equal_one_process(meshes, mesh, head):
    """The grid counts of the odd split (dense anchor maps, compact
    anchor-free labels) through the spatial eval step equal one
    process's on every rank; the anchor head's loss within float32
    rounding where the batches are one process's (one data shard). The
    anchor-free loss is not compared: the blocks' head outputs agree with
    one process's to rounding (3e-8 here), but TAL's top-k over these
    random weights' near-tied alignments flips on such differences, and
    the step tests hold that loss where it is continuous."""
    from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
    from yolo_from_scratch_tpu_torch.train import loop
    from yolo_from_scratch_tpu_torch.train.steps import make_eval_step

    got, job, _, _ = meshes
    ev = job["eval"]
    cfg = _cfg(head)
    model = YOLO(cfg)
    model.load_state_dict(ev["state"][head])
    compact = K if head == "anchor_free" else 0
    ds = YoloDataset(ev["val"], NC, cfg.anchors_array, IMG, backend="pil",
                     head_type=head)
    assert len(ds) == N_VAL
    counts = []
    original = loop.prf1
    loop.prf1 = lambda tp, fp, fn: (tp, fp, fn)
    try:
        single = loop.eval_epoch(
            make_eval_step(cfg, compact_targets=bool(compact)), model.eval(),
            DataLoader(ds, batch_size=2, compact=compact), "cpu")
    finally:
        loop.prf1 = original
    for r in got[mesh]:
        loss, *counts = r["eval"][head]
        assert tuple(counts) == single[1:]
        if head == "anchor" and mesh[0] == 1:
            np.testing.assert_allclose(loss, single[0], rtol=1e-5)
    if head == "anchor":
        assert sum(counts) > 0


def test_cli_evaluation_takes_the_mesh(meshes, capsys):
    """`data.yaml model.ckpt --data-parallel --spatial 2` in two processes
    prints one process's evaluation: the banner, then each split's
    P/R/F1 lines equal and the loss within the last printed digit."""
    got, _, _, eval_argv = meshes
    assert cli.main(eval_argv) == 0
    single = capsys.readouterr().out.splitlines()
    for rc, out in (r["cli"] for r in got[(1, 2)]):
        assert rc == 0, out
        lines = out.splitlines()
        assert lines[1] == "2-D mesh: data=1 x space=2 over 2 process(es)"
        assert lines[0] == single[0] and lines[2:] and len(lines) == len(
            single) + 1
        for a, b in zip(lines[2:], single[1:]):
            if a.startswith("  Loss: "):
                assert abs(float(a.split()[-1]) - float(b.split()[-1])) \
                    <= 1e-4, (a, b)
            else:
                assert a == b


# --- the CLI --------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("argv,rc,says", [
    (["--spatial", "2"], 1, "--spatial/--model-parallel require "
                            "--data-parallel"),
    (["--spatial", "2", "--model-parallel", "2", "--data-parallel"], 1,
     "--spatial and --model-parallel are mutually exclusive"),
    (["--spatial", "2", "--stream", "--data-parallel"], 1,
     "--stream does not compose with --spatial"),
    (["--spatial", "2", "--data-parallel"], 1,
     "1 devices do not divide into space=2"),
    (["--model-parallel", "2", "--data-parallel"], 1,
     "1 devices do not divide into model=2"),
])
def test_cli_spatial_flag_rules(argv, rc, says, temp_dataset_dir, capsys):
    assert cli.main([str(temp_dataset_dir / "dataset.yaml"), "--device",
                     "cpu", *argv]) == rc
    assert says in capsys.readouterr().out


@pytest.mark.parametrize("img_size,n", [(160, 2), (96, 2), (128, 8)])
def test_cli_refuses_a_p5_grid_that_does_not_divide(
        img_size, n, temp_dataset_dir, monkeypatch, capsys):
    """An --img-size whose P5 grid does not divide by N exits 1 with dense
    targets, as the JAX CLI does (its `device_put` of the dense maps
    raises), and the line says so (the mesh is faked: the refusal comes
    before any collective)."""
    def fake_mesh(n_space, device):
        return port_mesh.Mesh(0, n_space, torch.device("cpu"),
                              group=object(), n_space=n_space)

    monkeypatch.setattr(port_mesh, "make_mesh_2d", fake_mesh)
    argv = [str(temp_dataset_dir / "dataset.yaml"), "--device", "cpu",
            "--data-parallel", "--spatial", str(n), "--img-size",
            str(img_size), "--size", "n"]
    assert cli.main(argv) == 1
    out = capsys.readouterr().out
    assert f"2-D mesh: data=1 x space={n} over {n} process(es)" in out
    assert (f"--spatial {n} needs the P5 grid (img_size / 32 = "
            f"{img_size // 32} rows at {img_size}) to divide by {n} with "
            f"dense targets, as the JAX CLI does") in out
    assert "--compact-targets splits the rows unequally" in out
    assert "pads" not in out


@pytest.mark.parametrize("img_size,n,dense,refused", [
    (160, 2, True, True), (640, 3, True, True), (128, 4, True, False),
    (640, 2, True, False), (640, 4, True, False), (640, 1, True, False),
    (160, 2, False, False), (640, 3, False, False), (96, 4, False, False)])
def test_p5_rule(img_size, n, dense, refused, capsys):
    """Dense targets need a P5 grid that N divides; compact labels take
    any grid (unequal row blocks)."""
    args = cli.build_parser().parse_args(["--spatial", str(n)])
    assert cli._spatial_refused(args, _cfg().with_(img_size=img_size),
                                dense) == refused
    assert ("needs the P5 grid" in capsys.readouterr().out) == refused


def test_cli_trains_two_processes_spatial(temp_dataset_dir, tmp_path):
    """`train_torch.py --distributed --spatial 2` in two processes, the
    anchor-free head with --val-det: both print the 2-D banner and the
    same epoch line, one checkpoint, which serves a request."""
    base = [sys.executable, str(REPO / "train_torch.py"),
            str(temp_dataset_dir / "dataset.yaml"), "--device", "cpu",
            "--size", "n", "--img-size", str(IMG), "--batch-size", "2",
            "--epochs", "1", "--val-det", "--head", "anchor_free",
            "--spatial", "2", "--distributed", "--coordinator",
            f"127.0.0.1:{_free_port()}", "--num-processes", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    results = _run_ranks([base + ["--process-id", str(r)] for r in range(2)],
                         tmp_path, env)
    lines = []
    for r, (rc, out, err) in enumerate(results):
        assert rc == 0, err[-3000:]
        assert f"Distributed: process {r}/2, backend gloo" in out
        assert "2-D mesh: data=1 x space=2 over 2 process(es)" in out
        epoch = re.search(r"Epoch 1: .* \| LR: ", out)
        assert epoch and " | Det: P " in epoch.group(0), out
        lines.append(epoch.group(0))
    assert lines[0] == lines[1]
    ckpts = list(tmp_path.glob("yolo_*.ckpt"))
    assert len(ckpts) == 1
    from yolo_from_scratch_tpu_torch.utils.checkpoint import load_checkpoint

    _, cfg, _ = load_checkpoint(ckpts[0])
    assert cfg.head_type == "anchor_free"
    image = sorted((temp_dataset_dir / "val" / "images").iterdir())[0]
    assert cli.main([str(image), str(ckpts[0]), "--device", "cpu"]) == 0

@pytest.mark.parametrize("coordinator,here", [
    ("127.0.0.1:29500", True), ("localhost:1", True), ("[::1]:5", True),
    ("10.0.0.2:29500", False), ("node7:29500", False)])
def test_loopback_coordinator_is_this_host(coordinator, here):
    """Ranks that share this host's cards (more of them than cards) take
    `gloo`: a loopback coordinator puts every process here."""
    from yolo_from_scratch_tpu_torch.parallel import distributed

    assert distributed._on_this_host(coordinator) == here
