"""The port's tensor parallelism (`--model-parallel N`: `parallel/mesh.py`'s
2-D `data x model` mesh, `parallel/tensor.py`'s channel-sharded state and
convs, K2 at the global shapes, the steps, evaluation, checkpoints and the
CLI) against the JAX package, on the CPU.

The host-side rules are held bit for bit: `make_mesh_dm`'s rank layout and
its ValueError against JAX's on the 8-device virtual mesh, the sharding
rule's decision for every leaf of both heads' states against JAX's
`tp_leaf_sharding`, and `sharded_fraction` against JAX's over its sharded
params.

The rest runs in processes joined by `gloo` through a file store in the
test's directory, on three meshes at once: 1 x 2, 2 x 2 and 1 x 4 (data x
model). Each rank checks

- `gather_state_tp(shard_state_tp(s)) == s` bit for bit;
- one step of the dense anchor head, the compact anchor head with the
  sparse loss and device augmentation, and the compact anchor-free head,
  128 px, width 0.25, nc=3, float32, a global batch of 4, held to JAX's
  single-device step at `tests/test_torch_spatial.py`'s tolerances (the
  global loss within 1e-4 relative; the gathered gradient within 2e-2 of
  each tensor's largest magnitude, 2e-4 absolute for the conv biases in
  front of a BatchNorm; every parameter's change within 2 * lr of JAX's
  and 90% of each tensor's within 0.05 * lr; the BatchNorm statistics
  1e-3 relative and 1e-4 of the largest magnitude), and to the port's own
  one-process step at JAX's TP tolerance (`tests/test_tensor_parallel.py`:
  the loss 2e-5 relative, the parameters 5e-3 absolute). A sharded conv's
  weight and its Adam moments hold cout / N rows; the replicated leaves are
  equal on every rank bit for bit, and the gathered state across the data
  groups;
- the dense step with `YOLO_FUSED_CONV_BWD=1`: the gated 64-channel convs
  call K2's plain version at the global 64->64 shapes as often as one
  process does, and the step equals one process's with the switch on;
- at 1 x 2 the accumulating step (`make_train_step_accum`) against one
  process.

Evaluation is exact: the grid counts of the eval step on a batch and of
`eval_epoch` over an odd split through a cut model equal one process's
for both heads, and the CLI's evaluation mode with `--data-parallel
--model-parallel 2` in two processes prints one process's P/R/F1. The CLI
trains with `--distributed --model-parallel 2` in two processes, both
heads, printing JAX's banners with JAX's sharded fraction; its checkpoint
has the flagless run's keys and shapes, loads in the JAX package's
`load_checkpoint` and in the port's `Predictor`, and `--resume` of it
under `--model-parallel 2` continues as one process does. The flag rules
exit as the JAX CLI's do.
"""

import os
import re
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from test_torch_spatial import (
    B,
    IMG,
    JOIN_S,
    LR,
    N_VAL,
    NC,
    REPO,
    _cfg,
    _cfg_kw,
    _det_split,
    _free_port,
    _jax_step,
    _jobs,
    _run_ranks,
)
from test_torch_train import PRE_BN_BIASES

from yolo_from_scratch_tpu.parallel import tensor as jax_tensor
from yolo_from_scratch_tpu_torch import cli
from yolo_from_scratch_tpu_torch.config import YoloConfig
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import conv_bwd
from yolo_from_scratch_tpu_torch.parallel import mesh as port_mesh
from yolo_from_scratch_tpu_torch.parallel import tensor as port_tensor
from yolo_from_scratch_tpu_torch.train import steps
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
    to_flax_variables,
)

MESHES = ((1, 2), (2, 2), (1, 4))  # (data, model)
IDS = ["1x2", "2x2", "1x4"]
TP_LOSS_RTOL = 2e-5  # JAX's TP step against its single-device step
TP_PARAM_ATOL = 5e-3


@pytest.mark.parametrize("k,n", [(2, 2), (4, 2), (4, 4), (8, 2), (8, 4),
                                 (8, 8), (6, 3)])
def test_make_mesh_dm_layout_equals_jax(k, n):
    """Rank r sits where JAX's reshape puts device r: the port's (data,
    model) indices of every rank equal the device grid's."""
    grid = jax_tensor.make_mesh_dm(n, devices=jax.devices()[:k]).devices
    for d in range(grid.shape[0]):
        for m in range(grid.shape[1]):
            r = jax.devices().index(grid[d, m])
            mesh = port_mesh.Mesh(r, k, torch.device("cpu"), n_model=n)
            assert (mesh.data_index, mesh.model_index) == (d, m)
            assert (mesh.n_data, mesh.n_model) == grid.shape
            assert not mesh.spatial and mesh.space_index == 0


@pytest.mark.parametrize("k,n", [(8, 3), (4, 3), (2, 4), (1, 2)])
def test_make_mesh_dm_refuses_as_jax(k, n, monkeypatch):
    with pytest.raises(ValueError) as want:
        jax_tensor.make_mesh_dm(n, devices=jax.devices()[:k])
    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: k > 1)
    monkeypatch.setattr(port_mesh.dist, "get_world_size", lambda: k)
    with pytest.raises(ValueError) as got:
        port_mesh.make_mesh_dm(n)
    assert str(got.value) == str(want.value)


def _state_cfgs():
    """The test's config and 's' at nc=80, both heads."""
    for head in ("anchor", "anchor_free"):
        yield _cfg(head)
        yield YoloConfig.from_size("s", num_classes=80, head_type=head)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cfg", list(_state_cfgs()),
                         ids=["anchor", "anchor_s80", "af", "af_s80"])
def test_leaf_rule_equals_jax(cfg, n):
    """Every leaf of the params and BatchNorm statistics: the port's rule
    on its canonical shape gives JAX's PartitionSpec, and `sharded_keys`
    (the port's layout) holds exactly the leaves JAX does not replicate."""
    variables = random_variables(YOLO(cfg, device="meta"), seed=0)
    jmesh = jax_tensor.make_mesh_dm(n)
    model = YOLO(cfg, device="meta")
    keys = port_tensor.sharded_keys(model.state_dict(), n)
    want = set()
    for collection in ("params", "batch_stats"):
        flat = jax.tree_util.tree_flatten_with_path(variables[collection])[0]
        for path, leaf in flat:
            sharding = jax_tensor.tp_leaf_sharding(jmesh, leaf)
            assert port_tensor.tp_leaf_sharding(n, leaf.shape) \
                == tuple(sharding.spec)
            if not sharding.is_fully_replicated:
                want.add(".".join(p.key for p in path))
    got = {k.replace(".weight", ".kernel") for k in keys}
    assert got == want and keys


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cfg", list(_state_cfgs()),
                         ids=["anchor", "anchor_s80", "af", "af_s80"])
def test_sharded_fraction_equals_jax(cfg, n):
    """The banner's fraction: the port's over a cut model equals JAX's
    over the params placed by `shard_state_tp` on a data x model mesh; a
    sharded conv holds cout / N rows of its weight, bias and BatchNorm."""
    params = random_variables(YOLO(cfg, device="meta"), seed=0)["params"]
    jmesh = jax_tensor.make_mesh_dm(n)
    want = jax_tensor.sharded_fraction(jax_tensor.shard_state_tp(jmesh,
                                                                 params))
    full = YOLO(cfg, device="meta")
    shapes = {k: t.shape for k, t in full.state_dict().items()}
    model = port_tensor.shard_model_(
        YOLO(cfg, device="meta"),
        port_mesh.Mesh(1, n, torch.device("cpu"), n_model=n))
    assert port_tensor.sharded_fraction(model) == want
    assert port_tensor.sharded_fraction(full) == 0.0
    for k, t in model.state_dict().items():
        rows = shapes[k][0] // n if k in model.tp_keys else shapes[k][0]
        assert t.shape == (rows, *shapes[k][1:]), k


# --- the ranks ------------------------------------------------------------

WORKER = r"""
import contextlib
import io
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from yolo_from_scratch_tpu_torch import cli
from yolo_from_scratch_tpu_torch.config import YoloConfig
from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import conv_bwd
from yolo_from_scratch_tpu_torch.parallel.mesh import (
    batch_sharding, make_mesh_dm)
from yolo_from_scratch_tpu_torch.parallel.tensor import (
    full_state_dict, gather_state_tp, shard_model_, shard_state_tp,
    sharded_keys)
from yolo_from_scratch_tpu_torch.train import loop, metrics, steps

rank, world, n_model, store, job_path, out_path = sys.argv[1:7]
rank, world, n_model = int(rank), int(world), int(n_model)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
mesh = make_mesh_dm(n_model, "cpu")
job = torch.load(job_path, weights_only=False)
out = {"steps": {}}

# the subgroups: who is in this rank's model group and data group
for key, group in (("model", mesh.model_group), ("data", mesh.data_group)):
    member = torch.zeros(world)
    member[rank] = 1.0
    if group is not None:
        dist.all_reduce(member, group=group)
    out[key] = member.nonzero().flatten().tolist()

# the state's round trip
full = job["steps"]["dense"]["state"]
keys = sharded_keys(full, n_model)
back = gather_state_tp(mesh, shard_state_tp(mesh, full, keys), keys)
out["roundtrip"] = (sorted(back) == sorted(full) and all(
    back[k].dtype == full[k].dtype and torch.equal(back[k], full[k])
    for k in full))

clip = steps.clip_by_global_norm_
plain = conv_bwd.fused_bwd_plain
seen = {}


def recording_clip(grads, *a, **kw):
    seen["grads"] = [g.clone() for g in grads]
    return clip(grads, *a, **kw)


def recording_k2(x, dy, w):
    seen["k2"].append((tuple(x.shape), tuple(dy.shape), tuple(w.shape)))
    return plain(x, dy, w)


steps.clip_by_global_norm_ = recording_clip
conv_bwd.fused_bwd_plain = recording_k2


def cut_model(cfg, state):
    model = YOLO(cfg)
    model.load_state_dict(state)
    return shard_model_(model, mesh)


for name, spec in job["steps"].items():
    os.environ["YOLO_FUSED_CONV_BWD"] = "1" if spec["fused"] else "0"
    cfg = YoloConfig(**spec["cfg"])
    model = cut_model(cfg, spec["state"])
    state = steps.TrainState(model, steps.make_optimizer(model.parameters(),
                                                         spec["lr"]))
    step = steps.make_train_step(cfg, mesh=mesh, **spec["kw"])
    images = batch_sharding(mesh, spec["images"])
    targets = [batch_sharding(mesh, t) for t in spec["targets"]]
    seen["k2"] = []
    state, m = step(state, torch.from_numpy(np.ascontiguousarray(images)),
                    [torch.from_numpy(np.ascontiguousarray(t))
                     for t in targets])
    names = [k for k, _ in model.named_parameters()]
    grads = dict(zip(names, seen["grads"]))
    out["steps"][name] = {
        "metrics": {k: v.item() for k, v in m.items()},
        "grads": gather_state_tp(mesh, grads, model.tp_keys),
        "local": {k: v.clone() for k, v in model.state_dict().items()},
        "full": full_state_dict(model),
        "moments": {n: tuple(state.optimizer.state[p]["exp_avg"].shape)
                    for n, p in model.named_parameters()},
        "keys": model.tp_keys, "k2": seen["k2"]}
os.environ["YOLO_FUSED_CONV_BWD"] = "0"

# the clip over slices: the dense step's gathered gradients x 100 (past
# the clip's threshold), cut to this rank's rows
spec = job["steps"]["dense"]
model = cut_model(YoloConfig(**spec["cfg"]), spec["state"])
names = [n for n, _ in model.named_parameters()]
local = shard_state_tp(mesh, {k: v * 100 for k, v in
                              out["steps"]["dense"]["grads"].items()},
                       model.tp_keys)
grads = [local[n].clone() for n in names]
norm = clip(grads, **steps.clip_kwargs(model))
out["clip"] = (norm.item(), gather_state_tp(mesh, dict(zip(names, grads)),
                                            model.tp_keys))

if "accum" in job:
    # the accumulating step: n_accum micro-batches, each sliced as a batch
    acc = job["accum"]
    cfg = YoloConfig(**acc["cfg"])
    model = cut_model(cfg, acc["state"])
    state = steps.TrainState(model, steps.make_optimizer(model.parameters(),
                                                         acc["lr"]))
    micro = [np.stack([np.ascontiguousarray(batch_sharding(mesh, m))
                       for m in a]) for a in (acc["images"], *acc["targets"])]
    state, m = steps.make_train_step_accum(cfg, len(acc["images"]),
                                           mesh=mesh)(
        state, *(torch.from_numpy(a) for a in micro))
    out["accum"] = {"loss": m["loss"].item(), "grads": gather_state_tp(
        mesh, dict(zip([n for n, _ in model.named_parameters()],
                       seen["grads"])), model.tp_keys)}

if "cli" in job:
    # the CLI's evaluation mode on this process group
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(job["cli"])
    out["cli"] = (rc, buf.getvalue())

# evaluation through a cut model: the eval step on one batch, then an odd
# split, each data shard its unpadded slice; the raw counts
metrics.prf1 = loop.prf1 = lambda tp, fp, fn: (tp, fp, fn)
ev = job["eval"]
out["eval"], out["eval_step"] = {}, {}
for head, compact in (("anchor", 0), ("anchor_free", ev["k"])):
    cfg = YoloConfig(**ev["cfg"], head_type=head)
    model = cut_model(cfg, ev["state"][head]).eval()
    ds = YoloDataset(ev["val"], cfg.num_classes, cfg.anchors_array,
                     cfg.img_size, backend="pil", head_type=head)
    eval_step = steps.make_eval_step(cfg, compact_targets=bool(compact),
                                     mesh=mesh)
    if compact:
        images, labels, counts = ds.load_batch_compact(range(4), capacity=compact)
        targets = [torch.from_numpy(labels), torch.from_numpy(counts)]
    else:
        images, targets = ds.load_batch(range(4))
        targets = [torch.from_numpy(t) for t in targets]
    out["eval_step"][head] = [t.tolist() for t in eval_step(
        model, torch.from_numpy(images), targets)[1:]]
    loader = DataLoader(ds, batch_size=2, compact=compact,
                        process_shard=(mesh.data_index, mesh.n_data),
                        pad_shard=False)
    out["eval"][head] = loop.eval_epoch(eval_step, model, loader, "cpu", mesh)
torch.save(out, out_path)
dist.destroy_process_group()
"""


def _one_process_step(spec):
    """The port's own step on the whole batch, one process: (loss,
    gradients by name, state dict, K2's plain calls' shapes)."""
    os.environ["YOLO_FUSED_CONV_BWD"] = "1" if spec["fused"] else "0"
    cfg = YoloConfig(**spec["cfg"])
    model = YOLO(cfg)
    model.load_state_dict(spec["state"])
    state = steps.TrainState(model, steps.make_optimizer(model.parameters(),
                                                         spec["lr"]))
    clip, plain, seen = steps.clip_by_global_norm_, conv_bwd.fused_bwd_plain, {
        "k2": []}

    def recording_clip(grads, *a, **kw):
        seen["grads"] = [g.clone() for g in grads]
        return clip(grads, *a, **kw)

    def recording_k2(x, dy, w):
        seen["k2"].append((tuple(x.shape), tuple(dy.shape), tuple(w.shape)))
        return plain(x, dy, w)

    steps.clip_by_global_norm_ = recording_clip
    conv_bwd.fused_bwd_plain = recording_k2
    try:
        state, m = steps.make_train_step(cfg, **spec["kw"])(
            state, torch.from_numpy(spec["images"]),
            [torch.from_numpy(t) for t in spec["targets"]])
    finally:
        steps.clip_by_global_norm_ = clip
        conv_bwd.fused_bwd_plain = plain
        os.environ["YOLO_FUSED_CONV_BWD"] = "0"
    return (m["loss"].item(),
            dict(zip([n for n, _ in model.named_parameters()],
                     seen["grads"])),
            {k: v.clone() for k, v in model.state_dict().items()},
            seen["k2"])


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Every rank's results on the three meshes, the job they ran, the JAX
    references and the port's one-process steps, by mesh and step."""
    tmp = tmp_path_factory.mktemp("tensor")
    port, ref = _jobs()
    job = {"steps": {}}
    variables = {}
    for name, (cfg, images, targets, kw) in port.items():
        variables[name] = random_variables(YOLO(cfg, device="meta"), seed=3)
        job["steps"][name] = dict(
            cfg=_cfg_kw(cfg.head_type),
            state=from_flax_variables(variables[name], YOLO(cfg)), lr=LR,
            images=images, targets=targets, kw=kw, fused=False)
    # the dense step again with the K2 switch on
    job["steps"]["k2"] = dict(job["steps"]["dense"], fused=True)
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
                       k=8)
    from yolo_from_scratch_tpu_torch.utils.checkpoint import save_checkpoint

    ckpt = tmp / "eval.ckpt"
    save_checkpoint(ckpt, to_flax_variables(states["anchor"]), _cfg())
    eval_argv = [str(yaml_path), str(ckpt), "--device", "cpu",
                 "--batch-size", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    cmds, outs = [], {}
    for n_data, n_model in MESHES:
        world = n_data * n_model
        sub = tmp / f"m{n_data}x{n_model}"
        sub.mkdir()
        mesh_job = dict(job)
        if (n_data, n_model) == (1, 2):
            cfg, images, targets, _ = port["dense"]
            mesh_job["accum"] = dict(
                job["steps"]["dense"],
                images=images.reshape(2, B // 2, *images.shape[1:]),
                targets=[t.reshape(2, B // 2, *t.shape[1:]) for t in targets])
            mesh_job["cli"] = eval_argv + ["--data-parallel",
                                           "--model-parallel", "2"]
        torch.save(mesh_job, sub / "job.pt")
        outs[(n_data, n_model)] = [sub / f"rank{r}.pt" for r in range(world)]
        cmds += [[sys.executable, "-c", WORKER, str(r), str(world),
                  str(n_model), str(sub / "store"), str(sub / "job.pt"),
                  str(sub / f"rank{r}.pt")] for r in range(world)]
    import subprocess

    procs = [subprocess.Popen(c, cwd=tmp, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for c in cmds]
    try:
        # the references while the ranks run
        jax_ref = {name: _jax_step(cfg, variables[name], images, targets,
                                   loss_kw)
                   for name, (cfg, images, targets, loss_kw) in ref.items()}
        torch.set_num_threads(1)
        single = {name: _one_process_step(spec)
                  for name, spec in job["steps"].items()}
        results = [p.communicate(timeout=JOIN_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    got = {m: [torch.load(f, weights_only=False) for f in files]
           for m, files in outs.items()}
    return got, job, jax_ref, single, eval_argv


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_subgroups_follow_the_layout(meshes, mesh):
    got, *_ = meshes
    n_data, n_model = mesh
    for r, out in enumerate(got[mesh]):
        d, m = divmod(r, n_model)
        assert out["model"] == [d * n_model + i for i in range(n_model)]
        assert out["data"] == ([i * n_model + m for i in range(n_data)]
                               if n_data > 1 else [r])


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_gather_of_shard_is_the_state(meshes, mesh):
    got, *_ = meshes
    assert all(r["roundtrip"] for r in got[mesh])


def _data_losses(ranks, n_model):
    """The global loss: model index 0's parts summed over the data shards
    (a model group's ranks hold the same part)."""
    return sum(r["metrics"]["loss"] for r in ranks[::n_model])


def _ranks_agree(ranks, n_model):
    """Replicated leaves bit-equal on every rank, a rank's slices equal
    to its model index's slices in every data shard, the gathered state
    equal everywhere."""
    first = ranks[0]
    for r, other in enumerate(ranks):
        for k, v in other["local"].items():
            if k not in other["keys"]:
                assert torch.equal(v, first["local"][k]), (r, k)
            else:
                same = ranks[r % n_model]["local"][k]
                assert torch.equal(v, same), (r, k)
        for k, v in other["full"].items():
            assert torch.equal(v, first["full"][k]), (r, k)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
@pytest.mark.parametrize("name", ["dense", "sparse", "af"])
def test_tp_step_matches_jax(meshes, mesh, name):
    got_all, job, jax_ref, single, _ = meshes
    got = [r["steps"][name] for r in got_all[mesh]]
    n_model = mesh[1]
    _ranks_agree(got, n_model)
    cfg = _cfg("anchor_free" if name == "af" else "anchor")
    loss, grads, params, batch_stats = jax_ref[name]
    np.testing.assert_allclose(_data_losses(got, n_model), loss, rtol=1e-4)
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
    for k, t in got[0]["full"].items():
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


def _held_to_one_process(got, single, n_model):
    """The gathered step against the port's one-process step at JAX's TP
    tolerance: the loss 2e-5 relative, the parameters 5e-3 absolute; the
    gradients at the step tolerance of the JAX comparison."""
    loss, grads, state, k2 = single
    np.testing.assert_allclose(_data_losses(got, n_model), loss,
                               rtol=TP_LOSS_RTOL)
    for k, t in got[0]["full"].items():
        torch.testing.assert_close(t, state[k], rtol=0, atol=TP_PARAM_ATOL,
                                   msg=k)
    for k, g in got[0]["grads"].items():
        atol = 2e-4 if k in PRE_BN_BIASES else 2e-2 * grads[k].abs().max()
        torch.testing.assert_close(g, grads[k], rtol=0, atol=float(atol),
                                   msg=k)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
@pytest.mark.parametrize("name", ["dense", "sparse", "af"])
def test_tp_step_matches_one_process(meshes, mesh, name):
    got_all, _, _, single, _ = meshes
    _held_to_one_process([r["steps"][name] for r in got_all[mesh]],
                         single[name], mesh[1])


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_state_actually_sharded(meshes, mesh):
    """A sharded conv's weight and both Adam moments hold cout / N rows on
    every rank (`tests/test_tensor_parallel.py::test_state_actually_
    sharded`); a replicated one holds them all."""
    got_all, job, *_ = meshes
    n_model = mesh[1]
    full = job["steps"]["dense"]["state"]
    for r in got_all[mesh]:
        out = r["steps"]["dense"]
        sharded = [k for k in out["keys"] if k.endswith("conv.weight")]
        assert sharded
        for k, shape in out["moments"].items():
            rows = full[k].shape[0] // (n_model if k in out["keys"] else 1)
            assert shape == (rows, *full[k].shape[1:]), k
            assert tuple(out["local"][k].shape) == shape, k


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_k2_runs_at_the_global_shapes(meshes, mesh):
    """YOLO_FUSED_CONV_BWD=1: every rank calls K2's plain version at the
    global 64->64 shapes, as often and at the same shapes as one process
    (x and dy of the data shard's batch), never the library backward; the
    step equals one process's with the switch on."""
    got_all, _, _, single, _ = meshes
    n_data, n_model = mesh
    calls = single["k2"][3]
    assert calls and all(x[1] == dy[1] == 64 and w == (64, 64, 3, 3)
                         for x, dy, w in calls)
    b = B // n_data
    want = [((b, *x[1:]), (b, *dy[1:]), w) for x, dy, w in calls]
    for r in got_all[mesh]:
        assert r["steps"]["k2"]["k2"] == want
    _held_to_one_process([r["steps"]["k2"] for r in got_all[mesh]],
                         single["k2"], n_model)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_clip_takes_the_global_norm_of_the_slices(meshes, mesh):
    """`clip_by_global_norm_` on a cut model's gradients (the sharded
    leaves' squares summed over the model group, the replicated ones
    counted once) equals one process's on the whole gradients: the norm
    within 1e-6 relative, past the threshold, and the clipped gradients
    within 1e-6 of each tensor's largest magnitude."""
    got_all, *_ = meshes
    full = {k: v * 100 for k, v in
            got_all[mesh][0]["steps"]["dense"]["grads"].items()}
    grads = [t.clone() for t in full.values()]
    want = steps.clip_by_global_norm_(grads).item()
    assert want > steps.GRAD_CLIP_NORM
    for r in got_all[mesh]:
        norm, clipped = r["clip"]
        np.testing.assert_allclose(norm, want, rtol=1e-6)
        for (k, g), w in zip(clipped.items(), grads):
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=1e-6 * w.abs().max().item())


def test_tp_accum_step_matches_one_process(meshes):
    """`make_train_step_accum(n_accum=2)` at 1 x 2 against one process on
    the whole micro-batches: the loss within 1e-5 relative, the gathered
    gradients within 1e-3 of each tensor's largest magnitude (phase 8's
    tolerance: the port against itself in float32), the ranks' equal."""
    got_all, job, _, _, _ = meshes
    spec = job["steps"]["dense"]
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
    images = spec["images"].reshape(2, B // 2, *spec["images"].shape[1:])
    targets = [t.reshape(2, B // 2, *t.shape[1:]) for t in spec["targets"]]
    try:
        state, m = steps.make_train_step_accum(cfg, 2)(state, *(
            torch.from_numpy(a) for a in (images, *targets)))
    finally:
        steps.clip_by_global_norm_ = clip
    got = [r["accum"] for r in got_all[(1, 2)]]
    np.testing.assert_allclose(got[0]["loss"], m["loss"].item(), rtol=1e-5)
    assert got[0]["loss"] == got[1]["loss"]
    for (k, g), want in zip(got[0]["grads"].items(), seen["grads"]):
        assert torch.equal(g, got[1]["grads"][k]), k
        if k not in PRE_BN_BIASES:
            torch.testing.assert_close(g, want, rtol=0,
                                       atol=1e-3 * want.abs().max().item())


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
def test_tp_eval_counts_equal_one_process(meshes, mesh, head):
    """Through a cut model: the eval step's per-image counts on a batch,
    and `eval_epoch`'s over the odd split, equal one process's on every
    rank; the anchor head's loss within float32 rounding."""
    from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
    from yolo_from_scratch_tpu_torch.train import loop
    from yolo_from_scratch_tpu_torch.train.steps import make_eval_step

    got, job, *_ = meshes
    ev = job["eval"]
    cfg = _cfg(head)
    model = YOLO(cfg)
    model.load_state_dict(ev["state"][head])
    model.eval()
    compact = ev["k"] if head == "anchor_free" else 0
    ds = YoloDataset(ev["val"], NC, cfg.anchors_array, IMG, backend="pil",
                     head_type=head)
    assert len(ds) == N_VAL
    step = make_eval_step(cfg, compact_targets=bool(compact))
    if compact:
        images, labels, counts = ds.load_batch_compact(range(4),
                                                       capacity=compact)
        targets = [torch.from_numpy(labels), torch.from_numpy(counts)]
    else:
        images, targets = ds.load_batch(range(4))
        targets = [torch.from_numpy(t) for t in targets]
    per_image = [t.tolist() for t in step(model, torch.from_numpy(images),
                                          targets)[1:]]
    original = loop.prf1
    loop.prf1 = lambda tp, fp, fn: (tp, fp, fn)
    try:
        single = loop.eval_epoch(step, model, DataLoader(
            ds, batch_size=2, compact=compact), "cpu")
    finally:
        loop.prf1 = original
    for r in got[mesh]:
        assert r["eval_step"][head] == per_image
        loss, *counts = r["eval"][head]
        assert tuple(counts) == single[1:]
        if head == "anchor" and mesh[0] == 1:
            np.testing.assert_allclose(loss, single[0], rtol=1e-5)
    if head == "anchor":
        assert sum(counts) > 0


def test_cli_evaluation_takes_the_model_mesh(meshes, capsys):
    """`data.yaml model.ckpt --data-parallel --model-parallel 2` in two
    processes prints one process's evaluation: the banner, then each
    split's P/R/F1 lines equal and the loss within the last printed
    digit."""
    got, _, _, _, eval_argv = meshes
    assert cli.main(eval_argv) == 0
    single = capsys.readouterr().out.splitlines()
    for rc, out in (r["cli"] for r in got[(1, 2)]):
        assert rc == 0, out
        lines = out.splitlines()
        assert lines[1] == "2-D mesh: data=1 x model=2 over 2 process(es)"
        assert lines[0] == single[0] and len(lines) == len(single) + 1
        for a, b in zip(lines[2:], single[1:]):
            if a.startswith("  Loss: "):
                assert abs(float(a.split()[-1]) - float(b.split()[-1])) \
                    <= 1e-4, (a, b)
            else:
                assert a == b


# --- the CLI --------------------------------------------------------------

CLI_LR = "1e-3"


def _train_argv(dataset, head, *extra):
    """The CLI's training arguments; the anchor-free runs keep an EMA, so
    that the checkpoint gathers the average and the raw weights."""
    ema = ["--ema"] if head == "anchor_free" else []
    return [str(dataset / "dataset.yaml"), "--device", "cpu", "--size", "n",
            "--img-size", str(IMG), "--batch-size", "2", "--epochs", "1",
            "--lr", CLI_LR, "--head", head, *ema, *extra]


def _two_processes(argv, cwd):
    """`train_torch.py argv --distributed --model-parallel 2` in two
    processes; their stdouts."""
    base = [sys.executable, str(REPO / "train_torch.py"), *argv,
            "--model-parallel", "2", "--distributed", "--coordinator",
            f"127.0.0.1:{_free_port()}", "--num-processes", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    results = _run_ranks([base + ["--process-id", str(r)] for r in range(2)],
                         cwd, env)
    for rc, out, err in results:
        assert rc == 0, out[-2000:] + err[-3000:]
    return [out for _, out, _ in results]


@pytest.fixture(scope="module")
def cli_runs(temp_dataset_dir, tmp_path_factory):
    """Both heads trained one epoch by the CLI in two processes under
    `--model-parallel 2`, and flagless in this one; then each
    model-parallel checkpoint resumed for a second epoch both ways (the
    anchor-free one holds an EMA and its raw weights). {head: (stdouts,
    checkpoint, flagless checkpoint)}, and {head: the resumed pair}."""
    runs = {}
    for head in ("anchor", "anchor_free"):
        mp, flagless = (tmp_path_factory.mktemp(f"{head}_{w}")
                        for w in ("mp", "one"))
        outs = _two_processes(_train_argv(temp_dataset_dir, head), mp)
        cwd = os.getcwd()
        os.chdir(flagless)
        try:
            assert cli.main(_train_argv(temp_dataset_dir, head)) == 0
        finally:
            os.chdir(cwd)
        (ckpt,), (one,) = (list(d.glob("yolo_*.ckpt")) for d in (mp, flagless))
        runs[head] = (outs, ckpt, one)
    resumed = {}
    for head, (_, ckpt, _) in runs.items():
        resumed[head] = {}
        for how in ("mp", "one"):
            d = tmp_path_factory.mktemp(f"resume_{head}_{how}")
            path = d / "resume.ckpt"
            shutil.copy(ckpt, path)
            argv = _train_argv(temp_dataset_dir, head, "--resume", str(path))
            argv[argv.index("--epochs") + 1] = "2"
            if how == "mp":
                resumed[head]["out"] = _two_processes(argv, d)
            else:
                assert cli.main(argv) == 0
            resumed[head][how] = path
    return runs, resumed


def _jax_fraction(head):
    """JAX's sharded fraction of the CLI's config ('n', nc=1) at N=2."""
    cfg = YoloConfig.from_size("n", num_classes=1, img_size=IMG,
                               head_type=head)
    params = random_variables(YOLO(cfg, device="meta"), seed=0)["params"]
    return jax_tensor.sharded_fraction(jax_tensor.shard_state_tp(
        jax_tensor.make_mesh_dm(2), params))


@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
def test_cli_trains_two_processes_model_parallel(cli_runs, head):
    """Both ranks print the distributed line, JAX's two banners (its
    fraction for this config) and the same epoch line; rank 0's
    checkpoint has the flagless run's keys and shapes, its weights and
    Adam moments (with `--ema`, the average and the raw weights) within
    JAX's TP tolerance of the flagless run's."""
    from yolo_from_scratch_tpu_torch.utils.checkpoint import read_payload

    outs, ckpt, one = cli_runs[0][head]
    banner = (f"Model-parallel: {_jax_fraction(head):.0%} of params "
              f"channel-sharded 2-way")
    lines = []
    for r, out in enumerate(outs):
        assert f"Distributed: process {r}/2, backend gloo" in out
        assert "2-D mesh: data=1 x model=2 over 2 process(es)" in out
        assert banner in out.splitlines(), out
        epoch = re.search(r"Epoch 1: .* \| LR: \S+", out)
        lines.append(epoch.group(0))
    assert lines[0] == lines[1]
    got, want = read_payload(ckpt), read_payload(one)
    parts = ["model", "opt_state"]
    if head == "anchor_free":  # --ema: the raw weights ride in extra
        parts += ["extra"]
        assert "raw_params" in got["extra"]
    for part in parts:
        flat = [dict(_flatten(p[part])) for p in (got, want)]
        assert {k: v.shape for k, v in flat[0].items()} == {
            k: v.shape for k, v in flat[1].items()}, part
        for k, v in flat[0].items():
            np.testing.assert_allclose(v, flat[1][k], rtol=0,
                                       atol=TP_PARAM_ATOL, err_msg=k)
    assert got["extra"]["step"] == want["extra"]["step"]


def _flatten(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
def test_model_parallel_checkpoint_loads_in_both_packages(cli_runs, head,
                                                          temp_dataset_dir):
    """The JAX package's `load_checkpoint` reads it at full size; the
    port's `Predictor` serves an image from it, and the CLI's inference
    ignores `--model-parallel`."""
    from yolo_from_scratch_tpu.utils.checkpoint import (
        load_checkpoint as jax_load,
    )
    from yolo_from_scratch_tpu_torch.infer.predict import Predictor
    from yolo_from_scratch_tpu_torch.utils.checkpoint import load_checkpoint

    _, ckpt, _ = cli_runs[0][head]
    variables, jcfg, _ = jax_load(str(ckpt))
    assert jcfg.head_type == head
    sd, cfg, _ = load_checkpoint(ckpt)
    full = YOLO(cfg, device="meta").state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in full.items()}
    image = sorted((temp_dataset_dir / "val" / "images").iterdir())[0]
    Predictor(sd, cfg, device=torch.device("cpu"))(str(image))
    assert cli.main([str(image), str(ckpt), "--device", "cpu",
                     "--model-parallel", "2"]) == 0


@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
def test_resume_under_model_parallel_continues_as_one_process(cli_runs, head):
    """`--resume` of the model-parallel checkpoint under `--model-parallel
    2` reads it canonical and slices it: the resume line, then the second
    epoch's checkpoint within JAX's TP tolerance of one process's resume,
    its Adam moments too, at the same step. The anchor-free checkpoint was
    written with `--ema`: the raw weights it resumes from and the average
    it goes on with are full size, and so are those it writes."""
    from yolo_from_scratch_tpu_torch.utils.checkpoint import read_payload

    resumed = cli_runs[1][head]
    for out in resumed["out"]:
        assert "Resuming from " in out and " at epoch 2" in out
        assert "Epoch 2: " in out
    got, want = read_payload(resumed["mp"]), read_payload(resumed["one"])
    assert got["epoch"] == want["epoch"] == 1
    assert got["extra"]["step"] == want["extra"]["step"] > 0
    parts = ["model", "opt_state"]
    if head == "anchor_free":  # --ema: the raw weights ride in extra
        parts += ["extra"]
        assert "raw_params" in got["extra"]
    for part in parts:
        a, b = dict(_flatten(got[part])), dict(_flatten(want[part]))
        assert sorted(a) == sorted(b)
        for k, v in a.items():
            np.testing.assert_allclose(v, b[k], rtol=0, atol=TP_PARAM_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("argv,says", [
    (["--model-parallel", "2"], "--spatial/--model-parallel require "
                                "--data-parallel"),
    (["--model-parallel", "2", "--spatial", "2", "--data-parallel"],
     "--spatial and --model-parallel are mutually exclusive"),
    (["--model-parallel", "2", "--stream", "--data-parallel"],
     "--stream does not compose with --model-parallel"),
    (["--model-parallel", "2", "--data-parallel"],
     "1 devices do not divide into model=2"),
    (["--model-parallel", "4", "--data-parallel", "--epochs", "1"],
     "1 devices do not divide into model=4"),
])
def test_cli_model_parallel_flag_rules(argv, says, temp_dataset_dir, capsys):
    """The JAX CLI's refusals: exit 1 and its line."""
    assert cli.main([str(temp_dataset_dir / "dataset.yaml"), "--device",
                     "cpu", *argv]) == 1
    assert says in capsys.readouterr().out


@pytest.mark.parametrize("n,world", [(2, 3), (4, 6)])
def test_cli_refuses_a_world_that_n_does_not_divide(
        n, world, temp_dataset_dir, monkeypatch, capsys):
    """`make_mesh_dm`'s ValueError through the CLI (the process group is
    faked: the refusal comes before any collective)."""
    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(port_mesh.dist, "get_world_size", lambda: world)
    assert cli.main([str(temp_dataset_dir / "dataset.yaml"), "--device",
                     "cpu", "--data-parallel", "--model-parallel",
                     str(n)]) == 1
    assert f"ERROR: {world} devices do not divide into model={n}" in \
        capsys.readouterr().out


def test_model_parallel_is_a_flag_of_the_port():
    args = cli.build_parser().parse_args(["--model-parallel", "2"])
    assert args.model_parallel == 2
    assert not hasattr(cli, "UNPORTED_FLAGS")
    assert "stream_pool" not in cli.WORLD_UNPORTED
