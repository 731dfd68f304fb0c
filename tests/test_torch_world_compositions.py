"""The compositions of a world larger than one (`--device-mosaic` under
every mesh, `--stream` over data-parallel ranks, `--multi-scale` across
ranks) against the JAX package and against one process, on the CPU.

One launch of two `gloo` ranks (joined through a file store in the
test's directory) runs every two-rank case, at 64 px, width 0.25, nc=3,
float32, two images a rank; a light launch of four ranks, whose process
group has a short collective timeout, gathers the batch on the 2 x 2
meshes and holds the shared cache's wait. While they run, this process
compiles the JAX references and runs the port's one-process references.

- `gather_batch` gives every rank the global batch bit for bit, on the
  1-D mesh of two and four ranks and on the 1 x 2 and 2 x 2 `data x
  space` and `data x model` meshes.
- The device mosaic's step on a 1-D mesh of two, for both heads (the
  anchor head with the sparse loss and the device augmentation; the
  anchor-free head), against JAX's step sharded on a 2-device mesh, whose
  inputs are JAX's own mosaic (and augmentation) of the global batch from
  a key, the port's ranks given the same draws (each image of either
  rank mosaicked with a partner of the other's), then JAX's GT set and
  losses: the tolerances of `tests/test_torch_parallel.py`'s
  `test_two_rank_step_matches_jax_sharded_step` (the global loss 1e-4
  relative; the summed gradient 2e-2 of each tensor's largest magnitude;
  the conv biases in front of a BatchNorm 2e-4 absolute of their exact
  gradient, zero, as JAX's is rounding noise that outgrows that bound at
  the anchor-free loss of about 400 these draws give; each
  parameter's change within 2 * lr of JAX's and 90% of each tensor's
  within 0.05 * lr; BatchNorm statistics 1e-3 relative and 1e-4 of the
  largest magnitude). The ranks' states are equal bit for bit.
- Those two steps and the anchor head's on dense maps, on the 1-D mesh
  of two, 1 x 2 `data x space` (whole images in, rows cut after the
  mosaic) and 1 x 2 `data x model`, against the port's own step in one
  process on the global batch: the loss 1e-4 relative, the
  gradients 1e-3 of each tensor's largest magnitude (phase 8's
  tolerances: the port against itself, float32), the same parameter and
  BatchNorm bounds as above.
- `--stream`: each rank's chunks are its columns of one process's chunk
  and of JAX's, bit for bit; a two-rank stream epoch (compact labels,
  mosaic and augmentation off: the packages draw them from different
  generators) against JAX's `ChunkStream` placed `P(None, DATA_AXIS)` on
  2 devices, B=4, at `tests/test_torch_multistep.py`'s tolerances for
  its 2 steps; the chunk trainer at a world of two, mosaic and
  augmentation on, bit-equal to its own single steps; process 0 builds
  the shared cache once and the other opens it after a wait longer than
  the process group's collective timeout.
- The CLI at a world of two: `--stream --data-parallel` with the device
  mosaic and augmentation, and `--multi-scale` (buckets 96 / 128 / 160),
  print the same lines on both ranks and checkpoints held to one
  process's run on the global batch (each parameter's change within n *
  2 * lr of one process's, 90% within n * 0.05 * lr, n the steps taken;
  BatchNorm statistics n * 1e-3 relative and n * 1e-4 of the largest
  magnitude; the conv biases in front of a BatchNorm are left out: their
  gradient is rounding noise, which Adam turns into steps of about lr of
  either sign, and over several steps of any size up to a few lr);
  `--spatial 2 --multi-scale` at 128 exits 1 and names the bucket 96,
  whose P5 grid of 3 rows does not divide by 2; `--stream --distributed`
  over two hosts exits 1 with the JAX CLI's line.
"""

import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_device_augment import _jax_augment_draws, _jax_mosaic_draws
from test_torch_multistep import hold_weights_to_jax, jax_state
from test_torch_parallel import _jax_step
from test_torch_train import PRE_BN_BIASES

from yolo_from_scratch_tpu.config import YoloConfig
from yolo_from_scratch_tpu.data import stream as jstream
from yolo_from_scratch_tpu.data.assign_device import pack_labels
from yolo_from_scratch_tpu.data.cache import build_cache as jax_build_cache
from yolo_from_scratch_tpu.data.dataset import YoloDataset as JaxDataset
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu.ops import augment as jaug
from yolo_from_scratch_tpu.ops import mosaic_device as jmos
from yolo_from_scratch_tpu.parallel.mesh import DATA_AXIS
from yolo_from_scratch_tpu.train.steps import (
    make_train_step_multi_compact as jax_multi_compact,
)
from yolo_from_scratch_tpu_torch import cli
from yolo_from_scratch_tpu_torch.data import cache as port_cache
from yolo_from_scratch_tpu_torch.data import stream as tstream
from yolo_from_scratch_tpu_torch.data.assign_device import prefix_valid
from yolo_from_scratch_tpu_torch.data.dataset import YoloDataset
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.parallel import distributed as port_dist
from yolo_from_scratch_tpu_torch.parallel import mesh as port_mesh
from yolo_from_scratch_tpu_torch.train import steps
from yolo_from_scratch_tpu_torch.train.steps import DrawSpec
from yolo_from_scratch_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    read_payload,
)
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)
from yolo_from_scratch_tpu_torch.utils.synth import make_dataset

NC, IMG, K, WORLD = 3, 64, 8, 2
B = 4  # the global batch: two images a rank
LR = 1e-5  # test_torch_parallel's, which _jax_step uses
SEED = 5  # the mosaic's and the augmentation's
# JAX's keys for the mosaic steps: its draws mosaic an image of each rank
# with a partner of the other's
JAX_KEY = 0
STREAM_SEED = 4
JOIN_S = 300
# the four-rank launch: its process group's collective timeout, and how
# long process 0's build of the shared cache takes there (longer)
FOUR, CACHE_TIMEOUT_S, CACHE_BUILD_S = 4, 5.0, 8.0
REPO = Path(__file__).resolve().parents[1]
PATHS = ("dense", "sparse", "af")
JAX_PATHS = ("sparse", "af")  # both heads; the dense maps at one process
MESHES = ("1d", "space", "model")
CLI_LR = "1e-5"
# the CLI runs: the train split, the --multi-scale size and its buckets
N_TRAIN, MS_IMG, MS_BUCKETS = 8, 128, [96, 128, 160]

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
from yolo_from_scratch_tpu_torch.data import cache as cache_mod
from yolo_from_scratch_tpu_torch.data.stream import ChunkStream
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.parallel.mesh import (
    batch_sharding, gather_batch, make_mesh, make_mesh_2d, make_mesh_dm)
from yolo_from_scratch_tpu_torch.parallel.tensor import (
    full_state_dict, gather_state_tp, shard_model_)
from yolo_from_scratch_tpu_torch.train import loop, steps

rank, store, job_path, out_path = sys.argv[1:5]
rank, world = int(rank), 2
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
job = torch.load(job_path, weights_only=False)
meshes = {"1d": make_mesh("cpu"), "space": make_mesh_2d(2, "cpu"),
          "model": make_mesh_dm(2, "cpu")}
out = {"gather": {}}

# the global batch gathered from each rank's part of it
images, labels, counts = job["gather"]
for name, mesh in meshes.items():
    part = [torch.from_numpy(np.ascontiguousarray(batch_sharding(mesh, a)))
            for a in (images, labels, counts)]
    out["gather"][name] = [t.clone() for t in gather_batch(mesh, *part)]

clip, draw = steps.clip_by_global_norm_, steps.DrawSpec.draw
seen = {}


def recording_clip(grads, *a, **kw):
    seen["grads"] = [g.clone() for g in grads]
    return clip(grads, *a, **kw)


# DrawSpec.draw giving `draws`, the global batch's (JAX's)
def given(draws):
    def fixed(self, step, b):
        assert step == 0 and b == len(draws["mosaic"][0]), (step, b)
        return dict(draws)
    return fixed


steps.clip_by_global_norm_ = recording_clip
out["steps"] = {}
for mesh_name, mesh in meshes.items():
    for name, spec in job["steps"].items():
        steps.DrawSpec.draw = given(spec["draws"]) if spec["draws"] else draw
        cfg = YoloConfig(**spec["cfg"])
        model = YOLO(cfg)
        model.load_state_dict(spec["state"])
        shard_model_(model, mesh)
        state = steps.TrainState(model, steps.make_optimizer(
            model.parameters(), spec["lr"]))
        step = steps.make_train_step(cfg, mesh=mesh, **spec["kw"])
        # a space group's ranks take their data shard's whole images
        # (the step cuts the rows after the mosaic)
        batch = [torch.from_numpy(np.ascontiguousarray(
            batch_sharding(mesh, a))) for a in spec["batch"]]
        state, m = step(state, batch[0], batch[1:])
        names = [k for k, _ in model.named_parameters()]
        out["steps"][(mesh_name, name)] = {
            "metrics": {k: v.item() for k, v in m.items()},
            "grads": gather_state_tp(mesh, dict(zip(names, seen["grads"])),
                                     getattr(model, "tp_keys", ())),
            "state": full_state_dict(model),
            "whole": step.takes_whole_images}
steps.clip_by_global_norm_, steps.DrawSpec.draw = clip, draw

# the stream: this rank's chunks over two epochs
st = job["stream"]
cache = cache_mod.open_cache(st["cache"])
stream = ChunkStream(cache, batch_size=st["b"], steps_per_chunk=st["n"],
                     seed=st["seed"], device="cpu",
                     process_shard=(rank, world))
out["chunks"] = [[[t.clone() for t in chunk] for chunk in stream]
                 for _ in range(2)]
# a stream epoch through the scanned trainer, summed over the ranks
cfg = YoloConfig(**st["cfg"])
model = YOLO(cfg)
model.load_state_dict(st["state"])
state = steps.TrainState(model, steps.make_optimizer(model.parameters(),
                                                     st["lr"]))
stream = ChunkStream(cache, batch_size=st["b"], steps_per_chunk=st["n"],
                     seed=st["seed"], device="cpu",
                     process_shard=(rank, world))
trainer = steps.make_train_step_multi_compact(cfg, mesh=meshes["1d"])
state, means, n_imgs, _ = loop.stream_epoch(stream, trainer, state,
                                            meshes["1d"])
out["stream"] = {"means": means, "n_imgs": n_imgs, "step": state.step,
                 "state": {k: v.clone()
                           for k, v in model.state_dict().items()}}
# the chunk trainer with the mosaic and augmentation against its own
# single steps, at a world of two
flags = dict(device_mosaic=True, device_augment=True,
             augment_seed=st["seed"], sparse_loss=True)
chunk = [torch.from_numpy(np.ascontiguousarray(a[:, rank * st["b"]:
                                                 (rank + 1) * st["b"]]))
         for a in st["chunk"]]
results = []
for chunked in (True, False):
    model = YOLO(cfg)
    model.load_state_dict(st["state"])
    state = steps.TrainState(model, steps.make_optimizer(
        model.parameters(), st["lr"]))
    if chunked:
        state, m = steps.make_train_step_multi_compact(
            cfg, mesh=meshes["1d"], **flags)(state, *chunk)
        loss = m["loss"]
    else:
        step = steps.make_train_step(cfg, mesh=meshes["1d"],
                                     compact_targets=True, **flags)
        losses = []
        for i in range(len(chunk[0])):
            state, m = step(state, chunk[0][i], [chunk[1][i],
                                                 chunk[2][i]])
            losses.append(m["loss"])
        loss = torch.stack(losses).mean()
    results.append((loss, {k: v.clone() for k, v in
                           model.state_dict().items()}))
out["chunk_vs_steps"] = results

# the CLI on this process group, each run in a directory of its own
out["cli"] = {}
for name, argv in job["cli"]["runs"].items():
    run_dir = os.path.join(job["cli"]["root"], f"{name}_rank{rank}")
    os.makedirs(run_dir)
    os.chdir(run_dir)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out["cli"][name] = (rc, buf.getvalue())
torch.save(out, out_path)
# every rank is done with its collectives: leave without tearing down
# gloo's threads, which aborts a process now and then ("terminate called
# without an active exception") when its peers have exited first
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""

FOUR_WORKER = r"""
import datetime
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from yolo_from_scratch_tpu_torch.data import cache as cache_mod
from yolo_from_scratch_tpu_torch.data.dataset import YoloDataset
from yolo_from_scratch_tpu_torch.parallel.distributed import host_barrier
from yolo_from_scratch_tpu_torch.parallel.mesh import (
    batch_sharding, gather_batch, make_mesh, make_mesh_2d, make_mesh_dm)

rank, world, store, job_path, out_path, timeout_s, build_s = sys.argv[1:8]
rank, world = int(rank), int(world)
# every process is here before any connects: the short collective timeout
# then times the build, not the start-up
open(f"{store}.here{rank}", "w").close()
while not all(os.path.exists(f"{store}.here{r}") for r in range(world)):
    time.sleep(0.01)
dist.init_process_group(
    "gloo", init_method="file://" + store, rank=rank, world_size=world,
    timeout=datetime.timedelta(seconds=float(timeout_s)))
job = torch.load(job_path, weights_only=False)
out = {"gather": {}}
# the global batch gathered on the 1-D mesh and the 2 x 2 meshes, whose
# data groups are subgroups
meshes = {"1d": make_mesh("cpu"), "space": make_mesh_2d(2, "cpu"),
          "model": make_mesh_dm(2, "cpu")}
for name, mesh in meshes.items():
    part = [torch.from_numpy(np.ascontiguousarray(batch_sharding(mesh, a)))
            for a in job["gather"]]
    out["gather"][name] = [t.clone() for t in gather_batch(mesh, *part)]

# the shared cache: process 0 builds it, for longer than the timeout
built, logs = [], []
build = cache_mod.build_cache


def slow_build(*a, **kw):
    time.sleep(float(build_s))
    built.append(rank)
    return build(*a, **kw)


cache_mod.build_cache = slow_build
ds = YoloDataset(job["train"], 3, img_size=64, backend="pil")
t0 = time.perf_counter()
cache = cache_mod.ensure_cache(ds, capacity=8, cache_dir=job["cache_dir"],
                               log=lambda *a, **k: logs.append(a[0]),
                               rank=rank, wait=host_barrier())
out["shared"] = {"built": built, "logs": logs, "dir": cache.dir,
                 "images": np.array(cache.images),
                 "waited": time.perf_counter() - t0}
torch.save(out, out_path)
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""


def _cfg(head="anchor"):
    return YoloConfig(num_classes=NC, img_size=IMG, width_mult=0.25,
                      depth_mult=0.33, head_type=head)


def _cfg_kw(head="anchor"):
    return dict(num_classes=NC, img_size=IMG, width_mult=0.25,
                depth_mult=0.33, head_type=head)


def _compact(rng):
    """A global batch of B uint8 images and their compact labels."""
    images = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    boxes, classes = [], []
    for n in (5, 3, 1, 4):
        boxes.append(np.concatenate([rng.uniform(0.2, 0.8, (n, 2)),
                                     rng.uniform(0.05, 0.5, (n, 2))],
                                    1).astype(np.float32))
        classes.append(rng.integers(0, NC, n))
    return (images, *pack_labels(boxes, classes, K))


def _jax_draws(name):
    """JAX's keys for path `name`'s step (the mosaic's, the
    augmentation's) and the draws it takes from them for the global batch,
    as the port's steps take them ({"mosaic": (do, idx)}, and for the
    sparse path {"augment": (do_flip, gain, bias)})."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(JAX_KEY),
                                               PATHS.index(name)))
    do, idx = _jax_mosaic_draws(keys[0], B)
    draws = {"mosaic": (torch.tensor(do), torch.tensor(idx, dtype=torch.int64))}
    if name == "sparse":
        draws["augment"] = tuple(torch.tensor(a) for a in
                                 _jax_augment_draws(keys[1], B))
    return keys, draws


def _mosaic_jobs():
    """The three mosaic steps: (port step job, JAX inputs) by path, the
    JAX inputs for JAX_PATHS: JAX's mosaic (and, for the sparse path, its
    label-level augmentation) of the whole global batch from the keys
    whose draws the port's step is given, then JAX's GT set for the
    anchor-free head. The dense path takes the port's own draws."""
    rng = np.random.default_rng(0)
    port, ref = {}, {}
    for name in PATHS:
        head = "anchor_free" if name == "af" else "anchor"
        cfg = _cfg(head)
        images, labels, counts = _compact(rng)
        kw = dict(compact_targets=True, device_mosaic=True,
                  augment_seed=SEED)
        if name == "sparse":
            kw.update(sparse_loss=True, device_augment="full")
        if name not in JAX_PATHS:
            port[name] = (cfg, (images, labels, counts), kw, None)
            continue
        keys, draws = _jax_draws(name)
        port[name] = (cfg, (images, labels, counts), kw, draws)
        x, lab, valid = jmos.mosaic_compact_batch(
            keys[0], jnp.asarray(images.astype(np.float32)
                                 * np.float32(1 / 255.0)),
            jnp.asarray(labels), jnp.asarray(counts), min_box=2.0 / IMG)
        if name == "sparse":
            x, lab = jaug.augment_compact_batch(keys[1], x, lab, valid)
            ref[name] = (cfg, np.asarray(x), (np.asarray(lab),
                                              np.asarray(valid)),
                         dict(sparse=True))
        else:
            lab, valid = np.asarray(lab), np.asarray(valid)
            ids = np.clip(lab[..., 0].astype(np.int32), 0, NC - 1)
            gt_cls = np.eye(NC, dtype=np.float32)[ids] * valid[..., None]
            ref[name] = (cfg, np.asarray(x), (lab[..., 1:5], gt_cls,
                                              valid.astype(np.float32)),
                         dict(af_compact=True))
    return port, ref


def _one_process(cfg, state_dict, kw, batch, draws):
    """The port's own step on the whole global batch, one process, with
    `draws` (the global batch's) or its own: (loss, gradients by name,
    state dict)."""
    model = YOLO(cfg)
    model.load_state_dict(state_dict)
    state = steps.TrainState(model, steps.make_optimizer(model.parameters(),
                                                         LR))
    clip, seen = steps.clip_by_global_norm_, {}

    def recording_clip(grads, *a, **k):
        seen["grads"] = [g.clone() for g in grads]
        return clip(grads, *a, **k)

    draw = steps.DrawSpec.draw
    steps.clip_by_global_norm_ = recording_clip
    if draws is not None:
        steps.DrawSpec.draw = lambda self, step, b: dict(draws)
    try:
        t = [torch.from_numpy(a) for a in batch]
        state, m = steps.make_train_step(cfg, **kw)(state, t[0], t[1:])
    finally:
        steps.clip_by_global_norm_, steps.DrawSpec.draw = clip, draw
    return (m["loss"].item(),
            dict(zip([n for n, _ in model.named_parameters()],
                     seen["grads"])),
            {k: v.clone() for k, v in model.state_dict().items()})


def _stream_chunk(seed=1):
    """A chunk of 2 steps of the global batch (uint8 images, labels,
    counts), leading (N, B)."""
    rng = np.random.default_rng(seed)
    parts = [_compact(rng) for _ in range(2)]
    return tuple(np.stack(a) for a in zip(*parts))


def _cli_runs(yaml_file, root):
    """The CLI's argument lists at a world of two (`--data-parallel` on
    the ranks' process group) and of one (the global batch), by run."""
    common = [str(yaml_file), "--device", "cpu", "--size", "n", "--lr",
              CLI_LR, "--warmup-epochs", "0", "--seed", "3"]
    stream = common + ["--img-size", str(IMG), "--epochs", "2", "--stream",
                       "--stream-chunk", "2", "--compact-targets", str(K),
                       "--device-mosaic", "--device-augment", "--sparse-loss",
                       "--cache-dir", str(root / "cli_cache")]
    multi = common + ["--img-size", str(MS_IMG), "--epochs", "3",
                      "--multi-scale"]
    world = {"stream": stream + ["--batch-size", "2", "--data-parallel"],
             "multi_scale": multi + ["--batch-size", "2", "--data-parallel"],
             "spatial_refused": multi + ["--batch-size", "2",
                                         "--data-parallel", "--spatial", "2"]}
    single = {"stream": stream[:-2] + ["--cache-dir", str(root / "one_cache"),
                                       "--batch-size", "4"],
              "multi_scale": multi + ["--batch-size", "4"]}
    return world, single


def _run_cli(argv, run_dir):
    """cli.main in this process from `run_dir`: (rc, stdout)."""
    run_dir.mkdir()
    cwd = os.getcwd()
    buf = io.StringIO()
    try:
        os.chdir(run_dir)
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        os.chdir(cwd)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results, the jobs they ran, the JAX references and the
    one-process references."""
    tmp = tmp_path_factory.mktemp("world")
    yaml_file = make_dataset(tmp / "ds", n_train=N_TRAIN, n_val=3,
                             img_size=IMG, seed=2, num_classes=NC)
    train_dir = str(tmp / "ds" / "train" / "images")
    caches = {"port": port_cache.build_cache(
        YoloDataset(train_dir, NC, img_size=IMG, backend="pil"),
        str(tmp / "port_cache"), capacity=K, log=None),
        "jax": jax_build_cache(JaxDataset(train_dir, NC, img_size=IMG,
                                          backend="pil"),
                               str(tmp / "jax_cache"), capacity=K, log=None)}
    port, ref = _mosaic_jobs()
    variables = {name: random_variables(YOLO(cfg, device="meta"), seed=3)
                 for name, (cfg, *_) in port.items()}
    stream_cfg = _cfg()
    stream_vars = random_variables(YOLO(stream_cfg, device="meta"), seed=7)
    cli_world, cli_single = _cli_runs(yaml_file, tmp)
    job = {
        "gather": _compact(np.random.default_rng(9)),
        "steps": {name: dict(cfg=_cfg_kw(cfg.head_type),
                             state=from_flax_variables(variables[name],
                                                       YOLO(cfg)),
                             lr=LR, batch=batch, kw=kw, draws=draws)
                  for name, (cfg, batch, kw, draws) in port.items()},
        "stream": dict(cache=caches["port"].dir, b=B // WORLD, n=2,
                       seed=STREAM_SEED, img=IMG, cfg=_cfg_kw(),
                       state=from_flax_variables(stream_vars,
                                                 YOLO(stream_cfg)),
                       lr=LR, chunk=_stream_chunk()),
        "cli": dict(root=str(tmp), train=train_dir, runs=cli_world),
    }
    torch.save(job, tmp / "job.pt")
    torch.save({"gather": job["gather"], "train": train_dir,
                "cache_dir": str(tmp / "shared_cache")}, tmp / "job4.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    cmds = [[sys.executable, "-c", WORKER, str(r), str(tmp / "store"),
             str(tmp / "job.pt"), str(tmp / f"rank{r}.pt")]
            for r in range(WORLD)]
    cmds += [[sys.executable, "-c", FOUR_WORKER, str(r), str(FOUR),
              str(tmp / "store4"), str(tmp / "job4.pt"),
              str(tmp / f"four_rank{r}.pt"), str(CACHE_TIMEOUT_S),
              str(CACHE_BUILD_S)] for r in range(FOUR)]
    procs = [subprocess.Popen(c, cwd=tmp, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for c in cmds]
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # the references while the ranks run
        jax_ref = {name: _jax_step(cfg, variables[name], images, targets,
                                   loss_kw)
                   for name, (cfg, images, targets, loss_kw) in ref.items()}
        jax_ref["stream"] = _jax_stream_epoch(caches["jax"], stream_vars)
        single = {name: _one_process(cfg, job["steps"][name]["state"], kw,
                                     batch, draws)
                  for name, (cfg, batch, kw, draws) in port.items()}
        single_cli = {name: _run_cli(argv, tmp / f"one_{name}")
                      for name, argv in cli_single.items()}
        results = [p.communicate(timeout=JOIN_S) for p in procs]
    finally:
        torch.set_num_threads(torch_threads)
        for p in procs:
            p.kill()
    for cmd, p, (_, err) in zip(cmds, procs, results):
        assert p.returncode == 0, (cmd[3:5], err[-3000:])
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    four = [torch.load(tmp / f"four_rank{r}.pt", weights_only=False)
            for r in range(FOUR)]
    return dict(ranks=ranks, four=four, job=job, jax=jax_ref, single=single,
                single_cli=single_cli, caches=caches, variables=variables,
                stream_vars=stream_vars, tmp=tmp)


def _jax_stream_epoch(jax_cache, stream_vars):
    """JAX's stream epoch at the global batch B, its chunks placed
    `P(None, DATA_AXIS)` on 2 devices: (state, metric means)."""
    cfg = _cfg()
    tx, state = jax_state(stream_vars)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:WORLD]), (DATA_AXIS,))
    stream = jstream.ChunkStream(jax_cache, batch_size=B, steps_per_chunk=2,
                                 seed=STREAM_SEED,
                                 placement=NamedSharding(mesh,
                                                         P(None, DATA_AXIS)))
    trainer = jax_multi_compact(JaxYOLO(cfg), tx, cfg, donate=False)
    state, means, _, _ = stream.run_epoch(trainer, state)
    return state, means


# --- the batch gather -------------------------------------------------------

@pytest.mark.parametrize("world_size", [WORLD, FOUR])
@pytest.mark.parametrize("mesh", MESHES)
def test_gather_batch_gives_every_rank_the_global_batch(world, world_size,
                                                        mesh):
    """Bit for bit, dtypes kept, in data-shard order: on a 2-D mesh the
    ranks of a space or model group hold one data shard, so the global
    batch is the n_data shards' batches."""
    want = world["job"]["gather"]
    for r in world["ranks" if world_size == WORLD else "four"]:
        got = r["gather"][mesh]
        for g, w in zip(got, want, strict=True):
            assert g.dtype == torch.from_numpy(w).dtype
            np.testing.assert_array_equal(g.numpy(), w)


def test_gather_batch_without_a_group_is_the_identity():
    mesh = port_mesh.Mesh(0, 1, torch.device("cpu"))
    parts = tuple(torch.from_numpy(a) for a in _compact(
        np.random.default_rng(1)))
    assert port_mesh.gather_batch(mesh, *parts) == parts
    spatial = port_mesh.Mesh(1, 2, torch.device("cpu"), group=object(),
                             n_space=2, space_group=object())
    assert port_mesh.gather_batch(spatial, *parts) == parts


# --- the device mosaic ------------------------------------------------------

def _held(got_state, start, want_state):
    """Each parameter's change within 2 * lr of the reference's and 90%
    of each tensor's within 0.05 * lr (not the pre-BN biases); BatchNorm
    statistics 1e-3 relative and 1e-4 of the largest magnitude."""
    for k, t in got_state.items():
        want = want_state[k]
        if k.endswith((".bn.mean", ".bn.var")):
            np.testing.assert_allclose(
                t.numpy(), want.numpy(), rtol=1e-3,
                atol=1e-4 * want.abs().max().item(), err_msg=k)
            continue
        diff = np.abs((t - start[k]).numpy() - (want - start[k]).numpy())
        assert diff.max() <= 2 * LR, (k, diff.max() / LR)
        if k not in PRE_BN_BIASES:
            assert np.quantile(diff, 0.9) <= 0.05 * LR, (
                k, np.quantile(diff, 0.9) / LR)


def _ranks_equal(got):
    for key in ("grads", "state"):
        for k, v in got[0][key].items():
            assert torch.equal(v, got[1][key][k]), (key, k)


@pytest.mark.parametrize("name", JAX_PATHS)
def test_mosaic_step_matches_jax_sharded_step(world, name):
    """JAX's mosaic of the global batch from its key against the port's
    ranks given the same draws: an image of each rank takes a partner
    from the other rank, which only the gathered batch holds."""
    do, idx = (t.numpy() for t in world["job"]["steps"][name]["draws"]
               ["mosaic"])
    rank_of = np.arange(B) // (B // WORLD)
    assert {rank_of[i] for i in range(B)
            if do[i] and (rank_of[idx[:, i]] != rank_of[i]).any()} == {0, 1}
    got = [r["steps"][("1d", name)] for r in world["ranks"]]
    _ranks_equal(got)
    assert not got[0]["whole"]
    loss, grads, params, batch_stats = world["jax"][name]
    np.testing.assert_allclose(sum(r["metrics"]["loss"] for r in got), loss,
                               rtol=1e-4)
    cfg = _cfg("anchor_free" if name == "af" else "anchor")
    model = YOLO(cfg, device="meta")
    want_grads = from_flax_variables(
        {"params": grads, "batch_stats": batch_stats}, model)
    for k, g in got[0]["grads"].items():
        # the conv biases in front of a BatchNorm: their exact gradient,
        # zero; JAX's is rounding noise that grows with the loss (the
        # anchor-free loss is about 400 here, JAX's stem0 bias 3.5e-4)
        want = 0.0 if k in PRE_BN_BIASES else want_grads[k].numpy()
        atol = 2e-4 if k in PRE_BN_BIASES else 2e-2 * np.abs(want).max()
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=atol,
                                   err_msg=k)
    want = from_flax_variables({"params": params,
                                "batch_stats": batch_stats}, model)
    _held(got[0]["state"], world["job"]["steps"][name]["state"], want)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", PATHS)
def test_mosaic_step_matches_one_process(world, mesh, name):
    """Two ranks of two images on the 1-D mesh, partners from the gathered
    batch; 1 x 2: the space group's ranks compose whole images and keep
    their rows (the step takes whole images), the model group's ranks
    hold one batch and their channels. Each rank's loss is its data
    shard's on a model mesh, its part of the global loss otherwise (the
    anchor-free loss at 1 / N a rank of a space group)."""
    got = [r["steps"][(mesh, name)] for r in world["ranks"]]
    _ranks_equal(got)
    assert got[0]["whole"] == (mesh == "space")
    loss, grads, state = world["single"][name]
    total = (got[0]["metrics"]["loss"] if mesh == "model"
             else sum(r["metrics"]["loss"] for r in got))
    np.testing.assert_allclose(total, loss, rtol=1e-4)
    for k, g in got[0]["grads"].items():
        if k not in PRE_BN_BIASES:
            torch.testing.assert_close(
                g, grads[k], rtol=0, atol=1e-3 * grads[k].abs().max().item(),
                msg=k)
    _held(got[0]["state"], world["job"]["steps"][name]["state"], state)


def test_rank_draws_keep_global_partners():
    """A rank's mosaic draws are its rows of the global batch's, their
    partners indices into the global batch; a space or model group's
    ranks take the same draws."""
    spec = DrawSpec(SEED, True, True, True)
    full = spec.draw(3, B)
    for r in range(WORLD):
        mesh = port_mesh.Mesh(r, WORLD, torch.device("cpu"), group=object())
        got = steps._rank_draws(spec, 3, B // WORLD, mesh)
        rows = slice(r * B // WORLD, (r + 1) * B // WORLD)
        assert torch.equal(got["mosaic"][0], full["mosaic"][0][rows])
        assert torch.equal(got["mosaic"][1], full["mosaic"][1][:, rows])
        for g, w in zip(got["augment"], full["augment"]):
            assert torch.equal(g, w[rows])
    group = port_mesh.Mesh(1, 2, torch.device("cpu"), group=object(),
                           n_model=2, model_group=object())
    got = steps._rank_draws(spec, 3, B, group)
    assert torch.equal(got["mosaic"][1], full["mosaic"][1])


# --- the stream -------------------------------------------------------------

def test_rank_chunks_are_columns_of_one_process(world):
    """Two epochs from one seed: rank r's chunk is columns [2r, 2r + 2) of
    the port's one-process chunk at B=4, and of JAX's."""
    ranks = world["ranks"]
    one = tstream.ChunkStream(world["caches"]["port"], batch_size=B,
                              steps_per_chunk=2, seed=STREAM_SEED,
                              device="cpu")
    theirs = jstream.ChunkStream(world["caches"]["jax"], batch_size=B,
                                 steps_per_chunk=2, seed=STREAM_SEED)
    b = B // WORLD
    for epoch in range(2):
        want, jax_want = list(one), list(theirs)
        assert len(want) == len(jax_want) == N_TRAIN // (B * 2)
        for r, rank in enumerate(ranks):
            assert len(rank["chunks"][epoch]) == len(want)
            for got, w, jw in zip(rank["chunks"][epoch], want, jax_want):
                for g, wt, jt in zip(got, w, jw):
                    assert g.shape[:2] == (2, b)
                    cols = slice(r * b, (r + 1) * b)
                    assert torch.equal(g, wt[:, cols])
                    np.testing.assert_array_equal(g.numpy(),
                                                  np.asarray(jt)[:, cols])


def test_stream_epoch_matches_jax_sharded_stream(world):
    """2 steps of the global batch 4, each rank's columns, against JAX's
    stream placed over 2 devices: the epoch's summed mean loss 2e-4
    relative, the weights at 2 steps' tolerances; both ranks report the
    global values and hold the same state."""
    got = [r["stream"] for r in world["ranks"]]
    assert got[0]["means"] == got[1]["means"]
    assert got[0]["n_imgs"] == got[1]["n_imgs"] == N_TRAIN
    assert got[0]["step"] == 2
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k
    jax_st, jax_means = world["jax"]["stream"]
    assert int(jax_st.step) == 2
    np.testing.assert_allclose(got[0]["means"]["loss"], jax_means["loss"],
                               rtol=2e-4)
    model = YOLO(_cfg())
    model.load_state_dict(got[0]["state"])
    start = from_flax_variables(world["stream_vars"], YOLO(_cfg()))
    hold_weights_to_jax(model, start, {"params": jax_st.params,
                                       "batch_stats": jax_st.batch_stats},
                        n=2)


def test_chunk_trainer_at_a_world_of_two_equals_its_steps(world):
    """Mosaic (partners from the gathered global batch), augmentation and
    the sparse loss: the chunk's 2 eager steps equal 2 single steps bit
    for bit on each rank."""
    for r in world["ranks"]:
        (chunk_loss, chunk_state), (step_loss, step_state) = \
            r["chunk_vs_steps"]
        torch.testing.assert_close(chunk_loss, step_loss, rtol=0, atol=0)
        for k, v in chunk_state.items():
            assert torch.equal(v, step_state[k]), k


def test_shared_cache_is_built_once(world):
    """Process 0 of four builds the cache, for longer than the process
    group's collective timeout; the others wait that long at the host
    barrier and open the same files."""
    got = [r["shared"] for r in world["four"]]
    assert got[0]["built"] == [0]
    assert any("Building training cache" in line for line in got[0]["logs"])
    for r in got[1:]:
        assert r["waited"] > CACHE_TIMEOUT_S
        assert r["built"] == [] and r["logs"] == []
        assert r["dir"] == got[0]["dir"]
        np.testing.assert_array_equal(r["images"], got[0]["images"])


def test_shared_cache_refuses_a_missing_one(tmp_path, temp_dataset_dir):
    """A process other than 0 never builds: with no cache behind the
    barrier it raises instead of writing one."""
    ds = YoloDataset(str(temp_dataset_dir / "train" / "images"), 1,
                     img_size=IMG, backend="pil")
    calls = []
    with pytest.raises(RuntimeError, match="no cache"):
        port_cache.ensure_cache(ds, capacity=K,
                                cache_dir=str(tmp_path / "c"), rank=1,
                                wait=lambda: calls.append(1))
    assert calls == [1] and not (tmp_path / "c").exists()


@pytest.mark.parametrize("device, backend, path", [
    ("cpu", None, "eager (CPU)"), ("cpu", "gloo", "eager (CPU)"),
    ("cuda", None, "CUDA graph"), ("cuda", "nccl", "CUDA graph (nccl)"),
    ("cuda", "gloo", "eager (gloo cannot be captured)")])
def test_chunk_path_names_the_backend(monkeypatch, device, backend, path):
    """Eager on the CPU; on a card captured without a group and with
    NCCL's, eager with gloo's (the backend is faked: no card here)."""
    monkeypatch.setattr(torch.distributed, "get_backend", lambda g: backend)
    mesh = (None if backend is None else
            port_mesh.Mesh(0, 2, torch.device("cpu"), group=object()))
    assert steps.chunk_path(device, mesh) == path


# --- the CLI ----------------------------------------------------------------

EPOCH = re.compile(r"^Epoch \d+: .* \| LR: \S+", re.M)


def _rank_outputs(world, name):
    outs = []
    for r in world["ranks"]:
        rc, out = r["cli"][name]
        assert rc == 0, out
        outs.append(out)
    return outs


def _held_checkpoint(got_path, want_path, start, n):
    """A checkpoint's weights held to another's from the same start, n
    steps at --lr CLI_LR."""
    got, _, _ = load_checkpoint(got_path)
    want, _, _ = load_checkpoint(want_path)
    lr = float(CLI_LR)
    assert all(torch.isfinite(got[k]).all() for k in PRE_BN_BIASES)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        if k.endswith((".bn.mean", ".bn.var")):
            np.testing.assert_allclose(
                t.numpy(), want[k].numpy(), rtol=n * 1e-3,
                atol=n * 1e-4 * want[k].abs().max().item(), err_msg=k)
            continue
        if k in PRE_BN_BIASES:
            continue
        diff = np.abs((t - start[k]).numpy() - (want[k] - start[k]).numpy())
        assert diff.max() <= n * 2 * lr, (k, diff.max() / lr)
        assert np.quantile(diff, 0.9) <= n * 0.05 * lr, (
            k, np.quantile(diff, 0.9) / lr)


def _saved(out):
    return re.search(r"Model saved to (\S+)", out).group(1)


def _start(img):
    cfg = cli.YoloConfig.from_size("n", num_classes=NC, img_size=img)
    return YOLO(cfg).reset_parameters(
        torch.Generator().manual_seed(3)).state_dict()


def test_cli_stream_at_a_world_of_two_equals_one_process(world):
    """`--stream --data-parallel` on two ranks of two images with the
    mosaic and augmentation: the banner names the eager chunks, process 0
    alone builds the cache, both print the same epoch lines, and the
    checkpoint (4 steps) is held to one process's run at batch 4 (the
    same global batches and draws)."""
    outs = _rank_outputs(world, "stream")
    for out in outs:
        assert "Data-parallel mesh over 2 process(es)" in out
        assert "double-buffered chunks of 2 steps; chunks: eager (CPU)" in out
    assert "Building training cache" in outs[0]
    assert "Building training cache" not in outs[1]
    lines = [EPOCH.findall(out) for out in outs]
    assert len(lines[0]) == 2 and lines[0] == lines[1]
    rc, one = world["single_cli"]["stream"]
    assert rc == 0, one
    tmp = world["tmp"]
    ckpt = tmp / "stream_rank0" / _saved(outs[0])
    assert int(read_payload(ckpt)["extra"]["step"]) == 4
    _held_checkpoint(ckpt, tmp / "one_stream" / _saved(one), _start(IMG), 4)


def test_cli_multi_scale_at_a_world_of_two_equals_one_process(world):
    """`--multi-scale` on two ranks: one epoch in each bucket, the same
    lines on both ranks, the checkpoint (6 steps) held to one process's
    run at batch 4."""
    outs = _rank_outputs(world, "multi_scale")
    for out in outs:
        assert f"Multi-scale buckets: {MS_BUCKETS} (epoch-rotated)" in out
    lines = [EPOCH.findall(out) for out in outs]
    assert len(lines[0]) == 3 and lines[0] == lines[1]
    rc, one = world["single_cli"]["multi_scale"]
    assert rc == 0, one
    tmp = world["tmp"]
    _held_checkpoint(tmp / "multi_scale_rank0" / _saved(outs[0]),
                     tmp / "one_multi_scale" / _saved(one), _start(MS_IMG),
                     6)
    assert not list((tmp / "multi_scale_rank1").glob("yolo_*.ckpt"))


def test_cli_spatial_multi_scale_names_the_bucket(world):
    for r in world["ranks"]:
        rc, out = r["cli"]["spatial_refused"]
        assert rc == 1, out
        assert ("ERROR: --spatial 2 needs the P5 grid of the --multi-scale "
                "bucket 96 (img_size / 32 = 3 rows at 96)") in out
        assert "Training YOLO model" not in out


def test_cli_stream_refuses_several_hosts(temp_dataset_dir, monkeypatch,
                                          capsys):
    """`--stream --distributed` with ranks on two hosts exits 1 with the
    JAX CLI's line (the process group and the hosts are faked: the
    refusal comes before any collective)."""
    monkeypatch.setattr(port_dist, "init_distributed",
                        lambda *a, **k: (0, 2))
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: "gloo")
    monkeypatch.setattr(port_mesh, "make_mesh", lambda device: port_mesh.Mesh(
        0, 2, torch.device("cpu"), group=object()))
    monkeypatch.setattr(port_dist, "host_names", lambda: ["a", "b"])
    rc = cli.main([str(temp_dataset_dir / "dataset.yaml"), "--device", "cpu",
                   "--stream", "--distributed", "--coordinator",
                   "127.0.0.1:1", "--num-processes", "2", "--process-id",
                   "0"])
    out = capsys.readouterr().out
    assert rc == 1, out
    assert ("ERROR: --stream does not compose with --distributed; use "
            "--device-augment/--device-mosaic for augmentation on the "
            "stream path") in out

