"""The packed layouts on the port's 2-D meshes (`--packed ... --spatial N`
and `--packed ... --model-parallel N`), against the JAX package's packed
step and the port's one-process packed step, on the CPU (width 0.25,
depth 0.33, nc=3, float32, a global batch of 4).

The ranks run in processes joined by `gloo` through file stores, all at
once: data x space 1 x 2 and 1 x 4, data x model 1 x 2.

- `--spatial`, 1 x 2 at 128 px (2 P5 rows, one a rank; the 4x-packed
  image 16 rows a rank): one step of the dense anchor head under the
  packed p3 (width 0.5) and interior layouts (every packed conv takes its halo rows)
  held to JAX's single-device packed step at `tests/test_torch_spatial.py`
  's tolerances (`tests/test_sharding.py::
  test_train_step_2d_spatial_packed_matches_single_device` pins JAX's
  packed step on a data x space mesh to it): the global loss within 1e-4
  relative, the gradient within 2e-2 of each tensor's largest magnitude
  (2e-4 absolute for the conv biases in front of a BatchNorm), every
  parameter's change within 2 * lr of JAX's and 90% of each tensor's
  within 0.05 * lr, the BatchNorm statistics 1e-3 relative and 1e-4 of
  the largest magnitude; and to one port process at
  `tests/test_torch_spatial_uneven.py`'s: the loss within 1e-6 relative
  (anchor-free, and the rank without rows, 1e-5), the gradients within
  1e-3 of each tensor's largest
  magnitude (the pre-BN biases left out: float noise around 0), the
  BatchNorm statistics within 1e-5 of it. All ranks' gradients and
  weights are equal bit for bit.
- uneven blocks, compact labels: the packed p3 anchor-free step at 96 px
  on 1 x 2 (3 P5 rows: 2 / 1) and the packed p3 anchor step at 96 px on
  1 x 4 (1 / 1 / 1 / 0: a rank that holds no rows, whose packed convs run
  on padded tiles and keep no output row), each held to one port process
  at those tolerances.
- `--model-parallel`, 1 x 2 at 128 px, width 0.5 (so that the P3 convs,
  64 canonical channels, are cut): the packed p3 step of both heads
  (the dense anchor head; the compact anchor-free head) held to JAX's
  single-device packed step (`tests/test_tensor_parallel.py` pins JAX's
  `shard_state_tp` step to it) at the tolerances above, and to one port
  process at `tests/test_torch_tensor_parallel.py`'s (JAX's TP
  tolerance: the loss 2e-5 relative, the parameters 5e-3 absolute).
  The cut packed convs (canonical cout 64 and more: here `bb_p3_down`,
  `lateral_p3`, the p3 C3s' conv3 ...) hold cout / N canonical rows, their
  replicated leaves are bit-equal across the ranks and the gathered state
  equal everywhere. One cut packed conv of each kind (four output phases
  through a 3x3 stride-2, a 1x1 on a concat layout, one phase through a
  2x2 (1, 0)) gathers its output phase-major: forward and the input's
  gradient equal the uncut conv's within 1e-6 of the largest magnitude.

`sharded_fraction` of a packed model equals JAX's over its sharded params
(the rule reads canonical leaves, so a packed config cuts as the unpacked
one does).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_spatial import (
    JOIN_S,
    LR,
    NC,
    REPO,
    _compact,
    _jax_step,
    _jobs,
)
from test_torch_tensor_parallel import (
    TP_LOSS_RTOL,
    TP_PARAM_ATOL,
    _one_process_step,
)
from test_torch_train import PRE_BN_BIASES

from yolo_from_scratch_tpu.data.assign_device import pack_labels
from yolo_from_scratch_tpu.parallel import tensor as jax_tensor
from yolo_from_scratch_tpu_torch.config import YoloConfig
from yolo_from_scratch_tpu_torch.data.letterbox import pack_s2d_host
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.parallel import mesh as port_mesh
from yolo_from_scratch_tpu_torch.parallel import tensor as port_tensor
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)

P3 = dict(packed_stem=True, packed_interior=True, packed_p3=True)
INTERIOR = dict(packed_stem=True, packed_interior=True)
K = 8
# (axis, data, n): the meshes, and the steps each runs
MESHES = {("space", 1, 2): ("p3", "interior", "p3_af_96"),
          ("space", 1, 4): ("p3_96",),
          ("model", 1, 2): ("p3", "p3_af")}
# the steps held to JAX's packed single-device step
JAX_HELD = ("p3", "interior", "p3_af")
# one cut packed conv of each kind (the phase-major gather)
GATHER_CONVS = ("bb_p3_down", "merge_p3.conv3", "bb_p4_down")


def _cfg_kw(head, img, layout, width=0.25):
    return dict(num_classes=NC, img_size=img, width_mult=width,
                depth_mult=0.33, head_type=head, **layout)


def _compact_96(rng):
    """A compact batch at 96 px: uint8 images packed on the host, labels
    and counts."""
    images, boxes, classes = _compact(rng)
    images = np.stack([np.asarray(torch.nn.functional.interpolate(
        torch.from_numpy(im).permute(2, 0, 1)[None].float(), size=96)[0]
        .permute(1, 2, 0).round().to(torch.uint8)) for im in images])
    labels, counts = pack_labels(boxes, classes, K)
    return images, [labels, counts]


def _steps():
    """Each step's (port job spec, JAX reference inputs or None)."""
    port, ref = _jobs()
    steps = {}
    cfg, images, targets, _ = port["dense"]
    # p3 at width 0.5, whose P3 convs (64 canonical channels) a model mesh
    # cuts: four output phases gathered phase-major
    for name, layout, width in (("p3", P3, 0.5), ("interior", INTERIOR,
                                                   0.25)):
        kw = _cfg_kw("anchor", 128, layout, width)
        steps[name] = (dict(cfg=kw, images=pack_s2d_host(images),
                            targets=targets, kw={}),
                       (YoloConfig(**kw), images, targets, {}))
    cfg, images, targets, kw = port["af"]
    af = _cfg_kw("anchor_free", 128, P3, 0.5)
    steps["p3_af"] = (dict(cfg=af, images=pack_s2d_host(images),
                           targets=targets, kw=kw),
                      (YoloConfig(**af), *ref["af"][1:]))
    rng = np.random.default_rng(9)
    for name, head in (("p3_af_96", "anchor_free"), ("p3_96", "anchor")):
        images, targets = _compact_96(rng)
        steps[name] = (dict(cfg=_cfg_kw(head, 96, P3),
                            images=pack_s2d_host(images), targets=targets,
                            kw=dict(compact_targets=True)), None)
    return steps


WORKER = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from yolo_from_scratch_tpu_torch.config import YoloConfig
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.parallel.mesh import (
    batch_sharding, batch_sharding_for, data_parallel, image_sharding,
    make_mesh_2d, make_mesh_dm)
from yolo_from_scratch_tpu_torch.parallel.tensor import (
    full_state_dict, gather_state_tp, shard_model_)
from yolo_from_scratch_tpu_torch.train import steps

rank, world, axis, n, store, job_path, out_path = sys.argv[1:8]
rank, world, n = int(rank), int(world), int(n)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
mesh = make_mesh_2d(n, "cpu") if axis == "space" else make_mesh_dm(n, "cpu")
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
    if axis == "model":
        shard_model_(model, mesh)
    state = steps.TrainState(model, steps.make_optimizer(model.parameters(),
                                                         spec["lr"]))
    step = steps.make_train_step(cfg, mesh=mesh, **spec["kw"])
    grid = cfg.img_size // 32
    if axis == "space":
        images = image_sharding(mesh, spec["images"], grid)
        targets = [batch_sharding_for(mesh, t, grid) for t in spec["targets"]]
    else:
        images = batch_sharding(mesh, spec["images"])
        targets = [batch_sharding(mesh, t) for t in spec["targets"]]
    state, m = step(state, torch.from_numpy(np.ascontiguousarray(images)),
                    [torch.from_numpy(np.ascontiguousarray(t))
                     for t in targets])
    grads = dict(zip([k for k, _ in model.named_parameters()],
                     seen["grads"]))
    keys = getattr(model, "tp_keys", frozenset())
    if axis == "model":
        grads = gather_state_tp(mesh, grads, keys)
    out["steps"][name] = {
        "metrics": {k: v.item() for k, v in m.items()}, "grads": grads,
        "local": {k: v.clone() for k, v in model.state_dict().items()},
        "full": {k: v.clone() for k, v in full_state_dict(model).items()},
        "keys": keys}

if axis == "model":
    # one cut packed conv of each kind against the whole conv: forward in
    # train mode and the input's gradient
    g = job["gather"]
    cfg = YoloConfig(**g["cfg"])
    whole = YOLO(cfg)
    whole.load_state_dict(g["state"])
    cut = YOLO(cfg)
    cut.load_state_dict(g["state"])
    shard_model_(cut, mesh)
    out["gather"] = {}
    for name in g["convs"]:
        got = []
        for model in (whole, cut):
            x = g["inputs"][name].clone().requires_grad_()
            with data_parallel(mesh if model is cut else None):
                y = model.get_submodule(name)(x, True)
            y.backward(g["dys"][name])
            got.append((y.detach(), x.grad))
        out["gather"][name] = (got, cut.get_submodule(name).tp is not None,
                               cut.get_submodule(name).phases_out)
torch.save(out, out_path)
dist.destroy_process_group()
"""


def _gather_job(state):
    """The phase-major gather's inputs: the p3 config's state, and for
    each conv of GATHER_CONVS a packed NCHW input and an output gradient
    from one seed."""
    kw = _cfg_kw("anchor", 128, P3, 0.5)
    model = YOLO(YoloConfig(**kw))
    model.load_state_dict(state)
    rng = np.random.default_rng(21)
    shapes = {}

    def hook(name):
        def pre(mod, args):
            shapes[name] = tuple(args[0].shape)
        return pre

    handles = [model.get_submodule(n).register_forward_pre_hook(hook(n))
               for n in GATHER_CONVS]
    with torch.no_grad():
        model(torch.zeros((2, 32, 32, 48)))
    for h in handles:
        h.remove()
    inputs, dys = {}, {}
    for name in GATHER_CONVS:
        x = torch.from_numpy(rng.standard_normal(shapes[name]).astype(
            np.float32))
        inputs[name] = x
        with torch.no_grad():
            y = model.get_submodule(name)(x, False)
        dys[name] = torch.from_numpy(rng.standard_normal(tuple(y.shape))
                                     .astype(np.float32))
    return dict(cfg=kw, state=state, convs=GATHER_CONVS, inputs=inputs,
                dys=dys)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Every rank's results by mesh and step, the job, the JAX references
    and the port's one-process steps."""
    tmp = tmp_path_factory.mktemp("packed_mesh")
    specs, variables = {}, {}
    for name, (spec, _) in _steps().items():
        cfg = YoloConfig(**spec["cfg"])
        variables[name] = random_variables(YOLO(cfg, device="meta"), seed=3)
        specs[name] = dict(spec, state=from_flax_variables(variables[name],
                                                           YOLO(cfg)),
                           lr=LR, fused=False)
    refs = {name: ref for name, (_, ref) in _steps().items()
            if ref is not None}
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    cmds, outs = [], {}
    for (axis, n_data, n), names in MESHES.items():
        world = n_data * n
        sub = tmp / f"{axis}{n_data}x{n}"
        sub.mkdir()
        job = {"steps": {k: specs[k] for k in names}}
        if axis == "model":
            job["gather"] = _gather_job(specs["p3"]["state"])
        torch.save(job, sub / "job.pt")
        outs[(axis, n_data, n)] = [sub / f"rank{r}.pt" for r in range(world)]
        cmds += [[sys.executable, "-c", WORKER, str(r), str(world), axis,
                  str(n), str(sub / "store"), str(sub / "job.pt"),
                  str(sub / f"rank{r}.pt")] for r in range(world)]
    procs = [subprocess.Popen(c, cwd=tmp, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for c in cmds]
    try:
        # the references while the ranks run
        jax_ref = {name: _jax_step(cfg, variables[name], images, targets,
                                   loss_kw)
                   for name, (cfg, images, targets, loss_kw) in refs.items()}
        torch.set_num_threads(1)
        single = {name: _one_process_step(spec)
                  for name, spec in specs.items()}
        results = [p.communicate(timeout=JOIN_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    got = {m: [torch.load(f, weights_only=False) for f in files]
           for m, files in outs.items()}
    return got, specs, jax_ref, single


CASES = [(m, name) for m, names in MESHES.items() for name in names]
IDS = [f"{a}{d}x{n}-{name}" for (a, d, n), name in CASES]


def _losses(ranks, axis, n):
    """The global loss: the ranks' parts summed (space), or model index
    0's parts over the data shards (a model group's ranks hold one
    part)."""
    return sum(r["metrics"]["loss"] for r in (ranks if axis == "space"
                                              else ranks[::n]))


def _ranks_agree(ranks, axis):
    first = ranks[0]
    for r, other in enumerate(ranks):
        for key in ("grads", "full"):
            for k, v in other[key].items():
                assert torch.equal(v, first[key][k]), (r, key, k)
        if axis == "model":
            for k, v in other["local"].items():
                if k not in other["keys"]:
                    assert torch.equal(v, first["local"][k]), (r, k)


@pytest.mark.parametrize("mesh,name", [c for c in CASES if c[1] in JAX_HELD],
                         ids=[i for c, i in zip(CASES, IDS)
                              if c[1] in JAX_HELD])
def test_packed_mesh_step_matches_jax(meshes, mesh, name):
    got_all, specs, jax_ref, _ = meshes
    ranks = [r["steps"][name] for r in got_all[mesh]]
    _ranks_agree(ranks, mesh[0])
    cfg = YoloConfig(**specs[name]["cfg"])
    loss, grads, params, batch_stats = jax_ref[name]
    np.testing.assert_allclose(_losses(ranks, mesh[0], mesh[2]), loss,
                               rtol=1e-4)
    model = YOLO(cfg, device="meta")
    want_grads = from_flax_variables(
        {"params": grads, "batch_stats": batch_stats}, model)
    for k, g in ranks[0]["grads"].items():
        want = want_grads[k].numpy()
        atol = 2e-4 if k in PRE_BN_BIASES else 2e-2 * np.abs(want).max()
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=atol,
                                   err_msg=k)
    want = from_flax_variables({"params": params,
                                "batch_stats": batch_stats}, model)
    start = specs[name]["state"]
    for k, t in ranks[0]["full"].items():
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


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_packed_mesh_step_matches_one_process(meshes, mesh, name):
    got_all, specs, _, single = meshes
    ranks = [r["steps"][name] for r in got_all[mesh]]
    _ranks_agree(ranks, mesh[0])
    loss, grads, state, _ = single[name]
    total = _losses(ranks, mesh[0], mesh[2])
    if mesh[0] == "model":
        np.testing.assert_allclose(total, loss, rtol=TP_LOSS_RTOL)
        for k, t in ranks[0]["full"].items():
            torch.testing.assert_close(t, state[k], rtol=0,
                                       atol=TP_PARAM_ATOL, msg=k)
        for k, g in ranks[0]["grads"].items():
            atol = 2e-4 if k in PRE_BN_BIASES else 2e-2 * grads[k].abs().max()
            torch.testing.assert_close(g, grads[k], rtol=0, atol=float(atol),
                                       msg=k)
        return
    af = YoloConfig(**specs[name]["cfg"]).head_type == "anchor_free"
    # the rank-without-rows case sums four parts, one empty, of statistics
    # that divide global sums (1.03e-6 relative measured): the anchor-free
    # bound
    rtol = 1e-5 if af or mesh == ("space", 1, 4) else 1e-6
    np.testing.assert_allclose(total, loss, rtol=rtol)
    for k, g in ranks[0]["grads"].items():
        if k not in PRE_BN_BIASES:
            torch.testing.assert_close(
                g, grads[k], rtol=0,
                atol=1e-3 * grads[k].abs().max().item(), msg=k)
    for k, t in ranks[0]["full"].items():
        if k.endswith((".bn.mean", ".bn.var")):
            torch.testing.assert_close(
                t, state[k], rtol=0,
                atol=1e-5 * state[k].abs().max().item(), msg=k)


def test_packed_model_mesh_cuts_canonical_rows(meshes):
    """Under the model mesh the cut packed convs hold cout / 2 canonical
    rows of their weight, bias and BatchNorm; the packed C3a and stem
    convs (canonical cout < 64) stay whole."""
    got_all, specs, *_ = meshes
    ranks = got_all[("model", 1, 2)]
    full = specs["p3"]["state"]
    local, keys = ranks[0]["steps"]["p3"]["local"], ranks[0]["steps"]["p3"][
        "keys"]
    for name in ("bb_p3_down", "lateral_p3", "bb_p3_c3b.conv3",
                 "merge_p3.conv3", "downsample_p3_to_p4", "bb_p4_down"):
        for leaf in ("conv.weight", "bn.scale", "bn.mean"):
            k = f"{name}.{leaf}"
            assert k in keys and local[k].shape[0] == full[k].shape[0] // 2
    for name in ("stem0", "stem1", "bb_p3_c3a.conv1",
                 "bb_p3_c3a.bottleneck0.conv1"):
        assert f"{name}.conv.weight" not in keys


@pytest.mark.parametrize("conv", GATHER_CONVS)
def test_cut_packed_conv_gathers_phase_major(meshes, conv):
    got_all, *_ = meshes
    for r in got_all[("model", 1, 2)]:
        ((y, dx), (yc, dxc)), cut, phases = r["gather"][conv]
        assert cut
        assert phases == {"bb_p3_down": 4, "merge_p3.conv3": 4,
                          "bb_p4_down": 1}[conv]
        torch.testing.assert_close(yc, y, rtol=0,
                                   atol=1e-6 * y.abs().max().item())
        torch.testing.assert_close(dxc, dx, rtol=0,
                                   atol=1e-6 * dx.abs().max().item())


@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
@pytest.mark.parametrize("n", [2, 4])
def test_packed_sharded_fraction_equals_jax(head, n):
    cfg = YoloConfig.from_size("s", num_classes=80, img_size=640,
                               head_type=head).with_(**P3)
    params = random_variables(YOLO(cfg, device="meta"), seed=0)["params"]
    want = jax_tensor.sharded_fraction(jax_tensor.shard_state_tp(
        jax_tensor.make_mesh_dm(n), params))
    model = port_tensor.shard_model_(
        YOLO(cfg, device="meta"),
        port_mesh.Mesh(1, n, torch.device("cpu"), n_model=n))
    assert port_tensor.sharded_fraction(model) == want
    unpacked = port_tensor.shard_model_(
        YOLO(cfg.with_(packed_stem=False, packed_interior=False,
                       packed_p3=False), device="meta"),
        port_mesh.Mesh(1, n, torch.device("cpu"), n_model=n))
    assert port_tensor.sharded_fraction(unpacked) == want
