"""The PyTorch port's compact-label training path (`train/steps.py` with
`compact_targets`, `sparse_loss`, `device_mosaic`, `device_augment`; AdamW
for `--weight-decay`; the CLI's flags) against the JAX package, on the CPU
at 64x64, width 0.25, nc=3, batch 2, float32.

Tolerances, and why:
- one compact train step from the same weights and batch, mosaic and
  augmentation off, for the anchor head, the anchor head with the sparse
  loss and the anchor-free head: tests/test_torch_train.py's for the dense
  step, for its reasons (the JAX package's float32 fast variance in
  train-mode BatchNorm; Adam turns gradient noise into +-lr steps): the
  loss within 1e-4 relative; at lr 1e-5 every parameter's change within
  2*lr of JAX's and 90% of each tensor's within 0.05*lr (except the conv
  biases in front of a BatchNorm, whose gradient is rounding noise);
  running statistics 1e-3 relative and 1e-4 of each tensor's max;
- the compact eval step against the dense eval step on the same data:
  counts equal (the device assignment is bit-equal to the host's); the
  loss within 1e-5 relative of the dense one (anchor head: the same maps)
  or of JAX's compact eval step (anchor-free: its loss reads the label
  rows, the dense one the GTs that won a cell);
- three clip + AdamW updates against optax's `make_optimizer(lr, 0.05)`:
  tests/test_torch_train.py's clip + Adam tolerance, 2.5e-7 absolute,
  plus one float32 ulp of the parameter for each of the three steps:
  torch decays p * (1 - lr * W) before the Adam step, optax adds W * p
  into the update, and the two round apart by up to an ulp of p;
- `optax_state_dict` of an AdamW state: the key paths, shapes and dtypes
  of `to_state_dict(tx.init(params))` for the adamw chain, and JAX's
  `restore_train_state` reads a checkpoint the port's CLI wrote.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from test_torch_resume import _flat, _port_tree
from test_torch_train import PRE_BN_BIASES

from yolo_from_scratch_tpu.config import YoloConfig
from yolo_from_scratch_tpu.data.assign_device import pack_labels
from yolo_from_scratch_tpu.data.dataset import assign_targets
from yolo_from_scratch_tpu.models.anchor_free import (
    assign_targets_anchor_free,
)
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu.train.loop import restore_train_state
from yolo_from_scratch_tpu.train.steps import TrainState as JaxState
from yolo_from_scratch_tpu.train.steps import make_eval_step as jax_eval_step
from yolo_from_scratch_tpu.train.steps import make_optimizer as jax_optimizer
from yolo_from_scratch_tpu.train.steps import make_train_step as jax_step
from yolo_from_scratch_tpu_torch import cli
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.train.steps import (
    TrainState,
    clip_by_global_norm_,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    optax_state_dict,
)
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)

NC, IMG, B, K = 3, 64, 2, 8
LR = 1e-5
WD = 0.05


def _cfg(head="anchor"):
    return YoloConfig(num_classes=NC, img_size=IMG, width_mult=0.25,
                      depth_mult=0.33, head_type=head)


@pytest.fixture(scope="module")
def batch():
    """uint8 images, compact labels (one image with a duplicate slot), and
    their counts."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    boxes, classes = [], []
    for n in (5, 3):
        b = np.concatenate([rng.uniform(0.2, 0.8, (n, 2)),
                            rng.uniform(0.05, 0.5, (n, 2))], 1)
        boxes.append(b.astype(np.float32))
        classes.append(rng.integers(0, NC, n))
    boxes[0][1] = boxes[0][0]
    labels, counts = pack_labels(boxes, classes, K)
    return images, labels, counts


def _variables(cfg, seed=3):
    return random_variables(YOLO(cfg, device="meta"), seed=seed)


def _port_model(cfg, variables):
    model = YOLO(cfg)
    model.load_state_dict(from_flax_variables(variables, model))
    return model


@pytest.mark.parametrize("head,sparse", [("anchor", False), ("anchor", True),
                                         ("anchor_free", False)])
def test_one_compact_step_matches_jax(batch, head, sparse):
    cfg = _cfg(head)
    variables = _variables(cfg)
    tx = jax_optimizer(LR)
    state0 = JaxState(params=variables["params"],
                      batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]),
                      step=jnp.zeros((), jnp.int32))
    step = jax_step(JaxYOLO(cfg), tx, cfg, donate=False, compact_targets=True,
                    sparse_loss=sparse)
    jax_state, jax_metrics = step(state0, jnp.asarray(batch[0]),
                                  (jnp.asarray(batch[1]),
                                   jnp.asarray(batch[2])))

    model = _port_model(cfg, variables)
    state = TrainState(model, make_optimizer(model.parameters(), LR))
    start = {n: t.clone() for n, t in model.state_dict().items()}
    state, metrics = make_train_step(cfg, compact_targets=True,
                                     sparse_loss=sparse)(
        state, torch.from_numpy(batch[0]),
        [torch.from_numpy(batch[1]), torch.from_numpy(batch[2])])
    assert state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(),
                               float(jax_metrics["loss"]), rtol=1e-4)
    assert (metrics["obj"].item() == 0.0) == (head == "anchor_free")
    want = from_flax_variables(jax.tree_util.tree_map(np.asarray, {
        "params": jax_state.params, "batch_stats": jax_state.batch_stats}),
        model)
    for name, t in model.state_dict().items():
        if name.endswith((".bn.mean", ".bn.var")):
            np.testing.assert_allclose(
                t.numpy(), want[name].numpy(), rtol=1e-3,
                atol=1e-4 * want[name].abs().max().item(), err_msg=name)
            continue
        diff = np.abs((t - start[name]).numpy()
                      - (want[name] - start[name]).numpy())
        assert diff.max() <= 2 * LR, (name, diff.max() / LR)
        if name not in PRE_BN_BIASES:
            assert np.quantile(diff, 0.9) <= 0.05 * LR, (
                name, np.quantile(diff, 0.9) / LR)


@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
def test_compact_eval_step_equals_dense(batch, head):
    cfg = _cfg(head)
    model = _port_model(cfg, _variables(cfg, seed=4)).eval()
    images, labels, counts = batch
    if head == "anchor":
        per = [assign_targets(labels[i, :n, 1:5],
                              labels[i, :n, 0].astype(np.int64),
                              cfg.anchors_array, IMG, NC)
               for i, n in enumerate(counts)]
    else:
        per = [assign_targets_anchor_free(labels[i, :n, 1:5],
                                          labels[i, :n, 0].astype(np.int64),
                                          IMG, NC)
               for i, n in enumerate(counts)]
    dense = [torch.from_numpy(np.stack([p[s] for p in per]))
             for s in range(3)]
    want = make_eval_step(cfg)(model, torch.from_numpy(images).float()
                               * (1 / 255.0), dense)
    got = make_eval_step(cfg, compact_targets=True)(
        model, torch.from_numpy(images),
        [torch.from_numpy(labels), torch.from_numpy(counts)])
    if head == "anchor_free":
        # the compact loss reads every label row (the duplicate too), the
        # dense one the GTs that won a cell: JAX's compact step is the
        # reference
        variables = _variables(cfg, seed=4)
        want_loss = float(jax_eval_step(JaxYOLO(cfg), cfg,
                                        compact_targets=True)(
            variables["params"], variables["batch_stats"],
            jnp.asarray(images), (jnp.asarray(labels),
                                  jnp.asarray(counts)))[0])
    else:
        want_loss = want[0].item()
    np.testing.assert_allclose(got[0].item(), want_loss, rtol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.int32
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert int(sum(g.sum() for g in got[1:])) > 0


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_three_adamw_steps_match_optax(scale):
    """Three clip + AdamW updates on given gradients; at scale 10 the clip
    fires. Every parameter, BatchNorm scales and biases included, decays."""
    cfg = _cfg()
    variables = _variables(cfg, seed=5)
    rng = np.random.default_rng(int(scale * 1000))
    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    grads = [treedef.unflatten([
        (rng.standard_normal(np.shape(leaf)) * scale).astype(np.float32)
        for leaf in leaves]) for _ in range(3)]
    lr = 1e-3
    tx = jax_optimizer(lr, WD)
    params, opt_state = variables["params"], tx.init(variables["params"])

    @jax.jit
    def update(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for g in grads:
        params, opt_state = update(g, opt_state, params)

    model = _port_model(cfg, variables)
    optimizer = make_optimizer(model.parameters(), lr, WD)
    assert isinstance(optimizer, torch.optim.AdamW)
    named = dict(model.named_parameters())
    norms = []
    for g in grads:
        port_g = from_flax_variables({"params": g,
                                      "batch_stats": variables["batch_stats"]},
                                     YOLO(cfg, device="meta"))
        for name, p in named.items():
            p.grad = port_g[name].clone()
        norms.append(clip_by_global_norm_([p.grad for p in named.values()]))
        optimizer.step()
    assert (max(norms) > 10.0) == (scale > 1.0)
    want = from_flax_variables({"params": jax.tree_util.tree_map(
        np.asarray, params), "batch_stats": variables["batch_stats"]},
        YOLO(cfg, device="meta"))
    for name, p in named.items():
        w = want[name].numpy()
        err = np.abs(p.detach().numpy() - w)
        tol = 2.5e-7 + 3 * np.spacing(np.abs(w))
        assert (err <= tol).all(), (name, (err / tol).max())


def test_adamw_opt_state_layout_is_optax():
    cfg = _cfg()
    state = create_train_state(cfg, LR, seed=1, device="cpu",
                               weight_decay=WD)
    written = _flat(optax_state_dict(state))
    params = _port_tree(dict(state.model.named_parameters()))
    want = _flat(jax.device_get(serialization.to_state_dict(
        jax_optimizer(LR, WD).init(params))))
    assert sorted(written) == sorted(want)
    assert ("inner_state", "1", "2") in want
    for key, w in want.items():
        got = written[key]
        if isinstance(w, dict):
            assert got == w == {}, key
            continue
        np.testing.assert_array_equal(got, np.asarray(w), err_msg=str(key))
        assert got.dtype == np.asarray(w).dtype, key


EPOCH = re.compile(r"Epoch 1: Loss: \d+\.\d{4} \(bbox: \d+\.\d{4}, obj: "
                   r"\d+\.\d{4}, cls: \d+\.\d{4}\) \| Val: .* \| Det: P .* "
                   r"\| LR: .* img/s")


def _run(capsys, argv):
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


def test_cli_compact_recipes_and_flag_rules(temp_dataset_multiclass,
                                            tmp_path, monkeypatch, capsys):
    """Both heads train through the CLI on the compact path with mosaic,
    augmentation and (anchor-free) weight decay, and `--val-det`; JAX's
    `restore_train_state` with `make_optimizer(lr, W)` reads the AdamW
    checkpoint; compact evaluation prints the dense evaluation's lines
    (anchor head) or a NOTE (anchor-free); the flag rules are the JAX
    CLI's."""
    monkeypatch.chdir(tmp_path)
    yaml_file = str(temp_dataset_multiclass / "dataset.yaml")
    common = [yaml_file, "--epochs", "1", "--batch-size", "2", "--size", "n",
              "--img-size", str(IMG), "--device", "cpu", "--val-det",
              "--lr", "1e-3"]
    ckpts = {}
    for head, extra in (("anchor", ["--compact-targets", "--sparse-loss",
                                    "--device-mosaic", "--device-augment"]),
                        ("anchor_free", ["--compact-targets", "8",
                                         "--device-mosaic", "--device-augment",
                                         "flip", "--weight-decay", str(WD),
                                         "--sparse-loss"])):
        # a working directory a head: two runs that end in the same second
        # would otherwise share the CLI's `yolo_<timestamp>.ckpt`
        (tmp_path / head).mkdir()
        monkeypatch.chdir(tmp_path / head)
        rc, out = _run(capsys, common + ["--head", head] + extra)
        assert rc == 0, out
        assert EPOCH.search(out), out
        assert ("NOTE: --sparse-loss ignored (anchor-free TAL is already "
                "dense-transport-free)" in out) == (head == "anchor_free")
        ckpts[head] = str((tmp_path / head / re.search(
            r"Model saved to (\S+)", out).group(1)).resolve())
    assert ckpts["anchor"] != ckpts["anchor_free"]

    jax_state, _, start_epoch, _ = restore_train_state(
        ckpts["anchor_free"], jax_optimizer(1e-3, WD))
    assert start_epoch == 1 and int(jax_state.opt_state.count) == 2
    assert int(jax_state.opt_state.inner_state[1][0].count) == 2

    evals = [_run(capsys, [yaml_file, ckpts["anchor"], "--device", "cpu",
                           "--batch-size", "2"] + flag)
             for flag in ([], ["--compact-targets"])]
    assert evals[0] == evals[1] and evals[0][0] == 0
    assert "Validation Set:" in evals[0][1]
    rc, out = _run(capsys, [yaml_file, ckpts["anchor_free"], "--device",
                            "cpu", "--batch-size", "2", "--compact-targets"])
    assert rc == 0 and "NOTE: --compact-targets ignored (anchor head only)" \
        in out

    for flag, words in (("--device-mosaic", "--device-mosaic requires "
                                            "--compact-targets"),
                        ("--sparse-loss", "--sparse-loss requires "
                                          "--compact-targets")):
        rc, out = _run(capsys, common + [flag])
        assert rc == 1 and f"ERROR: {words}" in out, out
