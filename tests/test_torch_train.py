"""Train step of the PyTorch port (`train/steps.py`) against the JAX
package's, on the CPU, at the conftest size (128x128, width 0.25, batch 2,
float32).

Both start from the JAX train state of `shared_train_setup`, converted
through `from_flax_variables`, and take the same host batch. The port runs
with `YOLO_FUSED_CONV_BWD` at 0 and at 1 (the fused backward's plain version
for the 6 convs the gate selects here); the JAX side at its default.

Tolerances, and why. Train-mode BatchNorm takes the JAX package's
float32 fast variance, mean(x^2) - mean(x)^2, whose cancellation loses
digits where an activation's mean is large against its spread (measured on
one layer: mean/std = 10 gives variances 1e-4 apart between the two
packages, each as far from exact). At batch 2 and 4x4 maps this compounds
through the net:
- loss: 1e-4 relative (measured 2.1e-5); its components 1e-3 (bbox, the
  most sensitive, measured 4.4e-4); running statistics 1e-3 relative and
  1e-4 of each tensor's largest magnitude.
- gradients: 2e-2 of each tensor's largest magnitude (measured at most
  6.6e-3, on BatchNorm scales and 1x1 convs).
- the conv biases in front of a train-mode BatchNorm (`stem0`, `stem1`,
  `bb_*_down`, both SPPF convs) have a gradient of exactly zero in theory;
  what both packages compute is rounding noise (up to 8e-5 on `stem0`),
  compared with atol 2e-4. Adam turns that noise into steps of about +-lr
  with a sign set by the reduction order, so after k steps those biases get
  atol 2*k*lr. So does any weight whose gradient is within the noise.
- three steps run at lr 1e-5, small enough that the two trajectories do
  not part (at lr 1e-3 such sign flips move the third loss by 2%): losses
  2e-4 relative (measured 8e-5); the change of every parameter within
  2*k*lr, and for 90% of each tensor's elements within 0.05*lr (measured
  0.009*lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yolo_from_scratch_tpu.data.dataset import YoloDataset
from yolo_from_scratch_tpu.data.loader import DataLoader
from yolo_from_scratch_tpu.train.steps import _make_loss_fn
from yolo_from_scratch_tpu.train.steps import make_optimizer as jax_optimizer
from yolo_from_scratch_tpu.train.steps import set_learning_rate as jax_set_lr
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.train.steps import (
    TrainState,
    clip_by_global_norm_,
    make_loss_fn,
    make_optimizer,
    make_train_step,
)
from yolo_from_scratch_tpu_torch.utils.convert import from_flax_variables

LR = 1e-3  # shared_train_setup's
PRE_BN_BIASES = ("stem0.conv.bias", "stem1.conv.bias", "bb_p3_down.conv.bias",
                 "bb_p4_down.conv.bias", "bb_p5_down.conv.bias",
                 "sppf.conv1.conv.bias", "sppf.conv2.conv.bias")


@pytest.fixture(scope="module")
def batch(cfg, temp_dataset_dir):
    ds = YoloDataset(str(temp_dataset_dir / "train" / "images"), 1,
                     cfg.anchors_array, cfg.img_size, backend="pil")
    images, targets = next(iter(DataLoader(ds, batch_size=2, prefetch=0)))
    assert targets[0][..., 4].sum() + targets[1][..., 4].sum() > 0
    return images, targets


def _variables(state):
    return {"params": state.params, "batch_stats": state.batch_stats}


def _port_state(cfg, jax_state, lr=LR):
    """The port's train state holding a JAX train state's weights."""
    model = YOLO(cfg)
    model.load_state_dict(from_flax_variables(
        jax.tree_util.tree_map(np.asarray, _variables(jax_state)), model))
    return TrainState(model, make_optimizer(model.parameters(), lr))


def _as_port(tree, like_state, cfg):
    """A params-shaped JAX tree as port state-dict tensors."""
    variables = {"params": jax.tree_util.tree_map(np.asarray, tree),
                 "batch_stats": jax.tree_util.tree_map(
                     np.asarray, like_state.batch_stats)}
    return from_flax_variables(variables, YOLO(cfg, device="meta"))


def _tensor(batch):
    images, targets = batch
    return torch.from_numpy(images), [torch.from_numpy(t) for t in targets]


@pytest.fixture(scope="module")
def jax_grads(cfg, shared_train_setup, batch):
    model, _, state0, _ = shared_train_setup
    loss_fn = _make_loss_fn(model, cfg, False)
    (total, (new_bs, *parts)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state0.params, state0.batch_stats,
                                jnp.asarray(batch[0]),
                                [jnp.asarray(t) for t in batch[1]])
    return (float(total), [float(p) for p in parts],
            _as_port(grads, state0, cfg),
            from_flax_variables(
                {"params": jax.tree_util.tree_map(np.asarray, state0.params),
                 "batch_stats": jax.tree_util.tree_map(np.asarray, new_bs)},
                YOLO(cfg, device="meta")))


@pytest.mark.parametrize("flag", ["0", "1"])
def test_one_step_gradients_match_jax(cfg, shared_train_setup, batch,
                                      jax_grads, monkeypatch, flag):
    monkeypatch.setenv("YOLO_FUSED_CONV_BWD", flag)
    want_total, want_parts, want_grads, want_state = jax_grads
    state = _port_state(cfg, shared_train_setup[2])
    total, parts = make_loss_fn(cfg)(state.model, *_tensor(batch))
    total.backward()
    np.testing.assert_allclose(total.item(), want_total, rtol=1e-4)
    np.testing.assert_allclose([p.item() for p in parts], want_parts,
                               rtol=1e-3)
    for name, p in state.model.named_parameters():
        want = want_grads[name].numpy()
        atol = 2e-4 if name in PRE_BN_BIASES else 2e-2 * np.abs(want).max()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=atol,
                                   err_msg=name)
    # the running statistics moved as the JAX ones did
    for name, buf in state.model.named_buffers():
        want = want_state[name].numpy()
        np.testing.assert_allclose(buf.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_and_adam_match_optax(cfg, shared_train_setup, scale):
    """Two clip+Adam updates on given gradients; scale 10 puts the global
    norm far above 10, where the clip fires. Both sides compute the same
    float32 update formula in another op order: 2.5e-7 absolute, two ulps
    of a param of magnitude ~1 (2.5e-4 of an update of ~1e-3)."""
    state0 = shared_train_setup[2]
    rng = np.random.default_rng(int(scale * 1000))
    leaves, treedef = jax.tree_util.tree_flatten(state0.params)
    grads = [treedef.unflatten([
        (rng.standard_normal(np.shape(leaf)) * scale).astype(np.float32)
        for leaf in leaves]) for _ in range(2)]

    tx = jax_optimizer(LR)
    params, opt_state = state0.params, tx.init(state0.params)

    @jax.jit
    def update(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for g in grads:
        params, opt_state = update(g, opt_state, params)

    state = _port_state(cfg, state0)
    named = dict(state.model.named_parameters())
    norms = []
    for g in grads:
        port_g = _as_port(g, state0, cfg)
        for name, p in named.items():
            p.grad = port_g[name].clone()
        norms.append(clip_by_global_norm_([p.grad for p in named.values()]))
        state.optimizer.step()
    assert (max(norms) > 10.0) == (scale > 1.0)
    want = _as_port(params, state0, cfg)
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=2.5e-7, err_msg=name)


@pytest.mark.parametrize("flag", ["0", "1"])
def test_three_steps_match_jax(cfg, shared_train_setup, batch, monkeypatch,
                               flag):
    monkeypatch.setenv("YOLO_FUSED_CONV_BWD", flag)
    lr, k = 1e-5, 3
    _, _, state0, jax_step = shared_train_setup
    # the learning rate lives in the optimizer state: a copy takes lr
    # without touching the shared state or recompiling the step
    jax_state = jax_set_lr(state0.replace(opt_state=jax.tree_util.tree_map(
        lambda a: a, state0.opt_state)), lr)
    images, targets = jnp.asarray(batch[0]), [jnp.asarray(t)
                                              for t in batch[1]]
    jax_losses = []
    for _ in range(k):
        jax_state, metrics = jax_step(jax_state, images, targets)
        jax_losses.append(float(metrics["loss"]))

    state = _port_state(cfg, state0, lr)
    start = {n: t.clone() for n, t in state.model.state_dict().items()}
    step = make_train_step(cfg)
    losses = []
    for _ in range(k):
        state, metrics = step(state, *_tensor(batch))
        losses.append(metrics["loss"].item())
    assert state.step == k
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-4)
    want = from_flax_variables(
        jax.tree_util.tree_map(np.asarray, _variables(jax_state)),
        state.model)
    for name, t in state.model.state_dict().items():
        if name.endswith((".bn.mean", ".bn.var")):
            np.testing.assert_allclose(
                t.numpy(), want[name].numpy(), rtol=1e-3,
                atol=1e-4 * want[name].abs().max().item(), err_msg=name)
            continue
        diff = np.abs((t - start[name]).numpy()
                      - (want[name] - start[name]).numpy())
        assert diff.max() <= 2 * k * lr, (name, diff.max() / lr)
        if name not in PRE_BN_BIASES:
            assert np.quantile(diff, 0.9) <= 0.05 * lr, (
                name, np.quantile(diff, 0.9) / lr)


def test_bf16_step_updates_float32_master_weights(cfg, shared_train_setup,
                                                  batch):
    """The repair: one bfloat16 step at lr 1e-6 moves the float32 master
    weights by optax's update u for the same gradients, where bfloat16
    weights would have rounded almost every such update away. Tolerance:
    one ulp of w (w + u is rounded to float32) plus 1e-5 of u (optax
    evaluates Adam's bias correction 1 - 0.999^t in float32, where 0.999
    rounds to 0.99900001, torch in double: 6.4e-6 apart at t = 1)."""
    lr = 1e-6
    bf = cfg.with_(compute_dtype="bfloat16")
    state = _port_state(bf, shared_train_setup[2], lr)
    named = dict(state.model.named_parameters())
    assert all(p.dtype == torch.float32 for p in named.values())
    before = {n: p.detach().clone() for n, p in named.items()}
    total, _ = make_loss_fn(bf)(state.model, *_tensor(batch))
    total.backward()
    clip_by_global_norm_([p.grad for p in named.values()])
    grads = {n: p.grad.numpy().copy() for n, p in named.items()}
    state.optimizer.step()

    # optax's update for these gradients, on the JAX side
    flat = {tuple(k.split(".")): v for k, v in grads.items()}
    tx = jax_optimizer(lr)
    params = {k: before[".".join(k)].numpy() for k in flat}
    updates, _ = jax.jit(tx.update)(flat, tx.init(params), params)
    moved = lost = total_n = 0
    for name, p in named.items():
        delta = (p.detach() - before[name]).numpy()
        u = np.asarray(updates[tuple(name.split("."))])
        ulp = np.spacing(np.abs(before[name].numpy()) + np.abs(u))
        assert (np.abs(delta - u) <= ulp + 1e-5 * np.abs(u)).all(), name
        moved += int((delta != 0).sum())
        stay = (before[name] + torch.from_numpy(delta)).bfloat16() == \
            before[name].bfloat16()
        lost += int(stay.sum())
        total_n += delta.size
    assert moved > 0.99 * total_n
    assert lost > 0.9 * total_n
