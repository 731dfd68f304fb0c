"""The port's EMA (`train/ema.py`) against the JAX package's, on the CPU at
tests/test_torch_multistep.py's size (64x64, width 0.25, nc=3, batch 2,
float32).

- `ema_decay_at` equals JAX's decay at steps 0, 1 and tau within an ulp
  (both compute decay * (1 - exp(-(step + 1) / tau)) in float32; their
  `exp` may differ by an ulp), and one `ema_update` of a whole model, the
  BatchNorm statistics included, equals JAX's jitted one on the same
  trees within 2 ulps of the terms' magnitude |e| d + |p| (1 - d) (e * d
  + p * (1 - d), rounded once less where XLA fuses the multiply-add);
  `ema_init` copies.
- The EMA-wrapped step of either package over two steps: the state at
  tests/test_torch_multistep.py's `hold_to_jax` bounds, the EMA at the
  same bounds of its change from the start (decay 0.9, tau 1, so the
  average sits well apart from the weights); and two such steps after a
  cross-package resume (a port checkpoint with an EMA, restored by each
  package) match at the same bounds. Checkpoint interchange itself:
  tests/test_torch_restore.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_multistep import (
    LR,
    _cfg,
    hold_weights_to_jax,
    jax_state,
    make_chunk,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    port_state,
    variables,
)
from test_torch_restore import _port_fit

from yolo_from_scratch_tpu.data.dataset import assign_targets
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu.train import ema as jax_ema
from yolo_from_scratch_tpu.train.loop import (
    restore_train_state as jax_restore,
)
from yolo_from_scratch_tpu.train.steps import make_optimizer as jax_optimizer
from yolo_from_scratch_tpu.train.steps import make_train_step as jax_step
from yolo_from_scratch_tpu_torch.train.ema import (
    averaged_tensors,
    ema_decay_at,
    ema_init,
    ema_update,
    wrap_train_step_with_ema,
)
from yolo_from_scratch_tpu_torch.train.loop import restore_train_state
from yolo_from_scratch_tpu_torch.train.steps import make_train_step
from yolo_from_scratch_tpu_torch.utils.convert import from_flax_variables

TAU = 2000.0
DECAY, WRAP_TAU = 0.9, 1.0  # the wrapped steps' EMA: far from the weights


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("step", [0, 1, int(TAU)])
def test_decay_matches_jax(step):
    one = {"x": jnp.ones((), jnp.float32)}
    zero = {"x": jnp.zeros((), jnp.float32)}
    want = np.float32(jax_ema.ema_update(one, zero, jnp.int32(step),
                                         0.9999, TAU)["x"])
    got = ema_decay_at(step, 0.9999, TAU)
    assert got.dtype == torch.float32
    assert _ulps(got.numpy(), want).max() <= 1, (got.item(), want)
    assert got.item() == ema_decay_at(torch.tensor(step, dtype=torch.int32),
                                      0.9999, TAU).item()
    # float32's 1 - exp(-x) cancels at small x: near the exact value only
    exact = 0.9999 * (1.0 - np.exp(-(step + 1.0) / TAU))
    assert abs(got.item() - exact) <= 1e-3 * exact


def test_update_averages_weights_and_statistics_as_jax():
    cfg = _cfg()
    live_vars, avg_vars = variables(cfg, seed=1), variables(cfg, seed=2)
    model, ema = port_state(cfg, live_vars).model, port_state(
        cfg, avg_vars).model
    step = 7
    ema_update(ema, model, step, decay=0.99, tau=10.0)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda e, p: jax_ema.ema_update(e, p, jnp.int32(step), 0.99, 10.0))(
        avg_vars, live_vars))
    want = from_flax_variables(want, ema)
    before = from_flax_variables(avg_vars, ema)
    live = from_flax_variables(live_vars, ema)
    d = ema_decay_at(step, 0.99, 10.0).item()
    stats = 0
    for name, t in ema.state_dict().items():
        # 2 ulps of the terms' magnitude: XLA fuses the multiply-add
        scale = (before[name].abs() * d + live[name].abs() * (1 - d)).numpy()
        np.testing.assert_array_less(
            np.abs(t.numpy() - want[name].numpy()),
            2 * np.spacing(scale.astype(np.float32)) + 1e-45, err_msg=name)
        if name.endswith((".bn.mean", ".bn.var")):
            stats += 1
            assert not torch.equal(t, before[name]), name  # averaged too
    assert stats == len(list(ema.buffers())) > 0


def test_ema_init_copies():
    cfg = _cfg()
    model = port_state(cfg, variables(cfg, seed=3)).model
    ema = ema_init(model)
    for a, b in zip(averaged_tensors(ema), averaged_tensors(model)):
        assert a.data_ptr() != b.data_ptr()
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not any(p.requires_grad for p in ema.parameters())
    before = [t.clone() for t in averaged_tensors(ema)]
    with torch.no_grad():
        for t in averaged_tensors(model):
            t.add_(1.0)
    for a, b in zip(averaged_tensors(ema), before):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _dense_batches(cfg, seed, n=2):
    """n steps of float images (B, S, S, 3) in [0, 1] and dense targets."""
    images, labels, counts = make_chunk(n=n, seed=seed)
    images = images.astype(np.float32) / np.float32(255.0)
    per = [[assign_targets(labels[s, i, :c, 1:5],
                           labels[s, i, :c, 0].astype(np.int64),
                           cfg.anchors_array, cfg.img_size, cfg.num_classes)
            for i, c in enumerate(counts[s])] for s in range(n)]
    targets = [[np.stack([p[g] for p in step]) for g in range(3)]
               for step in per]
    return list(zip(images, targets))


@pytest.fixture(scope="module")
def jax_ema_step():
    """JAX's EMA-wrapped train step, compiled once for the module."""
    cfg = _cfg()
    tx = jax_optimizer(LR)
    step = jax_step(JaxYOLO(cfg), tx, cfg, donate=False)
    return jax.jit(jax_ema.wrap_train_step_with_ema(step, DECAY, WRAP_TAU))


def _run_both(cfg, jax_ema_step, jax_carry, state, ema, batches):
    """The same batches through both packages' EMA-wrapped steps."""
    port_step = wrap_train_step_with_ema(make_train_step(cfg), DECAY,
                                         WRAP_TAU)
    losses = []
    for images, targets in batches:
        jax_carry, jm = jax_ema_step(jax_carry, jnp.asarray(images),
                                     [jnp.asarray(t) for t in targets])
        (state, ema), m = port_step(
            (state, ema), torch.from_numpy(images),
            [torch.from_numpy(t) for t in targets])
        losses.append((m["loss"].item(), float(jm["loss"])))
    return jax_carry, state, ema, losses


def _hold(state, ema, start, jax_carry, losses, steps):
    jst, jema = jax_carry
    assert state.step == int(jst.step)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=steps * 1e-4)
    hold_weights_to_jax(state.model, start, {
        "params": jst.params, "batch_stats": jst.batch_stats}, steps)
    hold_weights_to_jax(ema, start, jema, steps)


def test_wrapped_step_matches_jax(jax_ema_step):
    cfg = _cfg()
    var = variables(cfg, seed=4)
    _, st0 = jax_state(var)
    state = port_state(cfg, var)
    start = {n: t.clone() for n, t in state.model.state_dict().items()}
    carry, state, ema, losses = _run_both(
        cfg, jax_ema_step, (st0, jax_ema.ema_init(var)), state,
        ema_init(state.model), _dense_batches(cfg, seed=9))
    _hold(state, ema, start, carry, losses, 2)
    # the average moved, and is not the weights
    assert any(not torch.equal(a, b) for a, b in
               zip(ema.state_dict().values(), start.values()))
    assert any(not torch.equal(a, b) for a, b in
               zip(ema.state_dict().values(),
                   state.model.state_dict().values()))


def test_steps_after_cross_package_resume_match_jax(
        jax_ema_step, temp_dataset_multiclass, tmp_path):
    """A port checkpoint with an EMA, restored by each package; two more
    EMA-wrapped steps on the same batches."""
    cfg = _cfg()
    path = tmp_path / "port.ckpt"
    _port_fit(cfg, temp_dataset_multiclass, path, 1)
    jst, _, _, jema = jax_restore(path, jax_optimizer(LR))
    state, _, _, ema_sd = restore_train_state(path, LR, device="cpu")
    ema = ema_init(state.model)
    ema.load_state_dict(ema_sd)
    start = {n: t.clone() for n, t in state.model.state_dict().items()}
    ema_start = {n: t.clone() for n, t in ema.state_dict().items()}
    carry, state, ema, losses = _run_both(
        cfg, jax_ema_step, (jst, jema), state, ema,
        _dense_batches(cfg, seed=10))
    jst, jema = carry
    assert state.step == int(jst.step) == 4
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=2e-4)
    hold_weights_to_jax(state.model, start, {
        "params": jst.params, "batch_stats": jst.batch_stats}, 2)
    hold_weights_to_jax(ema, ema_start, jema, 2)
