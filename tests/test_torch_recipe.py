"""The recipe knobs of the port's trainers against the JAX package's, on the
CPU at tests/test_torch_multistep.py's size (64x64, width 0.25, nc=3,
batch 2, float32, N=3 steps a chunk); the anchor-free head here, the
anchor head and the accumulating trainer in
tests/test_torch_recipe_anchor.py (each file's JAX traces take most of its
time):

- `make_step_lr` against JAX's at every step of a short schedule: within
  2 ulps (every operation is the float32 one XLA compiles, its divisions
  by constants folded into multiplications; `cos` differs between the
  libraries by an ulp, which the cancellation in 1 + cos near the end of
  the cosine enlarges, so a long schedule's tail differs by more);
- `make_train_step_multi_compact` with `step_lr`, `ema_decay` and `af_hp`
  against JAX's (`make_train_step_multi_pool(af_hp=)`:
  tests/test_torch_accum.py), mosaic and
  augmentation off, at tests/test_torch_multistep.py's `hold_to_jax`
  bounds: the EMA model is held like the state (its change from the start
  against JAX's), and the optimizer's learning rate after the chunk is
  the last step's, within 2 ulps of JAX's;
- against the port itself, bit for bit: a chunk with `step_lr` and
  `ema_decay` equals N single steps that set the same learning rate and
  update the same EMA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_multistep import (
    LR,
    N,
    _cfg,
    assert_same_state,
    hold_to_jax,
    hold_weights_to_jax,
    jax_state,
    make_chunk,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    port_state,
    variables,
)

from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu.train.ema import ema_init as jax_ema_init
from yolo_from_scratch_tpu.train.schedule import make_step_lr as jax_step_lr
from yolo_from_scratch_tpu.train.steps import (
    make_train_step_multi_compact as jax_multi_compact,
)
from yolo_from_scratch_tpu_torch.train.ema import (
    ema_init,
    ema_update,
)
from yolo_from_scratch_tpu_torch.train.schedule import make_step_lr
from yolo_from_scratch_tpu_torch.train.steps import (
    make_train_step,
    make_train_step_multi_compact,
    set_learning_rate,
)

# a per-step schedule over the chunk at the parity tests' learning rate
SCHEDULE = dict(total_steps=6, warmup_steps=2, initial_lr=LR, min_lr=LR / 10)
EMA_DECAY = 0.999
AF_HP = {"topk": 7, "alpha": 1.0, "cls_weight": 1.0, "box_weight": 5.0}
ULPS = 2


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def test_step_lr_matches_jax():
    """Every step of a 40-step schedule and 5 beyond its end (the cosine
    clamps), warm-up of 7."""
    args = (40, 7, 1.5e-3, 1e-5)
    jax_fn, port_fn = jax.jit(jax_step_lr(*args)), make_step_lr(*args)
    for step in range(45):
        want = np.float32(jax_fn(jnp.int32(step)))
        got = port_fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert _ulps(got.numpy(), want) <= ULPS, (step, got.item(), want)
    # an int step gives the tensor step's value
    assert port_fn(3).item() == port_fn(torch.tensor(3)).item()


def hold_recipe_to_jax(head):
    """A chunk with step_lr and ema_decay (and af_hp for the anchor-free
    head) against JAX's: the state and the EMA at `hold_to_jax`'s bounds,
    the learning rate left within ULPS."""
    cfg = _cfg(head)
    var = variables(cfg)
    images, labels, counts = make_chunk(seed=5)
    hp = AF_HP if head == "anchor_free" else None
    tx, st0 = jax_state(var)
    jax_trainer = jax_multi_compact(
        JaxYOLO(cfg), tx, cfg, donate=False, af_hp=hp,
        step_lr=jax_step_lr(**SCHEDULE), ema_decay=EMA_DECAY)
    (jst, jema), jm = jax_trainer(
        (st0, jax_ema_init({"params": st0.params,
                            "batch_stats": st0.batch_stats})),
        jnp.asarray(images), jnp.asarray(labels), jnp.asarray(counts))
    state = port_state(cfg, var)
    start = {n: t.clone() for n, t in state.model.state_dict().items()}
    (state, ema), metrics = make_train_step_multi_compact(
        cfg, af_hp=hp, step_lr=make_step_lr(**SCHEDULE),
        ema_decay=EMA_DECAY)(
        (state, ema_init(state.model)),
        *(torch.from_numpy(a) for a in (images, labels, counts)))
    hold_to_jax(state, start, (jst, jm), metrics)
    hold_weights_to_jax(ema, start, jema)
    # the learning rate the chunk left is the last step's
    want_lr = np.float32(jst.opt_state.hyperparams["learning_rate"])
    assert _ulps(state.optimizer.param_groups[0]["lr"], want_lr) <= ULPS


def test_multi_compact_recipe_matches_jax_anchor_free():
    hold_recipe_to_jax("anchor_free")


def test_recipe_chunk_equals_single_steps():
    """A chunk with step_lr and ema_decay (anchor-free, af_hp, mosaic and
    flip on) equals N single steps that set the same learning rate first
    and update the same EMA after, bit for bit."""
    cfg = _cfg("anchor_free")
    var = variables(cfg, seed=10)
    chunk = [torch.from_numpy(a) for a in make_chunk(seed=8)]
    flags = dict(device_mosaic=True, device_augment="flip", augment_seed=2,
                 af_hp=AF_HP)
    lr_fn = make_step_lr(**SCHEDULE)
    state = port_state(cfg, var, weight_decay=0.05)
    state.step = 3  # a chunk that does not start at step 0
    ema = ema_init(state.model)
    (multi, multi_ema), got = make_train_step_multi_compact(
        cfg, step_lr=lr_fn, ema_decay=EMA_DECAY, **flags)(
        (state, ema), *chunk)
    single = make_train_step(cfg, compact_targets=True, **flags)
    state = port_state(cfg, var, weight_decay=0.05)
    state.step = 3
    ema = ema_init(state.model)
    per = []
    for i in range(N):
        set_learning_rate(state, lr_fn(torch.tensor(state.step,
                                                     dtype=torch.int32)))
        state, m = single(state, chunk[0][i], (chunk[1][i], chunk[2][i]))
        ema_update(ema, state.model, state.step, EMA_DECAY)
        per.append(m)
    assert_same_state(multi, state)
    for (name, x), y in zip(multi_ema.state_dict().items(),
                            ema.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    for k in got:
        torch.testing.assert_close(
            got[k], torch.stack([m[k] for m in per]).mean(), rtol=0, atol=0)
    assert (multi.optimizer.param_groups[0]["lr"]
            == state.optimizer.param_groups[0]["lr"])
