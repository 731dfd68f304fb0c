"""`--resume` across packages (`train/loop.py::restore_train_state`,
`train/steps.py::load_optax_state`), on the CPU at
tests/test_torch_multistep.py's size (64x64, width 0.25, nc=3, batch 2,
float32).

- A checkpoint the port's `fit` writes (Adam or AdamW, with or without an
  EMA) restores in JAX's `restore_train_state`, and one in JAX's `fit`
  layout restores in the port's, with the raw weights, the EMA, Adam's
  moments, the counts, the learning rate and the step equal as data.
- In the port, 2 epochs straight equal 1 epoch + restore + 1 epoch bit for
  bit, EMA included: the live state and both checkpoints leaf for leaf.
- An AdamW checkpoint does not restore into Adam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_multistep import (
    LR,
    _cfg,
    jax_state,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    variables,
)

from yolo_from_scratch_tpu.train.loop import (
    restore_train_state as jax_restore,
)
from yolo_from_scratch_tpu.train.steps import TrainState as JaxState
from yolo_from_scratch_tpu.train.steps import make_optimizer as jax_optimizer
from yolo_from_scratch_tpu.utils.checkpoint import (
    save_checkpoint as jax_save,
)
from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
from yolo_from_scratch_tpu_torch.train.loop import fit, restore_train_state
from yolo_from_scratch_tpu_torch.train.steps import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from yolo_from_scratch_tpu_torch.utils.checkpoint import read_payload
from yolo_from_scratch_tpu_torch.utils.convert import to_flax_variables

DECAY = 0.9  # the EMA's decay in `_port_fit`: far from the weights


def _loaders(cfg, root):
    return [DataLoader(YoloDataset(str(root / s / "images"), cfg.num_classes,
                                   cfg.anchors_array, cfg.img_size),
                       batch_size=2, prefetch=0) for s in ("train", "val")]


def _port_fit(cfg, root, path, epochs, weight_decay=0.0, use_ema=True,
              state=None, **kw):
    if state is None:
        state = create_train_state(cfg, LR, seed=5, device="cpu",
                                   weight_decay=weight_decay)
    state, _ = fit(state, make_train_step(cfg), make_eval_step(cfg),
                   *_loaders(cfg, root), cfg, device="cpu", epochs=epochs,
                   initial_lr=LR, warmup_epochs=0, save_path=path,
                   log=lambda *_: None, use_ema=use_ema, ema_decay=DECAY,
                   **kw)
    return state


def _flat(tree, prefix=()):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(val)
    return out


def _assert_trees_equal(a, b):
    a, b = _flat(a), _flat(b)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


CASES = [(wd, ema) for wd in (0.0, 0.05) for ema in (False, True)]
IDS = [f"{'adamw' if wd else 'adam'}-{'ema' if ema else 'raw'}"
       for wd, ema in CASES]


@pytest.mark.parametrize("wd,use_ema", CASES, ids=IDS)
def test_port_checkpoint_restores_in_jax(wd, use_ema,
                                         temp_dataset_multiclass, tmp_path):
    cfg = _cfg()
    path = tmp_path / "port.ckpt"
    state = _port_fit(cfg, temp_dataset_multiclass, path, 1, wd, use_ema)
    jst, jcfg, start, jema = jax_restore(path, jax_optimizer(LR, wd))
    pst, pcfg, pstart, pema = restore_train_state(path, LR, device="cpu",
                                                  weight_decay=wd)
    assert start == pstart == 1
    assert (jcfg.img_size, jcfg.num_classes) == (pcfg.img_size,
                                                 pcfg.num_classes)
    assert int(jst.step) == pst.step == state.step == 2
    live = to_flax_variables(state.model.state_dict())
    _assert_trees_equal({"params": jst.params,
                         "batch_stats": jst.batch_stats}, live)
    _assert_trees_equal(to_flax_variables(pst.model.state_dict()), live)
    assert (jema is None) == (pema is None) == (not use_ema)
    if use_ema:
        _assert_trees_equal(jema, to_flax_variables(pema))
        assert any(not np.array_equal(a, b) for a, b in zip(
            _flat(jema).values(), _flat(live).values()))
    opt = jst.opt_state
    adam = opt.inner_state[1][0]
    assert int(opt.count) == int(adam.count) == 2
    for p, (name, q) in zip(pst.model.parameters(),
                            state.model.named_parameters()):
        mine, theirs = pst.optimizer.state[p], state.optimizer.state[q]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(mine[key], theirs[key], rtol=0,
                                       atol=0, msg=f"{name} {key}")
    for key, moments in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        _assert_trees_equal(moments, to_flax_variables(
            {n: state.optimizer.state[p][key]
             for n, p in state.model.named_parameters()})["params"])
    lr = np.float32(opt.hyperparams["learning_rate"])
    assert lr == np.float32(pst.optimizer.param_groups[0]["lr"]) == \
        np.float32(state.optimizer.param_groups[0]["lr"])


def _jax_checkpoint(cfg, path, wd, use_ema):
    """A checkpoint as JAX's `fit` writes it after two updates of random
    gradients: (the JAX state, its EMA variables or None)."""
    var = variables(cfg, seed=6)
    tx, st = jax_state(var, wd)
    rng = np.random.default_rng(7)
    params, opt_state = st.params, st.opt_state
    update = jax.jit(lambda g, o, p: (lambda u, o2: (
        optax.apply_updates(p, u), o2))(*tx.update(g, o, p)))
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: np.asarray(rng.normal(0, 1, p.shape), np.float32),
            params)
        params, opt_state = update(grads, opt_state, params)
    st = JaxState(params, st.batch_stats, opt_state, jnp.int32(2))
    raw = {"params": params, "batch_stats": st.batch_stats}
    ema = variables(cfg, seed=8) if use_ema else None
    extra = {"step": 2}
    if use_ema:
        extra["raw_params"] = jax.device_get(params)
        extra["raw_batch_stats"] = jax.device_get(st.batch_stats)
    jax_save(path, ema or raw, cfg, epoch=3, opt_state=opt_state,
             extra=extra)
    return st, ema


@pytest.mark.parametrize("wd,use_ema", CASES, ids=IDS)
def test_jax_checkpoint_restores_in_port(wd, use_ema, tmp_path):
    cfg = _cfg()
    path = tmp_path / "jax.ckpt"
    jst, jema = _jax_checkpoint(cfg, path, wd, use_ema)
    state, pcfg, start, ema_sd = restore_train_state(path, LR, device="cpu",
                                                     weight_decay=wd)
    assert start == 4 and state.step == 2
    assert (pcfg.img_size, pcfg.num_classes) == (cfg.img_size,
                                                 cfg.num_classes)
    _assert_trees_equal(to_flax_variables(state.model.state_dict()),
                        {"params": jst.params, "batch_stats": jst.batch_stats})
    if use_ema:
        _assert_trees_equal(to_flax_variables(ema_sd), jema)
    else:
        assert ema_sd is None
    adam = jst.opt_state.inner_state[1][0]
    for key, moments in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        _assert_trees_equal(to_flax_variables(
            {n: state.optimizer.state[p][key]
             for n, p in state.model.named_parameters()})["params"],
            moments)
    assert {float(s["step"]) for s in state.optimizer.state.values()} == {2.0}
    assert isinstance(state.optimizer, torch.optim.AdamW) == bool(wd)
    assert np.float32(state.optimizer.param_groups[0]["lr"]) == np.float32(
        jst.opt_state.hyperparams["learning_rate"])


@pytest.mark.parametrize("wd", [0.0, 0.05], ids=["adam", "adamw"])
def test_two_epochs_equal_one_plus_resume(wd, temp_dataset_multiclass,
                                          tmp_path):
    """Bit for bit: the live state, and both final checkpoints leaf for
    leaf (the EMA, the raw weights, the optax state, the step)."""
    cfg = _cfg()
    root = temp_dataset_multiclass
    straight = _port_fit(cfg, root, tmp_path / "straight.ckpt", 2, wd)
    _port_fit(cfg, root, tmp_path / "first.ckpt", 1, wd)
    state, _, start, ema_sd = restore_train_state(
        tmp_path / "first.ckpt", LR, device="cpu", weight_decay=wd)
    resumed = _port_fit(cfg, root, tmp_path / "resumed.ckpt", 2, wd,
                        state=state, start_epoch=start, initial_ema=ema_sd)
    assert resumed.step == straight.step == 4
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            straight.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    for p, q in zip(resumed.model.parameters(), straight.model.parameters()):
        for key, v in straight.optimizer.state[q].items():
            torch.testing.assert_close(resumed.optimizer.state[p][key], v,
                                       rtol=0, atol=0)
    _assert_trees_equal(read_payload(tmp_path / "resumed.ckpt"),
                        read_payload(tmp_path / "straight.ckpt"))


def test_restore_checks_the_optimizer(temp_dataset_multiclass, tmp_path):
    """An AdamW checkpoint does not restore into Adam (nor the other way):
    the checkpoint names the chain, the message the flag."""
    cfg = _cfg()
    path = tmp_path / "adamw.ckpt"
    _port_fit(cfg, temp_dataset_multiclass, path, 1, 0.05, use_ema=False)
    with pytest.raises(ValueError, match="--weight-decay"):
        restore_train_state(path, LR, device="cpu")
