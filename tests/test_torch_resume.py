"""The port's checkpoints carry Adam's state in the JAX package's optax
layout, so a JAX `--resume` from them continues Adam instead of restarting
it, on the CPU at the conftest size (128x128, width 0.25, float32).

The port trains one epoch of 2 steps through its `fit` and writes a
checkpoint; the JAX `restore_train_state` with `make_optimizer(lr)` reads
it. The moments and both counts must come back exactly: they are float32
and int32 arrays written and read bit for bit. One more update in each
package from there, on the same gradients (the port's, from one more
batch), must agree within 1e-5: both compute the same float32 clip + Adam
formula in another op order (2.5e-7 in tests/test_torch_train.py). The
same update from a restarted Adam differs by about the learning rate
(1e-3), which is what a JAX resume did before the port wrote the state.
"""

import copy

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from yolo_from_scratch_tpu.train.loop import restore_train_state
from yolo_from_scratch_tpu.train.steps import make_optimizer as jax_optimizer
from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.train.loop import fit
from yolo_from_scratch_tpu_torch.train.steps import (
    clip_by_global_norm_,
    create_train_state,
    make_eval_step,
    make_loss_fn,
    make_train_step,
    optax_state_dict,
)
from yolo_from_scratch_tpu_torch.utils.checkpoint import load_checkpoint
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    to_flax_variables,
)

LR = 1e-3
STEPS = 2  # 5 training images at batch 3


def _loader(cfg, root, split):
    ds = YoloDataset(str(root / split / "images"), cfg.num_classes,
                     cfg.anchors_array, cfg.img_size)
    return DataLoader(ds, batch_size=3, prefetch=0)


@pytest.fixture(scope="module")
def trained(cfg, temp_dataset_dir, tmp_path_factory):
    """The port's train state after one epoch of STEPS steps, and the
    checkpoint `fit` wrote."""
    path = tmp_path_factory.mktemp("resume") / "port.ckpt"
    state = create_train_state(cfg, LR, seed=3, device="cpu")
    state, _ = fit(state, make_train_step(cfg), make_eval_step(cfg),
                   _loader(cfg, temp_dataset_dir, "train"),
                   _loader(cfg, temp_dataset_dir, "val"), cfg, device="cpu",
                   epochs=1, initial_lr=LR, warmup_epochs=0, save_path=path,
                   log=lambda *_: None)
    assert state.step == STEPS
    return state, path


def _flat(tree, prefix=()):
    """{key path: leaf} of a nested dict."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + (key,)))
            if not val:
                out[prefix + (key,)] = {}
        else:
            out[prefix + (key,)] = val
    return out


def _port_tree(named):
    """{port parameter name: tensor} -> the JAX params tree (numpy)."""
    return to_flax_variables(named)["params"]


def test_jax_restore_reads_the_ports_adam_state(cfg, trained):
    state, path = trained
    jax_state, _, start_epoch, _ = restore_train_state(
        path, jax_optimizer(LR))
    assert start_epoch == 1 and int(jax_state.step) == STEPS
    opt = jax_state.opt_state
    assert int(opt.count) == STEPS                       # inject_hyperparams'
    adam = opt.inner_state[1][0]
    assert int(adam.count) == STEPS                      # Adam's
    assert float(opt.hyperparams["learning_rate"]) == np.float32(LR)
    params = dict(state.model.named_parameters())
    for key, moment in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = _port_tree({n: state.optimizer.state[p][key]
                           for n, p in params.items()})
        got = jax.tree_util.tree_map(np.asarray, moment)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    assert {int(s["step"]) for s in state.optimizer.state.values()} == {STEPS}

    # the port's own loader hands the state back unchanged
    _, _, meta = load_checkpoint(path)
    for k, v in _flat(optax_state_dict(state)).items():
        np.testing.assert_array_equal(_flat(meta["opt_state"])[k], v)


def test_one_more_step_matches_after_resume(cfg, trained, temp_dataset_dir):
    state, path = copy.deepcopy(trained)
    tx = jax_optimizer(LR)
    jax_state, _, _, _ = restore_train_state(path, tx)

    # the port's gradients at its trained weights, on one more batch
    images, targets = next(iter(_loader(cfg, temp_dataset_dir, "val")))
    named = dict(state.model.named_parameters())
    state.optimizer.zero_grad(set_to_none=True)
    total, _ = make_loss_fn(cfg)(state.model, torch.from_numpy(images),
                                 [torch.from_numpy(t) for t in targets])
    total.backward()
    grads = _port_tree({n: p.grad.clone() for n, p in named.items()})
    clip_by_global_norm_([p.grad for p in named.values()])
    state.optimizer.step()

    update = jax.jit(tx.update)
    meta_model = YOLO(cfg, device="meta")

    def applied(opt_state):
        updates, _ = update(grads, opt_state, jax_state.params)
        new = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u),
                                     jax_state.params, updates)
        return from_flax_variables(
            {"params": new,
             "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                   jax_state.batch_stats)},
            meta_model)

    resumed = applied(jax_state.opt_state)
    restarted = applied(tx.init(jax_state.params))
    far = total_n = 0
    for name, p in named.items():
        got = p.detach().numpy()
        np.testing.assert_allclose(resumed[name].numpy(), got, rtol=0,
                                   atol=1e-5, err_msg=name)
        far += int((np.abs(restarted[name].numpy() - got) > 1e-5).sum())
        total_n += got.size
    assert far > 0.5 * total_n  # a restarted Adam takes another step


@pytest.mark.parametrize("steps", [0, STEPS])
def test_opt_state_layout_is_optax(cfg, trained, steps):
    """The literal layout against `to_state_dict(tx.init(params))`: the
    same key paths, shapes and types; for a state that has taken no step
    the same values too (zero moments, zero counts, the learning rate)."""
    state = trained[0] if steps else create_train_state(cfg, LR, seed=3,
                                                        device="cpu")
    written = _flat(optax_state_dict(state))
    params = _port_tree(dict(state.model.named_parameters()))
    want = _flat(jax.device_get(serialization.to_state_dict(
        jax_optimizer(LR).init(params))))
    assert sorted(written) == sorted(want)
    for key, w in want.items():
        got = written[key]
        if isinstance(w, dict):
            assert got == w == {}, key
            continue
        w = np.asarray(w)
        assert (got.shape, got.dtype) == (w.shape, w.dtype), key
        if not steps:
            np.testing.assert_array_equal(got, w, err_msg=str(key))
