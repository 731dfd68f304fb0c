"""The anchor head's recipe chunk (`step_lr`, `ema_decay`) against the JAX
package's, on the CPU at tests/test_torch_multistep.py's size (64x64,
width 0.25, nc=3, batch 2, float32), at that file's `hold_to_jax` bounds;
the anchor-free head's in tests/test_torch_recipe.py.

And the port against itself: a chunk's step row is the steps' indices; `graphs.Snapshot` restores an EMA model and a learning rate
tensor in place; `load_optax_state` writes the optimizer's own tensors,
which `graphs.addresses` sees unchanged, where `load_state_dict` replaces
them.
"""

import copy

import numpy as np
import pytest
import torch
from test_torch_multistep import (
    LR,
    _cfg,
    make_chunk,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    port_state,
    variables,
)
from test_torch_recipe import SCHEDULE, hold_recipe_to_jax

from yolo_from_scratch_tpu_torch.train import graphs
from yolo_from_scratch_tpu_torch.train.ema import ema_init
from yolo_from_scratch_tpu_torch.train.schedule import make_step_lr
from yolo_from_scratch_tpu_torch.train.steps import (
    ChunkDraws,
    DrawSpec,
    load_optax_state,
    make_train_step,
    make_train_step_multi_compact,
    optax_state_dict,
)


def test_multi_compact_recipe_matches_jax_anchor():
    hold_recipe_to_jax("anchor")


def test_chunk_step_row_is_the_steps():
    spec = DrawSpec(seed=1, mosaic=False, augment=False, jitter=True,
                    steps=True)
    draws = ChunkDraws(spec, 4, 2, "cpu")
    draws.load(11)
    assert [int(draws.step(i)["step"][0]) for i in range(4)] == [11, 12, 13,
                                                                  14]
    assert draws.step(0)["step"][0].dtype == torch.int32


def test_snapshot_restores_ema_and_learning_rate():
    """A graph's warm-up moves the EMA and, with step_lr, the learning
    rate tensor: Snapshot puts both back into the same tensors."""
    cfg = _cfg()
    state = port_state(cfg, variables(cfg, seed=11))
    for group in state.optimizer.param_groups:
        group["lr"] = torch.tensor(LR)
    ema = ema_init(state.model)
    lr = state.optimizer.param_groups[0]["lr"]
    before = [t.clone() for t in ema.state_dict().values()]
    snap = graphs.Snapshot(state.model, state.optimizer, ema)
    chunk = [torch.from_numpy(a) for a in make_chunk(n=1, seed=4)]
    (state, ema), _ = make_train_step_multi_compact(
        cfg, step_lr=make_step_lr(**SCHEDULE), ema_decay=0.5)(
        (state, ema), *chunk)
    assert lr.item() != np.float32(LR)
    snap.restore()
    assert state.optimizer.param_groups[0]["lr"] is lr
    assert lr.item() == np.float32(LR)
    for t, b in zip(ema.state_dict().values(), before):
        torch.testing.assert_close(t, b, rtol=0, atol=0)


def test_load_optax_state_writes_in_place():
    """Reading the optax layout back into an optimizer that has state
    keeps its tensors (a captured graph's addresses), and the values come
    back; torch's load_state_dict would replace them, and
    `graphs.addresses` tells the two apart."""
    cfg = _cfg("anchor_free")
    chunk = [torch.from_numpy(a) for a in make_chunk(n=1, seed=3)]
    state = port_state(cfg, variables(cfg, seed=12), weight_decay=0.05)
    state, _ = make_train_step(cfg, compact_targets=True)(
        state, chunk[0][0], (chunk[1][0], chunk[2][0]))
    saved = optax_state_dict(state)
    written = copy.deepcopy(state.optimizer.state_dict())
    addresses = graphs.addresses(state.model, state.optimizer)
    for slot in state.optimizer.state.values():
        for v in slot.values():
            v.zero_()
    load_optax_state(state, saved)
    assert graphs.addresses(state.model, state.optimizer) == addresses
    for p, s in zip(state.model.parameters(),
                    written["state"].values()):
        for k, v in s.items():
            torch.testing.assert_close(state.optimizer.state[p][k], v,
                                       rtol=0, atol=0)
    state.optimizer.load_state_dict(written)
    assert graphs.addresses(state.model, state.optimizer) != addresses
    # an Adam checkpoint does not load into AdamW
    adam = port_state(cfg, variables(cfg, seed=12))
    with pytest.raises(ValueError, match="adamw"):
        load_optax_state(adam, saved)
