"""`make_train_step_accum` and the pool trainer's `af_hp` against the JAX
package's, on the CPU at tests/test_torch_multistep.py's size (64x64,
width 0.25, nc=3, batch 2, float32), mosaic and augmentation off, at that
file's `hold_to_jax` bounds (for the accumulating step, those of one
update: it takes one);

and the accumulating step against the port's own single step, bit for
bit: with one micro-batch and the dense device augmentation (its draws
keyed by step * n_accum + micro), it is `make_train_step`.
"""

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_multistep import (
    _cfg,
    assert_same_state,
    hold_to_jax,
    jax_state,
    make_chunk,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    port_state,
    variables,
)
from test_torch_recipe import AF_HP

from yolo_from_scratch_tpu.config import INV255
from yolo_from_scratch_tpu.data.dataset import assign_targets
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu.train.steps import (
    make_train_step_accum as jax_accum,
)
from yolo_from_scratch_tpu.train.steps import (
    make_train_step_multi_pool as jax_multi_pool,
)
from yolo_from_scratch_tpu_torch.train.steps import (
    make_train_step,
    make_train_step_accum,
    make_train_step_multi_pool,
)


def test_multi_pool_af_hp_matches_jax():
    """The anchor-free pool trainer with `af_hp`, batches that repeat no
    image (tests/test_torch_stream.py)."""
    from test_torch_stream import _pool_inputs

    cfg = _cfg("anchor_free")
    var = variables(cfg)
    pool, idx = _pool_inputs(seed=2, repeats=False)
    tx, st0 = jax_state(var)
    jax_out = jax_multi_pool(JaxYOLO(cfg), tx, cfg, donate=False,
                             af_hp=AF_HP)(
        st0, *(jnp.asarray(a) for a in pool), jnp.asarray(idx))
    state = port_state(cfg, var)
    start = {n: t.clone() for n, t in state.model.state_dict().items()}
    state, metrics = make_train_step_multi_pool(cfg, af_hp=AF_HP)(
        state, *(torch.from_numpy(a) for a in pool), torch.from_numpy(idx))
    hold_to_jax(state, start, jax_out, metrics)


def _dense(labels, counts, cfg):
    """Dense anchor targets of a chunk of compact labels: three arrays
    (n, B, g, g, A, 5 + nc)."""
    per = [[assign_targets(labels[s, i, :c, 1:5],
                           labels[s, i, :c, 0].astype(np.int64),
                           cfg.anchors_array, cfg.img_size, cfg.num_classes)
            for i, c in enumerate(counts[s])] for s in range(len(counts))]
    return [np.stack([np.stack([p[g] for p in step]) for step in per])
            for g in range(3)]


def test_accum_matches_jax():
    """One update from two micro-batches: the mean gradient, the running
    statistics carried from the first micro-batch to the second."""
    cfg = _cfg()
    var = variables(cfg)
    images, labels, counts = make_chunk(n=2, seed=6)
    # the JAX accumulating step takes float images (it normalizes none)
    images = images.astype(np.float32) * INV255
    targets = _dense(labels, counts, cfg)
    tx, st0 = jax_state(var)
    jst, jm = jax_accum(JaxYOLO(cfg), tx, cfg, 2, donate=False)(
        st0, jnp.asarray(images), *(jnp.asarray(t) for t in targets))
    state = port_state(cfg, var)
    start = {n: t.clone() for n, t in state.model.state_dict().items()}
    state, metrics = make_train_step_accum(cfg, 2)(
        state, torch.from_numpy(images),
        *(torch.from_numpy(t) for t in targets))
    hold_to_jax(state, start, (jst, jm), metrics, n=1)


def test_accum_of_one_equals_train_step():
    """n_accum=1, the dense device augmentation on (its draws keyed by
    step * 1 + 0): the single step, bit for bit."""
    cfg = _cfg()
    var = variables(cfg, seed=9)
    images, labels, counts = make_chunk(n=2, seed=7)
    targets = [torch.from_numpy(t) for t in _dense(labels, counts, cfg)]
    images = torch.from_numpy(images)
    accum = make_train_step_accum(cfg, 1, device_augment=True,
                                  augment_seed=4)
    single = make_train_step(cfg, device_augment=True, augment_seed=4)
    a, b = port_state(cfg, var), port_state(cfg, var)
    for i in range(2):
        a, ma = accum(a, images[i:i + 1], *(t[i:i + 1] for t in targets))
        b, mb = single(b, images[i], [t[i] for t in targets])
        for k in ma:
            torch.testing.assert_close(ma[k], mb[k], rtol=0, atol=0)
    assert_same_state(a, b)
