"""The PyTorch port's scanned trainers (`train/steps.py`:
`make_train_step_multi`, `make_train_step_multi_compact`, and the chunk
draws they replay) against the JAX package's, and against the port's own
single step, on the CPU at 64x64, width 0.25, nc=3, batch 2, float32, N=3
steps a chunk. On the CPU the trainers run their N steps eagerly: the
plain version of the CUDA graph they replay on the card.

Tolerances, and why:
- port against JAX, mosaic and augmentation off (their draws come from
  different generators): tests/test_torch_compact_step.py's tolerances for
  one step, scaled to N steps as tests/test_stream.py scales its own: the
  mean loss within N x 1e-4 relative; at lr 1e-5 every parameter's change
  within N x 2 x lr of JAX's and 90% of each tensor's within N x 0.05 x lr
  (except the conv biases in front of a BatchNorm, whose gradient is
  rounding noise); running statistics N x 1e-3 relative and N x 1e-4 of
  each tensor's max;
- port against itself, mosaic and augmentation on: bit-equal to N calls
  of `make_train_step` (the chunk's draws are the per-step draws, and the
  arithmetic is the same ops in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import PRE_BN_BIASES

from yolo_from_scratch_tpu.config import YoloConfig
from yolo_from_scratch_tpu.data.assign_device import pack_labels
from yolo_from_scratch_tpu.data.dataset import assign_targets
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu.train.steps import TrainState as JaxState
from yolo_from_scratch_tpu.train.steps import make_optimizer as jax_optimizer
from yolo_from_scratch_tpu.train.steps import (
    make_train_step_multi as jax_multi,
)
from yolo_from_scratch_tpu.train.steps import (
    make_train_step_multi_compact as jax_multi_compact,
)
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.train import steps as tsteps
from yolo_from_scratch_tpu_torch.train.steps import (
    ChunkDraws,
    DrawSpec,
    TrainState,
    make_optimizer,
    make_train_step,
    make_train_step_multi,
    make_train_step_multi_compact,
)
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)

NC, IMG, B, K, N = 3, 64, 2, 8, 3
LR = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors: with test workers
    sharing the cores, torch's default of one thread a core oversubscribes
    them (7-25x slower measured on 8 cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(head="anchor"):
    return YoloConfig(num_classes=NC, img_size=IMG, width_mult=0.25,
                      depth_mult=0.33, head_type=head)


def make_chunk(n=N, seed=0):
    """uint8 images (n, B, S, S, 3), compact labels (n, B, K, 5) and counts
    (n, B) from a seed: 1-6 boxes an image, one duplicate slot."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, B, IMG, IMG, 3), dtype=np.uint8)
    labels, counts = [], []
    for _ in range(n):
        boxes, classes = [], []
        for m in rng.integers(1, 7, B):
            b = np.concatenate([rng.uniform(0.2, 0.8, (m, 2)),
                                rng.uniform(0.05, 0.5, (m, 2))], 1)
            boxes.append(b.astype(np.float32))
            classes.append(rng.integers(0, NC, m))
        boxes[0] = np.concatenate([boxes[0], boxes[0][:1]])
        classes[0] = np.concatenate([classes[0], classes[0][:1]])
        lab, cnt = pack_labels(boxes, classes, K)
        labels.append(lab)
        counts.append(cnt)
    return images, np.stack(labels), np.stack(counts)


def variables(cfg, seed=3):
    return random_variables(YOLO(cfg, device="meta"), seed=seed)


def port_state(cfg, variables, weight_decay=0.0):
    model = YOLO(cfg)
    model.load_state_dict(from_flax_variables(variables, model))
    return TrainState(model, make_optimizer(model.parameters(), LR,
                                            weight_decay))


def jax_state(variables, weight_decay=0.0):
    tx = jax_optimizer(LR, weight_decay)
    return tx, JaxState(params=variables["params"],
                        batch_stats=variables["batch_stats"],
                        opt_state=tx.init(variables["params"]),
                        step=jnp.zeros((), jnp.int32))


def hold_to_jax(state, start, jax_out, metrics, n=N):
    """The port's state and mean metrics after n steps against JAX's, at
    the tolerances of the module docstring."""
    jax_st, jax_metrics = jax_out
    assert state.step == n and int(jax_st.step) == n
    np.testing.assert_allclose(metrics["loss"].item(),
                               float(jax_metrics["loss"]), rtol=n * 1e-4)
    model = state.model
    want = from_flax_variables(jax.tree_util.tree_map(np.asarray, {
        "params": jax_st.params, "batch_stats": jax_st.batch_stats}), model)
    for name, t in model.state_dict().items():
        if name.endswith((".bn.mean", ".bn.var")):
            np.testing.assert_allclose(
                t.numpy(), want[name].numpy(), rtol=n * 1e-3,
                atol=n * 1e-4 * want[name].abs().max().item(), err_msg=name)
            continue
        diff = np.abs((t - start[name]).numpy()
                      - (want[name] - start[name]).numpy())
        assert diff.max() <= n * 2 * LR, (name, diff.max() / LR)
        if name not in PRE_BN_BIASES:
            assert np.quantile(diff, 0.9) <= n * 0.05 * LR, (
                name, np.quantile(diff, 0.9) / LR)


def assert_same_state(a, b):
    """Two port states bit-equal: weights, BatchNorm statistics, Adam's
    moments and counts, and the step."""
    assert a.step == b.step
    for (name, x), y in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert sorted(sa) == sorted(sb)
        for key in sa:
            torch.testing.assert_close(sa[key], sb[key], rtol=0, atol=0)


def per_step_mean(metrics_list):
    return {k: torch.stack([m[k] for m in metrics_list]).mean()
            for k in metrics_list[0]}


@pytest.mark.parametrize("head,sparse", [("anchor", False), ("anchor", True),
                                         ("anchor_free", False)])
def test_multi_compact_matches_jax(head, sparse):
    cfg = _cfg(head)
    var = variables(cfg)
    images, labels, counts = make_chunk()
    tx, st0 = jax_state(var)
    jax_out = jax_multi_compact(JaxYOLO(cfg), tx, cfg, donate=False,
                                sparse_loss=sparse)(
        st0, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(counts))
    state = port_state(cfg, var)
    start = {n: t.clone() for n, t in state.model.state_dict().items()}
    state, metrics = make_train_step_multi_compact(cfg, sparse_loss=sparse)(
        state, *(torch.from_numpy(a) for a in (images, labels, counts)))
    assert sorted(metrics) == sorted(tsteps.METRIC_KEYS)
    hold_to_jax(state, start, jax_out, metrics)


def test_multi_dense_matches_jax():
    """Dense host targets and uint8 staging (normalized in the step)."""
    cfg = _cfg()
    var = variables(cfg)
    images, labels, counts = make_chunk(seed=1)
    per = [[assign_targets(labels[s, i, :c, 1:5],
                           labels[s, i, :c, 0].astype(np.int64),
                           cfg.anchors_array, IMG, NC)
            for i, c in enumerate(counts[s])] for s in range(N)]
    targets = [np.stack([np.stack([p[g] for p in step]) for step in per])
               for g in range(3)]
    tx, st0 = jax_state(var)
    jax_out = jax_multi(JaxYOLO(cfg), tx, cfg, donate=False)(
        st0, jnp.asarray(images), *(jnp.asarray(t) for t in targets))
    state = port_state(cfg, var)
    start = {n: t.clone() for n, t in state.model.state_dict().items()}
    state, metrics = make_train_step_multi(cfg)(
        state, torch.from_numpy(images),
        *(torch.from_numpy(t) for t in targets))
    hold_to_jax(state, start, jax_out, metrics)


@pytest.mark.parametrize("head,flags", [
    ("anchor", dict(sparse_loss=True, device_mosaic=True,
                    device_augment=True)),
    ("anchor", dict(device_mosaic=True, device_augment=True)),
    ("anchor_free", dict(device_mosaic=True, device_augment="flip")),
])
def test_multi_compact_equals_single_steps(head, flags):
    """Mosaic and augmentation on, AdamW for the anchor-free recipe: the
    chunk of N equals N single steps bit for bit, metrics included."""
    cfg = _cfg(head)
    var = variables(cfg, seed=4)
    wd = 0.05 if head == "anchor_free" else 0.0
    chunk = [torch.from_numpy(a) for a in make_chunk(seed=2)]
    multi, got = make_train_step_multi_compact(cfg, augment_seed=7, **flags)(
        port_state(cfg, var, wd), *chunk)
    single = make_train_step(cfg, augment_seed=7, compact_targets=True,
                             **flags)
    state, per = port_state(cfg, var, wd), []
    for i in range(N):
        state, m = single(state, chunk[0][i], (chunk[1][i], chunk[2][i]))
        per.append(m)
    assert_same_state(multi, state)
    for k, v in per_step_mean(per).items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_multi_dense_equals_single_steps():
    """The dense trainer with the dense-level flip / jitter hook."""
    cfg = _cfg()
    var = variables(cfg, seed=5)
    images, labels, counts = make_chunk(seed=3)
    per = [[assign_targets(labels[s, i, :c, 1:5],
                           labels[s, i, :c, 0].astype(np.int64),
                           cfg.anchors_array, IMG, NC)
            for i, c in enumerate(counts[s])] for s in range(N)]
    targets = [torch.from_numpy(np.stack([np.stack([p[g] for p in step])
                                          for step in per]))
               for g in range(3)]
    images = torch.from_numpy(images)
    multi, got = make_train_step_multi(cfg, device_augment=True,
                                       augment_seed=2)(
        port_state(cfg, var), images, *targets)
    single = make_train_step(cfg, device_augment=True, augment_seed=2)
    state, per_m = port_state(cfg, var), []
    for i in range(N):
        state, m = single(state, images[i], [t[i] for t in targets])
        per_m.append(m)
    assert_same_state(multi, state)
    for k, v in per_step_mean(per_m).items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_chunk_draws_are_the_step_draws():
    """ChunkDraws' rows are `DrawSpec.draw` of each step, and a chunk
    starting at step s draws steps s .. s + N - 1."""
    spec = DrawSpec(seed=11, mosaic=True, augment=True, jitter=True)
    draws = ChunkDraws(spec, 4, B, "cpu")
    draws.load(5)
    for i in range(4):
        want = spec.draw(5 + i, B)
        got = draws.step(i)
        assert sorted(got) == ["augment", "mosaic"]
        for key in want:
            for g, w in zip(got[key], want[key]):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
    flip_only = ChunkDraws(spec._replace(jitter=False, mosaic=False), 2, B,
                           "cpu")
    flip_only.load(0)
    assert flip_only.step(1)["augment"][1:] == (None, None)


def test_recipe_knobs_raise():
    cfg = _cfg()
    for kw in ({"af_hp": {"topk": 5}}, {"step_lr": lambda s: 1e-3},
               {"ema_decay": 0.999}):
        with pytest.raises(NotImplementedError):
            make_train_step_multi_compact(cfg, **kw)
    with pytest.raises(NotImplementedError):
        tsteps.make_train_step_multi_pool(cfg, af_hp={"topk": 5})


def test_optax_state_dict_reads_capturable_tensors():
    """A capturable optimizer keeps its step and learning rate in tensors:
    `optax_state_dict` and `set_learning_rate` take them (CPU tensors
    stand in for the card's)."""
    cfg = _cfg()
    state = port_state(cfg, variables(cfg, seed=6))
    for group in state.optimizer.param_groups:
        group["lr"] = torch.tensor(LR)
    lr_tensor = state.optimizer.param_groups[0]["lr"]
    for p in state.model.parameters():
        state.optimizer.state[p] = {"step": torch.tensor(4.0),
                                    "exp_avg": torch.zeros_like(p),
                                    "exp_avg_sq": torch.zeros_like(p)}
    state.step = 4
    tsteps.set_learning_rate(state, 2e-3)
    assert state.optimizer.param_groups[0]["lr"] is lr_tensor
    written = tsteps.optax_state_dict(state)
    assert written["inner_state"]["1"]["0"]["count"] == np.int32(4)
    assert written["count"] == np.int32(4)
    np.testing.assert_array_equal(written["hyperparams"]["learning_rate"],
                                  np.float32(2e-3))
    assert written["hyperparams"]["learning_rate"].dtype == np.float32


def test_snapshot_restores_the_same_tensors():
    """graphs.Snapshot, which keeps a graph's warm-up from training: the
    parameters, buffers and Adam's state come back in place, and Adam's
    state created since is zeroed (its fresh state)."""
    from yolo_from_scratch_tpu_torch.train import graphs

    cfg = _cfg()
    state = port_state(cfg, variables(cfg, seed=8))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    addresses = [t.data_ptr() for t in state.model.state_dict().values()]
    snap = graphs.Snapshot(state.model, state.optimizer)
    chunk = [torch.from_numpy(a) for a in make_chunk(n=1, seed=4)]
    make_train_step(cfg, compact_targets=True)(
        state, chunk[0][0], (chunk[1][0], chunk[2][0]))
    snap.restore()
    for (name, t), address in zip(state.model.state_dict().items(),
                                  addresses):
        assert t.data_ptr() == address, name
        torch.testing.assert_close(t, before[name], rtol=0, atol=0, msg=name)
    for p in state.model.parameters():
        adam = state.optimizer.state[p]
        assert adam and all(not v.any() for v in adam.values())


def test_capture_needs_a_capturable_optimizer():
    from yolo_from_scratch_tpu_torch.train import graphs

    cfg = _cfg()
    state = port_state(cfg, variables(cfg))
    with pytest.raises(RuntimeError, match="capturable"):
        graphs.capture(lambda: None, lambda: None, state.model,
                       state.optimizer)


def test_capture_failure_names_the_line():
    from yolo_from_scratch_tpu_torch.ops import augment
    from yolo_from_scratch_tpu_torch.train import graphs

    with pytest.raises(TypeError) as info:
        augment.augment_compact_batch(None, None, None, None)
    where = graphs._failed_at(info.value)
    assert where.startswith("yolo_from_scratch_tpu_torch/ops/augment.py:")
