"""Anchor-free head of the PyTorch port (`models/anchor_free.py` and its
paths through the model, loss, metric, steps, serving, checkpoints and CLI)
against the JAX package, on the CPU: 'n' width, nc=3, images of 64-128,
seeded numpy inputs through both packages, JAX weights carried over by
`from_flax_variables`.

Tolerances, and why:
- bit-equal: the host assignment, the anchor points, `_gather_gt` (a
  stable sort against `lax.top_k`, more than MAX_GT GTs and clashes in
  one cell), `_kth_threshold` in both impls on an align array with ties,
  and the grid metric's counts (integer results of the same comparisons);
- 1e-6: `dfl_expectation` (relative: distances up to 15 stride units,
  where a float32 ulp is ~1e-6) and `decode_anchor_free` (absolute, on
  normalised boxes), elementwise float32, the softmax and the bin dot
  summed in another order;
- 1e-4: the YOLO forward (tests/test_torch_model.py's reason);
- `tal_assign` on tie-free inputs: fg equal, targets within 1e-5, every
  stat within 1e-5 relative (`jnp.percentile` and `torch.quantile` both
  interpolate linearly). With ties the two could break them alike or not;
  that case is `_kth_threshold`'s test;
- the loss: 1e-5 relative; its gradient with respect to the head outputs
  within 1e-4 of each output's largest magnitude, which holds only if TAL
  runs detached (a graph through the assignment moves it by far more);
- the train and eval steps: tests/test_torch_train.py's and
  tests/test_torch_eval.py's tolerances, for their reasons;
- serving: tests/test_torch_predict.py's end-to-end tolerances.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_predict import COUNT_NOTE
from test_torch_train import PRE_BN_BIASES

from yolo_from_scratch_tpu import cli as jax_cli
from yolo_from_scratch_tpu.config import YoloConfig
from yolo_from_scratch_tpu.data.dataset import YoloDataset as JaxDataset
from yolo_from_scratch_tpu.data.loader import DataLoader as JaxLoader
from yolo_from_scratch_tpu.infer.predict import Predictor as JaxPredictor
from yolo_from_scratch_tpu.models import anchor_free as jaf
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu.train.loop import eval_epoch as jax_eval_epoch
from yolo_from_scratch_tpu.train.metrics import (
    grid_metric_counts_anchor_free as jax_counts_af,
)
from yolo_from_scratch_tpu.train.steps import _make_loss_fn
from yolo_from_scratch_tpu.train.steps import make_eval_step as jax_eval_step
from yolo_from_scratch_tpu.utils import checkpoint as jax_ckpt
from yolo_from_scratch_tpu_torch import cli
from yolo_from_scratch_tpu_torch.data import DataLoader, YoloDataset
from yolo_from_scratch_tpu_torch.data.device_queue import DeviceQueue
from yolo_from_scratch_tpu_torch.infer.predict import (
    BatchPredictor,
    PipelinedPredictor,
    Predictor,
    default_topk,
    preds_per_cell,
)
from yolo_from_scratch_tpu_torch.models import anchor_free as taf
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.train.loop import eval_epoch
from yolo_from_scratch_tpu_torch.train.metrics import (
    grid_metric_counts_anchor_free,
)
from yolo_from_scratch_tpu_torch.train.steps import (
    TrainState,
    make_eval_step,
    make_loss_fn,
    make_optimizer,
    make_train_step,
    optax_state_dict,
)
from yolo_from_scratch_tpu_torch.utils import checkpoint as port_ckpt
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
    to_flax_variables,
)

CPU = torch.device("cpu")
NC = 3
IMG = 64
D = 4 * taf.REG_MAX + NC


@pytest.fixture(scope="module")
def cfg_af():
    return YoloConfig(num_classes=NC, img_size=IMG, width_mult=0.25,
                      depth_mult=0.33, head_type="anchor_free")


@pytest.fixture(scope="module")
def variables(cfg_af):
    return random_variables(YOLO(cfg_af, device="meta"), seed=7)


def _port_model(cfg, variables):
    model = YOLO(cfg)
    model.load_state_dict(from_flax_variables(variables, model))
    return model


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _random_boxes(rng, n, lo=0.02, hi=0.6):
    wh = rng.uniform(lo, hi, (n, 2))
    xy = rng.uniform(-0.05, 1.05, (n, 2))  # a few centres off the image
    return np.concatenate([xy, wh], 1).astype(np.float32)


def _dense_targets(rng, b, n_gt, img=IMG):
    """(B, gs, gs, 5+nc) transport maps of `n_gt` random boxes an image."""
    per = [jaf.assign_targets_anchor_free(
        _random_boxes(rng, n_gt, 0.1, 0.7), rng.integers(0, NC, n_gt), img,
        NC) for _ in range(b)]
    return [np.stack([p[s] for p in per]) for s in range(3)]


def _raw_preds(rng, b, img=IMG, scale=1.0):
    return [(rng.normal(0, scale, (b, img // s, img // s, D))
             ).astype(np.float32) for s in (8, 16, 32)]


# --- host assignment, anchor points, GT gathering, the threshold ---------

def test_assign_targets_anchor_free_bit_equal():
    """Random boxes of every scale, centres off the image (clamped) and
    duplicates in one cell (the first GT wins)."""
    rng = np.random.default_rng(0)
    for img in (64, 128):
        boxes = _random_boxes(rng, 40)
        boxes[20:25] = boxes[3]  # a clash: five GTs in one cell
        classes = rng.integers(0, NC, 40)
        got = taf.assign_targets_anchor_free(boxes, classes, img, NC)
        want = jaf.assign_targets_anchor_free(boxes, classes, img, NC)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert sum(int(g[..., 4].sum()) for g in got) < 40
    assert taf.AF_SCALE_THRESHOLDS == jaf.AF_SCALE_THRESHOLDS
    for name in ("REG_MAX", "MAX_GT", "TAL_TOPK", "TAL_ALPHA", "TAL_BETA"):
        assert getattr(taf, name) == getattr(jaf, name), name


def test_anchor_points_bit_equal():
    for img in (64, 128, 640):
        for g, w in zip(taf._anchor_points(img), jaf._anchor_points(img)):
            np.testing.assert_array_equal(g, w)


def test_gather_gt_bit_equal_past_max_gt_and_on_clashes():
    """40 GTs an image (more than MAX_GT = 32), clashes in one cell: the
    stable sort keeps the same 32 rows in the same order as `lax.top_k`."""
    rng = np.random.default_rng(1)
    per = []
    for _ in range(2):
        boxes = _random_boxes(rng, 60, 0.01, 0.3)
        boxes[40:44] = boxes[0]
        per.append(jaf.assign_targets_anchor_free(
            boxes, rng.integers(0, NC, 60), 128, NC))
    targets = [np.stack([p[s] for p in per]) for s in range(3)]
    assert min(int(sum(t[i, ..., 4].sum() for t in targets))
               for i in range(2)) > taf.MAX_GT
    got = taf._gather_gt(_t(targets), NC)
    want = jaf._gather_gt([jnp.asarray(t) for t in targets], NC)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].sum() == 2 * taf.MAX_GT


@pytest.mark.parametrize("impl", ["iter", "sort"])
def test_kth_threshold_bit_equal_with_ties(impl):
    """Values from a set of five, so ties fall inside the top k: 'iter'
    returns the k-th largest DISTINCT value and 'sort' the k-th value; each
    port impl equals its JAX impl, and the two impls differ here."""
    rng = np.random.default_rng(2)
    align = rng.choice(np.float32([0.0, 0.1, 0.25, 0.5, 0.75]), (2, 4, 50))
    got = taf._kth_threshold(torch.from_numpy(align), taf.TAL_TOPK, impl)
    want = jaf._kth_threshold(jnp.asarray(align), taf.TAL_TOPK, impl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    other = taf._kth_threshold(torch.from_numpy(align), taf.TAL_TOPK,
                               {"iter": "sort", "sort": "iter"}[impl])
    assert not torch.equal(got, other)


# --- decode, forward -------------------------------------------------------

def test_dfl_expectation_and_decode_match_jax():
    rng = np.random.default_rng(3)
    dist = rng.normal(0, 2, (2, 5, 4, taf.REG_MAX)).astype(np.float32)
    np.testing.assert_allclose(
        taf.dfl_expectation(torch.from_numpy(dist)).numpy(),
        np.asarray(jaf.dfl_expectation(jnp.asarray(dist))), rtol=1e-6,
        atol=0)
    for raw, stride in zip(_raw_preds(rng, 2, 128, 2.0), (8, 16, 32)):
        got = taf.decode_anchor_free(torch.from_numpy(raw), stride, 128)
        want = jaf.decode_anchor_free(jnp.asarray(raw), stride, 128)
        assert tuple(got.shape) == raw.shape[:3] + (4 + NC,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_af_forward_matches_jax(cfg_af, variables):
    x = np.random.default_rng(4).random((2, IMG, IMG, 3)).astype(np.float32)
    want = jax.jit(lambda v, im: JaxYOLO(cfg_af).apply(v, im, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port_model(cfg_af, variables).eval()(torch.from_numpy(x))
    for g, w, gs in zip(got, want, cfg_af.grid_sizes):
        assert g.dtype == torch.float32
        assert tuple(g.shape) == (2, gs, gs, D) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_af_init_and_random_variables(cfg_af):
    """reset_parameters sets each scale's class bias to the v8 prior, as
    the JAX head's `_cls_prior_bias`; random_variables leaves box_pred and
    cls_pred biases uniform (its anchor-head prior shift skips them)."""
    model = YOLO(cfg_af).reset_parameters(torch.Generator().manual_seed(0))
    for head, stride in zip(("head_p3", "head_p4", "head_p5"), (8, 16, 32)):
        prior = jaf.v8_cls_prior(NC, IMG, stride)
        assert taf.v8_cls_prior(NC, IMG, stride) == prior
        want = np.asarray(jaf._cls_prior_bias(None, (NC,), prior=prior))
        np.testing.assert_array_equal(
            model.get_submodule(head).cls_pred.bias.detach().numpy(), want)
    tree = random_variables(YOLO(cfg_af, device="meta"), seed=0)["params"]
    for head in ("head_p3", "head_p4", "head_p5"):
        for pred in ("box_pred", "cls_pred"):
            bias = tree[head][pred]["bias"]
            fan_in = tree[head][pred]["kernel"].shape[2]
            assert np.abs(bias).max() <= 1 / np.sqrt(fan_in)
    assert "pred" not in tree["head_p3"]


# --- TAL, the loss ---------------------------------------------------------

def _tal_inputs(seed, b=2, m=8, n_valid=5, img=128):
    """Tie-free continuous inputs: scores, boxes around the cell centres,
    GT boxes large enough to hold several centres; rows >= n_valid are
    padding."""
    rng = np.random.default_rng(seed)
    pts, _ = taf._anchor_points(img)
    a = len(pts)
    scores = rng.uniform(0.01, 0.99, (b, a, NC)).astype(np.float32)
    half = rng.uniform(0.02, 0.2, (b, a, 2))
    ctr = pts[None] + rng.normal(0, 0.02, (b, a, 2))
    pred = np.concatenate([ctr - half, ctr + half], -1).astype(np.float32)
    gt = np.concatenate([rng.uniform(0.2, 0.8, (b, m, 2)),
                         rng.uniform(0.15, 0.5, (b, m, 2))], -1)
    valid = (np.arange(m)[None] < n_valid).astype(np.float32).repeat(b, 0)
    cls = np.eye(NC, dtype=np.float32)[rng.integers(0, NC, (b, m))]
    cls *= valid[..., None]
    return (scores, pred, pts, (gt * valid[..., None]).astype(np.float32),
            cls, valid)


def test_tal_assign_matches_jax():
    for seed in (5, 6):
        inputs = _tal_inputs(seed)
        got = taf.tal_assign(*_t(inputs), with_stats=True)
        want = jaf.tal_assign(*(jnp.asarray(a) for a in inputs),
                              with_stats=True)
        np.testing.assert_array_equal(got["fg"].numpy(),
                                      np.asarray(want["fg"]))
        assert got["fg"].sum() > 10
        for key in ("target_boxes", "target_scores"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), rtol=0,
                                       atol=1e-5, err_msg=key)
        assert sorted(got["stats"]) == sorted(want["stats"])
        for key, val in got["stats"].items():
            np.testing.assert_allclose(val.item(), float(want["stats"][key]),
                                       rtol=1e-5, atol=1e-12, err_msg=key)


def _loss_case(seed, b=2):
    rng = np.random.default_rng(seed)
    return _raw_preds(rng, b, 128), _dense_targets(rng, b, 4, 128)


def test_dfl_loss_matches_jax():
    rng = np.random.default_rng(8)
    dist = rng.normal(0, 2, (3, 7, 4, taf.REG_MAX)).astype(np.float32)
    # inside the bins, at integers, negative and past REG_MAX - 1 (clipped)
    ltrb = rng.uniform(-2, 18, (3, 7, 4)).astype(np.float32)
    ltrb[0, :4, 0] = [0.0, 3.0, 15.0, 14.9995]
    got = taf._dfl_loss(torch.from_numpy(dist), torch.from_numpy(ltrb))
    want = jaf._dfl_loss(jnp.asarray(dist), jnp.asarray(ltrb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_loss_entry_points_match_jax():
    for seed in (9, 10):
        preds, targets = _loss_case(seed)
        got = taf.yolo_loss_anchor_free(_t(preds), _t(targets), NC, 128)
        want = jaf.yolo_loss_anchor_free([jnp.asarray(p) for p in preds],
                                         [jnp.asarray(t) for t in targets],
                                         NC, 128)
        np.testing.assert_allclose([g.item() for g in got],
                                   [float(w) for w in want], rtol=1e-5)
        assert got[1].item() > 0  # foreground cells exist
        gt = taf._gather_gt(_t(targets), NC)
        from_gt = taf.yolo_loss_anchor_free_from_gt(_t(preds), *gt, NC, 128,
                                                    topk=5, alpha=1.0,
                                                    beta=4.0)
        want_gt = jaf.yolo_loss_anchor_free_from_gt(
            [jnp.asarray(p) for p in preds],
            *(jnp.asarray(g.numpy()) for g in gt), NC, 128, topk=5,
            alpha=1.0, beta=4.0)
        np.testing.assert_allclose([g.item() for g in from_gt],
                                   [float(w) for w in want_gt], rtol=1e-5)


def test_loss_gradient_matches_jax_with_tal_detached():
    """The gradient of the loss with respect to the head outputs against
    JAX's, whose TAL runs under stop_gradient; pins the port's detach."""
    preds, targets = _loss_case(11)
    leaves = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    taf.yolo_loss_anchor_free(leaves, _t(targets), NC, 128)[0].backward()
    want = jax.jit(jax.grad(lambda p: jaf.yolo_loss_anchor_free(
        p, [jnp.asarray(t) for t in targets], NC, 128)[0]))(
        [jnp.asarray(p) for p in preds])
    for leaf, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_af_stats_fn_matches_assignment_stats(cfg_af, variables):
    """make_af_stats_fn (uint8 images, compact labels) equals
    af_assignment_stats on the same model's outputs and GT set."""
    rng = np.random.default_rng(12)
    model = _port_model(cfg_af, variables).eval()
    images = torch.from_numpy(rng.integers(0, 256, (2, IMG, IMG, 3),
                                           dtype=np.uint8))
    labels = np.zeros((2, 6, 5), np.float32)
    labels[..., 0] = rng.integers(0, NC, (2, 6))
    labels[..., 1:5] = _random_boxes(rng, 12, 0.2, 0.6).reshape(2, 6, 4)
    counts = torch.tensor([4, 6])
    got = taf.make_af_stats_fn(model, cfg_af)(images, torch.from_numpy(labels),
                                              counts)
    valid = (torch.arange(6)[None] < counts[:, None]).float()
    gt_cls = torch.nn.functional.one_hot(
        torch.from_numpy(labels[..., 0]).long(), NC).float() * valid[..., None]
    with torch.no_grad():
        preds = model(images.float() * (1 / 255.0), train=False)
        want = taf.af_assignment_stats(
            preds, torch.from_numpy(labels[..., 1:5]), gt_cls, valid, NC, IMG)
    assert {"fg_p3_per_img", "dfl_clip_frac", "cls_bg_p99"} <= set(got)
    for key, val in want.items():
        torch.testing.assert_close(got[key], val, rtol=1e-5, atol=1e-6)


# --- metric, data, steps ---------------------------------------------------

@pytest.mark.parametrize("per_image", [False, True])
def test_grid_metric_counts_anchor_free_bit_equal(per_image):
    """Class logits near +-1 (about half the cells predicted), target boxes
    the decoded prediction jittered by a few percent in half the cells and
    random in the rest."""
    rng = np.random.default_rng(13 + per_image)
    for raw, stride in zip(_raw_preds(rng, 2, 128), (8, 16, 32)):
        decoded = taf.decode_anchor_free(torch.from_numpy(raw), stride,
                                         128)[..., :4].numpy()
        target = np.zeros(raw.shape[:3] + (5 + NC,), np.float32)
        target[..., 4] = rng.random(raw.shape[:3]) < 0.4
        near = decoded * rng.uniform(0.97, 1.03, decoded.shape)
        far = rng.uniform(0.05, 0.9, decoded.shape)
        target[..., :4] = np.where(rng.random(decoded.shape[:3] + (1,)) < 0.5,
                                   near, far)
        got = grid_metric_counts_anchor_free(
            torch.from_numpy(raw), torch.from_numpy(target), stride, 128,
            per_image=per_image)
        want = jax_counts_af(jnp.asarray(raw), jnp.asarray(target), stride,
                             128, per_image=per_image)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(got[0].sum()) > 0 and int(got[1].sum()) > 0


def test_dataset_loader_and_queue_carry_af_targets(cfg_af,
                                                   temp_dataset_multiclass):
    """The port's dataset routes to the anchor-free assignment, bit-equal
    to the JAX dataset's; the loader and DeviceQueue stack (B, gs, gs,
    5+nc) maps as they stack the anchor head's (B, gs, gs, 3, 5+nc)."""
    img_dir = str(temp_dataset_multiclass / "train" / "images")
    port = YoloDataset(img_dir, NC, img_size=IMG, backend="pil",
                       head_type="anchor_free")
    jds = JaxDataset(img_dir, NC, img_size=IMG, backend="pil",
                     head_type="anchor_free")
    got, want = port.load_batch([0, 1, 2]), jds.load_batch([0, 1, 2])
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    batches = list(DeviceQueue(DataLoader(port, batch_size=3), CPU))
    assert [v for _, _, v in batches] == [3, 1]
    for (_, targets, _), b in zip(batches, (3, 1)):
        assert [tuple(t.shape) for t in targets] == [
            (b, gs, gs, 5 + NC) for gs in cfg_af.grid_sizes]
    anchor = YoloDataset(img_dir, NC, img_size=IMG)
    assert anchor.load_batch([0])[1][0].shape == (1, 8, 8, 3, 5 + NC)


@pytest.fixture(scope="module")
def af_batch(cfg_af, temp_dataset_multiclass):
    ds = JaxDataset(str(temp_dataset_multiclass / "train" / "images"), NC,
                    img_size=IMG, backend="pil", head_type="anchor_free")
    images, targets = next(iter(JaxLoader(ds, batch_size=2, prefetch=0)))
    assert sum(t[..., 4].sum() for t in targets) > 0
    return images, targets


@pytest.mark.parametrize("flag", ["0", "1"])
def test_one_train_step_matches_jax(cfg_af, variables, af_batch, monkeypatch,
                                    flag):
    """Loss, components, gradients and running statistics of one step
    (test_torch_train.py's tolerances); with YOLO_FUSED_CONV_BWD=1 the
    four 64-channel 3x3 convs of head_p4 and the two of the P5 bottleneck
    take the fused backward's plain version. The port's train step then
    reports the same loss, obj = 0, and one Adam step."""
    monkeypatch.setenv("YOLO_FUSED_CONV_BWD", flag)
    images, targets = af_batch
    loss_fn = _make_loss_fn(JaxYOLO(cfg_af), cfg_af, False)
    (total, (new_bs, *parts)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"], variables["batch_stats"],
                                jnp.asarray(images),
                                [jnp.asarray(t) for t in targets])
    meta = YOLO(cfg_af, device="meta")
    want_grads = from_flax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, grads),
         "batch_stats": variables["batch_stats"]}, meta)
    want_stats = from_flax_variables(
        {"params": variables["params"],
         "batch_stats": jax.tree_util.tree_map(np.asarray, new_bs)}, meta)

    model = _port_model(cfg_af, variables)
    got_total, got_parts = make_loss_fn(cfg_af)(model, *_t([images]),
                                                _t(targets))
    got_total.backward()
    np.testing.assert_allclose(got_total.item(), float(total), rtol=1e-4)
    np.testing.assert_allclose([p.item() for p in got_parts],
                               [float(p) for p in parts], rtol=1e-3)
    assert got_parts[1].item() == 0.0  # obj, folded into the classes
    for name, p in model.named_parameters():
        want = want_grads[name].numpy()
        atol = 2e-4 if name in PRE_BN_BIASES else 2e-2 * np.abs(want).max()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=atol,
                                   err_msg=name)
    for name, buf in model.named_buffers():
        want = want_stats[name].numpy()
        np.testing.assert_allclose(buf.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)

    model = _port_model(cfg_af, variables)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-3))
    state, metrics = make_train_step(cfg_af)(state, *_t([images]),
                                             _t(targets))
    np.testing.assert_allclose(metrics["loss"].item(), float(total),
                               rtol=1e-4)
    assert metrics["obj"].item() == 0.0 and state.step == 1
    assert int(optax_state_dict(state)["inner_state"]["1"]["0"]["count"]) == 1


def test_eval_epoch_matches_jax(cfg_af, variables, temp_dataset_multiclass):
    ds = JaxDataset(str(temp_dataset_multiclass / "val" / "images"), NC,
                    img_size=IMG, backend="pil", head_type="anchor_free")
    loader = JaxLoader(ds, batch_size=len(ds), prefetch=0)
    want = jax_eval_epoch(jax_eval_step(JaxYOLO(cfg_af), cfg_af),
                          variables["params"], variables["batch_stats"],
                          loader)
    got = eval_epoch(make_eval_step(cfg_af), _port_model(cfg_af, variables),
                     loader, CPU)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1:] == want[1:]
    assert got[1] < 100.0  # cells were predicted: some counted as FP


# --- serving, checkpoints, the CLI ----------------------------------------

def _same_detections(got, want):
    assert len(got) == len(want), COUNT_NOTE
    if not got:
        return
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-2)
    np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(g[:, 5], w[:, 5])


def test_serving_and_checkpoints_across_packages(cfg_af, variables,
                                                 temp_dataset_multiclass,
                                                 tmp_path):
    """A checkpoint the port writes serves in JAX's Predictor, one that
    JAX writes serves in the port's Predictor, BatchPredictor and
    PipelinedPredictor, and the detections agree; the device-letterbox
    path serves it too."""
    assert preds_per_cell(cfg_af) == 1
    assert default_topk(640, 1) == 4096 and default_topk(IMG, 1) == 84
    images = [str(p) for p in sorted(
        (temp_dataset_multiclass / "val" / "images").glob("*.jpg"))[:2]]

    port_path, jax_path = tmp_path / "port.ckpt", tmp_path / "jax.ckpt"
    state = from_flax_variables(variables, YOLO(cfg_af, device="meta"))
    port_ckpt.save_checkpoint(port_path, to_flax_variables(state), cfg_af)
    jax_vars, jax_cfg, _ = jax_ckpt.load_checkpoint(port_path)
    assert jax_cfg == cfg_af and jax_cfg.head_type == "anchor_free"
    jax_ckpt.save_checkpoint(jax_path, variables, cfg_af, epoch=3)
    port_state, port_cfg, meta = port_ckpt.load_checkpoint(jax_path)
    assert port_cfg.head_type == "anchor_free" and meta["epoch"] == 3
    for key, t in state.items():
        torch.testing.assert_close(port_state[key], t, rtol=0, atol=0)

    # IoU 0.9: the seeded weights' boxes are large and overlap, and at 0.4
    # NMS keeps one or two an image
    jax_pred = JaxPredictor(jax_vars, jax_cfg, iou_threshold=0.9)
    want = [jax_pred(p) for p in images]
    single = Predictor(port_state, port_cfg, iou_threshold=0.9, device=CPU)
    batch = BatchPredictor(port_state, port_cfg, iou_threshold=0.9,
                           max_outputs=84, device=CPU)
    got_batch = batch(images)
    got_single = [single(p) for p in images]
    for w, s, b in zip(want, got_single, got_batch):
        assert len(w) > 3
        _same_detections(s, w)
        _same_detections(b, w)
    pipelined = PipelinedPredictor(port_state, port_cfg, depth=2,
                                   iou_threshold=0.9, device=CPU)
    assert pipelined(images + images[:1]) == got_single + got_single[:1]
    lb = Predictor(port_state, port_cfg, iou_threshold=0.9, device=CPU,
                   device_letterbox=True)(images[0])
    assert lb and np.isfinite(np.asarray(lb)).all()


DET_LINE = re.compile(r"  \d+\. Box: \((-?\d+\.\d), (-?\d+\.\d), (-?\d+\.\d), "
                      r"(-?\d+\.\d)\), Confidence: (\d\.\d{3}), Class: (\d+)")
EPOCH_LINE = re.compile(
    r"Epoch 1: Loss: \d+\.\d{4} \(bbox: \d+\.\d{4}, obj: 0\.0000, "
    r"cls: \d+\.\d{4}\) \| Val: Loss \d+\.\d{4}, P \d+\.\d%, R \d+\.\d%, "
    r"F1 \d+\.\d% \| Det: P \d+\.\d%, R \d+\.\d%, F1 \d+\.\d% \| "
    r"LR: \d\.\d{6} \| \d+\.\d img/s")


def test_cli_anchor_free_modes_match_the_jax_format(cfg_af, variables,
                                                    temp_dataset_multiclass,
                                                    tmp_path, monkeypatch,
                                                    capsys):
    """--head anchor_free: train (--val-det) writes a checkpoint with
    head_type anchor_free; eval with --map prints the JAX CLI's lines.
    Infer and inspect run on a checkpoint of the seeded weights (whose
    class scores sit near 0.5, so the default gate passes detections):
    inspect's whole output equals the JAX CLI's on the same file, infer's
    detection lines parse and agree with JAX's within the printed
    precision."""
    monkeypatch.chdir(tmp_path)
    yaml_file = str(temp_dataset_multiclass / "dataset.yaml")
    assert cli.main([yaml_file, "--head", "anchor_free", "--epochs", "1",
                     "--batch-size", "2", "--size", "n", "--img-size",
                     str(IMG), "--device", "cpu", "--val-det"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[2] == f"Number of classes: {NC}"
    assert EPOCH_LINE.fullmatch(out[12]), out[12]
    ckpt = re.fullmatch(r"Training complete\. Model saved to (\S+)",
                        out[14]).group(1)
    assert port_ckpt.read_payload(ckpt)["head_type"] == "anchor_free"

    assert cli.main([yaml_file, ckpt, "--device", "cpu", "--batch-size", "2",
                     "--map"]) == 0
    out = capsys.readouterr().out.splitlines()
    for title in ("Training", "Validation"):
        i = out.index(f"{title} Set:")
        assert re.fullmatch(r"  Loss: \d+\.\d{4}", out[i + 1])
        for k, name in enumerate(("Precision", "Recall", "F1 Score")):
            assert re.fullmatch(rf"  {name}: \d+\.\d\d%", out[i + 2 + k])
        assert re.fullmatch(r"  mAP@0\.5: \d+\.\d\d%", out[i + 5])
        assert re.fullmatch(r"  mAP@\[\.5:\.95\]: \d+\.\d\d%", out[i + 6])
        assert out[i + 7].startswith("  Detection P/R/F1 @conf0.5: ")
        assert out[i + 8] == "  Per-class AP@0.5:"

    image = str(sorted((temp_dataset_multiclass / "val" / "images")
                       .glob("*.jpg"))[0])
    ckpt = str(tmp_path / "seeded.ckpt")
    jax_ckpt.save_checkpoint(ckpt, variables, cfg_af)
    # the JAX CLI prints its "Creating YOLOv5S ..." line (the --size
    # default, not the checkpoint's) in every mode; the port only where it
    # builds a model from --size, so that line is left out
    outs = []
    for argv in ([image, ckpt, "--device", "cpu"], [image, ckpt], [ckpt],
                 [ckpt]):
        main = cli.main if "--device" in argv or len(outs) == 2 else \
            jax_cli.main
        main(argv)
        out = capsys.readouterr().out.splitlines()
        outs.append(out if main is cli.main else out[1:])
    port_out, jax_out = outs[:2]
    assert port_out[:3] == jax_out[:3]
    assert re.fullmatch(r"Detected \d+ object\(s\):", port_out[3])
    dets = [[DET_LINE.fullmatch(line) for line in o[4:]] for o in outs[:2]]
    assert len(dets[0]) == len(dets[1]) > 0 and all(dets[0]), port_out
    for g, w in zip(*dets):
        np.testing.assert_allclose([float(v) for v in g.groups()],
                                   [float(v) for v in w.groups()], rtol=0,
                                   atol=0.1 + 1e-9)
    assert outs[2] == outs[3]
    assert "Head type: anchor_free" in outs[2]
    assert "  head_p3.cls_pred.bias: [3], 3 parameters" in outs[2]
