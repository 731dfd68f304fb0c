"""Training under the packed layouts: the port against the JAX package, on
the CPU.

- One step of the packed p3 model at width 0.5 (so that the packed C3a
  bottleneck 3x3s are 64 -> 64 convs, which K2's gate selects: with
  `YOLO_FUSED_CONV_BWD=1` their backward is the fused backward's plain
  version here), both heads, at 128 px, batch 2, float32: loss, gradients
  and moved BatchNorm statistics against JAX's packed model with
  `tests/test_torch_train.py`'s tolerances, and the Adam update against
  optax's on JAX's gradients (every parameter within 2 lr, as there, and
  90% of each tensor's elements within 0.05 lr but for the conv biases in
  front of a BatchNorm, whose gradient is rounding noise).
- K2's gate: the convs it selects in a packed 's' @640 bfloat16 forward,
  by shape on the meta device, against the convs the JAX package's gate is
  asked about in an `eval_shape` of its packed model (10 / 12 under
  interior and p3, 8 / 10 unpacked and under stem, anchor / anchor-free).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import yolo_from_scratch_tpu.ops.conv_bwd as jax_conv_bwd
from yolo_from_scratch_tpu.data.dataset import assign_targets
from yolo_from_scratch_tpu.models import anchor_free as jaf
from yolo_from_scratch_tpu.models.packed import pack_s2d_host
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu.train.steps import _make_loss_fn
from yolo_from_scratch_tpu.train.steps import make_optimizer as jax_optimizer
from yolo_from_scratch_tpu_torch.config import YoloConfig
from yolo_from_scratch_tpu_torch.models.blocks import ConvBNSiLU
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops.conv_bwd import fused_bwd_fits
from yolo_from_scratch_tpu_torch.train.steps import (
    TrainState,
    make_loss_fn,
    make_optimizer,
    make_train_step,
)
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)

IMG, NC, LR = 128, 3, 1e-3
P3 = dict(packed_stem=True, packed_interior=True, packed_p3=True)
LAYOUTS = {"none": {}, "stem": dict(packed_stem=True),
           "interior": dict(packed_stem=True, packed_interior=True),
           "p3": P3}
PRE_BN_BIASES = ("stem0.conv.bias", "stem1.conv.bias", "bb_p3_down.conv.bias",
                 "bb_p4_down.conv.bias", "bb_p5_down.conv.bias",
                 "sppf.conv1.conv.bias", "sppf.conv2.conv.bias")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Six test workers share the cores: torch's default threads would
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_cfg(cfg):
    from yolo_from_scratch_tpu.config import YoloConfig as JaxConfig

    return JaxConfig(**{f: getattr(cfg, f) for f in (
        "num_classes", "img_size", "width_mult", "depth_mult", "head_type",
        "packed_stem", "packed_interior", "packed_p3", "compute_dtype")})


def _batch(head, rng):
    """A host-packed image batch and dense targets of random boxes."""
    images = rng.random((2, IMG, IMG, 3)).astype(np.float32)
    per = []
    for _ in range(2):
        n = 3
        boxes = np.concatenate([rng.uniform(0.2, 0.8, (n, 2)),
                                rng.uniform(0.1, 0.5, (n, 2))], 1).astype(
            np.float32)
        cls = rng.integers(0, NC, n)
        per.append(jaf.assign_targets_anchor_free(boxes, cls, IMG, NC)
                   if head == "anchor_free" else
                   assign_targets(boxes, cls, YoloConfig().anchors_array, IMG,
                                  NC))
    targets = [np.stack([p[s] for p in per]).astype(np.float32)
               for s in range(3)]
    return pack_s2d_host(images), targets


@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
def test_packed_step_matches_jax(head, monkeypatch):
    monkeypatch.setenv("YOLO_FUSED_CONV_BWD", "1")
    cfg = YoloConfig.from_size("s", num_classes=NC, img_size=IMG,
                               head_type=head, **P3)
    meta = YOLO(cfg, device="meta")
    gated = [m for m in meta.modules() if isinstance(m, ConvBNSiLU)
             and getattr(m, "_index", None) is not None
             and m.gate_shape(torch.empty(1, 64, 16, 16)) is not None
             and m._index.shape[:2] == (64, 64)]
    assert len(gated) == 2  # the packed C3a bottleneck's conv1 and conv2
    variables = random_variables(meta, seed=11)
    images, targets = _batch(head, np.random.default_rng(2))

    jcfg = _jax_cfg(cfg)
    loss_fn = _make_loss_fn(JaxYOLO(jcfg), jcfg, False)
    (total, (new_bs, *parts)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"], variables["batch_stats"],
                                jnp.asarray(images),
                                [jnp.asarray(t) for t in targets])
    tx = jax_optimizer(LR)
    updates, _ = jax.jit(tx.update)(grads, tx.init(variables["params"]),
                                    variables["params"])
    new_params = optax.apply_updates(variables["params"], updates)
    as_port = lambda params, stats: from_flax_variables(  # noqa: E731
        {"params": jax.tree_util.tree_map(np.asarray, params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, stats)}, meta)
    want_grads = as_port(grads, variables["batch_stats"])
    want_after = as_port(new_params, new_bs)

    batch = (torch.from_numpy(images), [torch.from_numpy(t)
                                         for t in targets])
    model = YOLO(cfg)
    model.load_state_dict(from_flax_variables(variables, model))
    got, got_parts = make_loss_fn(cfg)(model, *batch)
    got.backward()  # the raw gradients (the train step clips them)
    np.testing.assert_allclose(got.item(), float(total), rtol=1e-4)
    np.testing.assert_allclose([p.item() for p in got_parts],
                               [float(p) for p in parts], rtol=1e-3,
                               atol=1e-7)
    for name, p in model.named_parameters():
        want = want_grads[name].numpy()
        atol = 2e-4 if name in PRE_BN_BIASES else 2e-2 * np.abs(want).max()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=atol,
                                   err_msg=name)

    model = YOLO(cfg)
    model.load_state_dict(from_flax_variables(variables, model))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model, make_optimizer(model.parameters(), LR))
    state, metrics = make_train_step(cfg)(state, *batch)
    np.testing.assert_allclose(metrics["loss"].item(), float(total),
                               rtol=1e-4)
    for name, p in model.named_parameters():
        step = (p.detach() - before[name]).numpy()
        want_step = (want_after[name] - before[name]).numpy()
        np.testing.assert_allclose(step, want_step, rtol=0, atol=2 * LR,
                                   err_msg=name)
        if name not in PRE_BN_BIASES:  # their gradient is noise
            close = np.abs(step - want_step) <= 0.05 * LR
            assert close.mean() >= 0.9, (name, close.mean())
    for name, buf in model.named_buffers():
        want = want_after[name].numpy()
        np.testing.assert_allclose(buf.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def _port_gated(cfg):
    """{(cin, cout, h, w): convs} that the port's gate takes in one
    forward, on the meta device."""
    model = YOLO(cfg, device="meta")
    seen = collections.Counter()

    def hook(mod, args):
        shape = mod.gate_shape(args[0])
        if shape is not None and fused_bwd_fits(*shape):
            seen[shape[2:6]] += 1

    for m in model.modules():
        if isinstance(m, ConvBNSiLU):
            m.register_forward_pre_hook(hook)
    shape = (1, 160, 160, 48) if cfg.packed_stem else (1, 640, 640, 3)
    with torch.no_grad():
        model(torch.empty(shape, device="meta"))
    return seen


def _jax_gated(cfg, monkeypatch):
    """The same, from the calls the JAX package makes to its gate while
    it traces its model (`eval_shape`: no compile, no compute)."""
    seen = collections.Counter()

    def spy(kernel, stride, cin, cout, h, w, dtype=None):
        if fused_bwd_fits(kernel, stride, cin, cout, h, w, torch.bfloat16):
            seen[(cin, cout, h, w)] += 1
        return False

    monkeypatch.setattr(jax_conv_bwd, "use_fused_bwd", spy)
    jcfg = _jax_cfg(cfg)
    s = 640 // (4 if cfg.packed_stem else 1)
    jax.eval_shape(lambda x: JaxYOLO(jcfg).init(jax.random.PRNGKey(0), x),
                   jax.ShapeDtypeStruct((1, s, s, 48 if cfg.packed_stem
                                         else 3), jnp.float32))
    return seen


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("head,counts", [("anchor", (8, 8, 10, 10)),
                                         ("anchor_free", (10, 10, 12, 12))])
def test_k2_gate_matches_jax(head, counts, layout, monkeypatch):
    cfg = YoloConfig.from_size("s", num_classes=80, img_size=640,
                               compute_dtype="bfloat16", head_type=head,
                               **LAYOUTS[layout])
    port = _port_gated(cfg)
    assert port == _jax_gated(cfg, monkeypatch)
    assert sum(port.values()) == counts[list(LAYOUTS).index(layout)]
    if cfg.packed_interior:  # + the packed C3a convs, 64 -> 64 at 80x80
        unpacked = _port_gated(cfg.with_(packed_stem=False,
                                         packed_interior=False,
                                         packed_p3=False))
        assert port - unpacked == {(64, 64, 80, 80): 2}
