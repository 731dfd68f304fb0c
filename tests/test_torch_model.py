"""Model of the PyTorch port against the JAX package, on the CPU.

The same seeded numpy weights (JAX layout) go into the flax YOLO and,
through `utils/convert.py`, into the port; the same numpy images go
through both eval-mode forwards. Tolerance rtol=atol=1e-4: both run float32
convolutions on the CPU, but XLA and PyTorch sum each convolution in
another order and may fuse the BN arithmetic into FMAs, so results agree
to a few float32 ulps per layer (measured ~5e-7 on logits of magnitude ~5
at the conftest size), not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu.config import YoloConfig
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu.models.yolo import count_params as jax_count_params
from yolo_from_scratch_tpu_torch.models.blocks import (
    maxpool_same,
    upsample_nearest_2x,
)
from yolo_from_scratch_tpu_torch.models.fused_bn import BNSiLU
from yolo_from_scratch_tpu_torch.models.yolo import YOLO, count_params
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)


def _port(cfg, variables):
    model = YOLO(cfg)
    model.load_state_dict(from_flax_variables(variables, model))
    return model.eval()


@pytest.mark.parametrize("nc", [1, 3])
def test_eval_forward_matches_jax(cfg, nc):
    cfg = cfg.with_(num_classes=nc)
    variables = random_variables(YOLO(cfg, device="meta"), seed=nc)
    x = np.random.default_rng(nc).random(
        (2, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    apply = jax.jit(lambda v, im: JaxYOLO(cfg).apply(v, im, train=False))
    expected = apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port(cfg, variables)(torch.from_numpy(x))
    assert len(got) == 3
    for g, e, gs in zip(got, expected, cfg.grid_sizes):
        assert g.dtype == torch.float32
        assert tuple(g.shape) == (2, gs, gs, 3, 5 + nc) == e.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("size", ["n", "s"])
def test_count_params_matches_jax(size):
    cfg = YoloConfig.from_size(size, num_classes=1, img_size=640)
    # abstract init: shapes only, no forward is computed at 640
    shapes = jax.eval_shape(
        lambda: JaxYOLO(cfg).init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 640, 640, 3)), train=False))
    assert count_params(YOLO(cfg, device="meta")) == jax_count_params(shapes)


def test_convert_consumes_every_leaf_once(cfg):
    model = YOLO(cfg, device="meta")
    variables = random_variables(model, seed=0)
    state = from_flax_variables(variables, model)
    assert sorted(state) == sorted(model.state_dict())
    kernel = variables["params"]["stem0"]["conv"]["kernel"]  # HWIO
    np.testing.assert_array_equal(state["stem0.conv.weight"].numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["sppf.conv2.bn.var"].numpy(),
                                  variables["batch_stats"]["sppf"]["conv2"]
                                  ["bn"]["var"])

    missing = {"params": dict(variables["params"]),
               "batch_stats": variables["batch_stats"]}
    del missing["params"]["sppf"]
    with pytest.raises(ValueError, match="model keys without a JAX leaf"):
        from_flax_variables(missing, model)

    extra = {"params": dict(variables["params"]),
             "batch_stats": variables["batch_stats"]}
    extra["params"]["bogus"] = {"conv": {"kernel": np.zeros((1, 1, 3, 8))}}
    with pytest.raises(ValueError, match="no counterpart"):
        from_flax_variables(extra, model)

    with pytest.raises(ValueError, match="unknown JAX collections"):
        from_flax_variables(dict(variables, cache={}), model)


def test_bn_silu_eval_op_order_and_train_refused():
    rng = np.random.default_rng(0)
    bn = BNSiLU(4)
    vals = {k: rng.uniform(0.5, 1.5, 4).astype(np.float32)
            for k in ("scale", "bias", "mean", "var")}
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in vals.items()})
    x = rng.normal(size=(2, 4, 3, 3)).astype(np.float32)
    mul = (1.0 / np.sqrt(vals["var"] + np.float32(1e-5))) * vals["scale"]
    z = (x - vals["mean"][:, None, None]) * mul[:, None, None] \
        + vals["bias"][:, None, None]
    with torch.no_grad():
        got = bn(torch.from_numpy(x)).numpy()
    # float32 sigmoid and rsqrt differ by ulps between numpy and torch
    np.testing.assert_allclose(got, z / (1 + np.exp(-z)), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(NotImplementedError, match="later PR"):
        bn(torch.from_numpy(x), train=True)


def test_pool_and_upsample_match_jax():
    from yolo_from_scratch_tpu.models.blocks import (
        _maxpool_same,
    )
    from yolo_from_scratch_tpu.models.blocks import (
        upsample_nearest_2x as jax_upsample,
    )

    x = np.random.default_rng(1).normal(size=(2, 7, 5, 3)).astype(np.float32)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    to_nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()  # noqa: E731
    np.testing.assert_array_equal(to_nhwc(maxpool_same(nchw, 5)),
                                  np.asarray(_maxpool_same(jnp.asarray(x), 5)))
    np.testing.assert_array_equal(to_nhwc(upsample_nearest_2x(nchw)),
                                  np.asarray(jax_upsample(jnp.asarray(x))))


@pytest.mark.parametrize("kw", [{"head_type": "anchor_free"},
                                {"packed_stem": True}])
def test_unported_variants_raise(cfg, kw):
    with pytest.raises(NotImplementedError):
        YOLO(cfg.with_(**kw), device="meta")


def test_bfloat16_forward_is_finite(cfg):
    bf = cfg.with_(compute_dtype="bfloat16")
    model = YOLO(bf)
    model.load_state_dict(from_flax_variables(
        random_variables(YOLO(bf, device="meta"), seed=0), model))
    assert model.stem0.conv.weight.dtype == torch.bfloat16
    assert model.stem0.bn.scale.dtype == torch.float32
    x = torch.rand((1, bf.img_size, bf.img_size, 3),
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        outs = model.eval()(x)
    assert all(o.dtype == torch.float32 and torch.isfinite(o).all()
               for o in outs)
