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
from yolo_from_scratch_tpu_torch.models.fused_bn import BNSiLU, bn_silu_train
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
    """Eval mode keeps flax's op order. (Train mode, refused before the
    training port, now runs: see the train-mode tests below.)"""
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
    with torch.no_grad():
        train = bn(torch.from_numpy(x), train=True).numpy()
    assert np.abs(train - got).max() > 1e-2  # batch, not running, stats


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (2, 4, 4, 64)])
def test_bn_silu_train_matches_jax(shape):
    """y, the batch statistics and the gradients of x, scale and bias
    against the JAX custom_vjp, float32. Tolerance 1e-5: zero-mean inputs,
    so the fast variance loses no digits; the two packages sum in another
    order."""
    from yolo_from_scratch_tpu.models.fused_bn import bn_silu_train as jax_bn

    rng = np.random.default_rng(shape[-1])
    x = rng.normal(0, 1, shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    bias = rng.normal(0, 0.1, shape[-1]).astype(np.float32)
    dy = rng.normal(0, 1, shape).astype(np.float32)

    (y_j, mu_j, var_j), vjp = jax.vjp(
        lambda a, s, b: jax_bn(1, 1e-5, a, s, b), jnp.asarray(x),
        jnp.asarray(scale), jnp.asarray(bias))
    dx_j, ds_j, db_j = vjp((jnp.asarray(dy), jnp.zeros_like(mu_j),
                            jnp.zeros_like(var_j)))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    y, mu, var = bn_silu_train(xt, st, bt)
    y.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    nhwc = lambda t: t.detach().permute(0, 2, 3, 1).numpy()  # noqa: E731
    for got, want in ((nhwc(y), y_j), (mu.numpy(), mu_j),
                      (var.numpy(), var_j), (nhwc(xt.grad), dx_j),
                      (st.grad.numpy(), ds_j), (bt.grad.numpy(), db_j)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_bn_running_stats_update_with_biased_variance():
    """One train-mode call moves the running statistics with momentum 0.9
    towards the batch mean and the BIASED batch variance, as flax does;
    nn.BatchNorm2d's unbiased update lands elsewhere."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(1, 2, (2, 4, 3, 3)).astype(np.float32))
    bn = BNSiLU(4)
    with torch.no_grad():
        bn.mean.fill_(0.5)
        bn.var.fill_(2.0)
        bn(x, train=True)
    mu = x.mean(dim=(0, 2, 3))
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.mean, 0.9 * 0.5 + 0.1 * mu)
    torch.testing.assert_close(bn.var, 0.9 * 2.0 + 0.1 * biased)

    stock = torch.nn.BatchNorm2d(4, momentum=0.1)
    with torch.no_grad():
        stock.running_mean.fill_(0.5)
        stock.running_var.fill_(2.0)
        stock.train()(x)
    torch.testing.assert_close(stock.running_mean, bn.mean)
    assert (stock.running_var - bn.var).abs().min() > 1e-3


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


@pytest.mark.parametrize("kw", [{"packed_stem": True, "packed_interior": True,
                                 "packed_p3": True},
                                {"packed_stem": True}])
def test_unported_variants_raise(cfg, kw):
    with pytest.raises(NotImplementedError):
        YOLO(cfg.with_(**kw), device="meta")


def test_bfloat16_forward_is_finite(cfg):
    """Parameters stay float32 master weights under a bfloat16 compute
    dtype; the convolutions run in bfloat16 (cast at use), and Predictor
    casts the conv weights once at load instead."""
    bf = cfg.with_(compute_dtype="bfloat16")
    model = YOLO(bf)
    state = from_flax_variables(random_variables(YOLO(bf, device="meta"),
                                                 seed=0), model)
    model.load_state_dict(state)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    seen = []
    model.stem0.bn.register_forward_hook(
        lambda mod, args, out: seen.append((args[0].dtype, out.dtype)))
    x = torch.rand((1, bf.img_size, bf.img_size, 3),
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        outs = model.eval()(x)
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    assert all(o.dtype == torch.float32 and torch.isfinite(o).all()
               for o in outs)

    from yolo_from_scratch_tpu_torch.infer.predict import Predictor

    served = Predictor(state, bf, device=torch.device("cpu")).model
    assert served.stem0.conv.weight.dtype == torch.bfloat16
    assert served.head_p3.pred.bias.dtype == torch.bfloat16
    assert served.stem0.bn.scale.dtype == torch.float32
    with torch.no_grad():
        for got, want in zip(served(x), outs):
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_reset_parameters_draws_the_jax_init(cfg):
    """`reset_parameters` follows the JAX package's initialisers: conv
    kernels and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), BatchNorm
    1/0/0/1, and the heads' pred bias exactly as `_head_bias_init` sets it.
    The draws come from the generator alone."""
    from yolo_from_scratch_tpu.models.yolo import _head_bias_init

    head_bias = torch.tensor(np.asarray(_head_bias_init(3, 1)(None, (18,))))
    model = YOLO(cfg).reset_parameters(torch.Generator().manual_seed(0))
    state = model.state_dict()
    for key, t in state.items():
        leaf = key.rsplit(".", 1)[1]
        if key.endswith("pred.bias"):
            torch.testing.assert_close(t, head_bias, rtol=0, atol=0)
        elif ".bn." in key:
            fill = 1.0 if leaf in ("scale", "var") else 0.0
            torch.testing.assert_close(t, torch.full_like(t, fill))
        else:
            mod = model.get_submodule(key.rsplit(".", 1)[0])
            bound = 1.0 / np.sqrt(mod.in_channels * mod.kernel_size[0]
                                  * mod.kernel_size[1])
            assert t.abs().max() <= bound, key
            if t.numel() >= 64:  # a uniform fills its range
                assert t.abs().max() > 0.8 * bound, key
    again = YOLO(cfg).reset_parameters(torch.Generator().manual_seed(0))
    other = YOLO(cfg).reset_parameters(torch.Generator().manual_seed(1))
    w = "stem0.conv.weight"
    torch.testing.assert_close(again.state_dict()[w], state[w], rtol=0,
                               atol=0)
    assert not torch.equal(other.state_dict()[w], state[w])
