"""The packed layouts of the PyTorch port (`models/packed.py`) against the
JAX package's, on the CPU.

The layout routines and the kernel rewrites are held bit for bit on numpy
inputs, the gathered kernel of every packed conv to the JAX rewrite of its
canonical weight. The packed forward (stem / interior / p3, both heads,
eval and train mode) is held to JAX's packed model at rtol=atol=1e-4, as
`tests/test_torch_model.py` holds the unpacked one, and to the port's own
unpacked model at JAX's tolerances (`tests/test_packed_p3.py`: eval 2e-5,
train 5e-5, BatchNorm statistics 1e-5). Width 0.25 at 128 px, the
conftest size: at 64 px the P5 maps are 2x2 at batch 2, and train-mode
BatchNorm's fast variance (mean(x^2) - mean(x)^2) then parts the two
packages by up to 1.8e-4 on the UNPACKED model already (the cancellation
`tests/test_torch_train.py` describes); at 128 px the packed and unpacked
models both stay within half the bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu.models import packed as jpk
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu_torch.config import YoloConfig
from yolo_from_scratch_tpu_torch.models import packed as tpk
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)

IMG = 128
LAYOUTS = {"stem": dict(packed_stem=True),
           "interior": dict(packed_stem=True, packed_interior=True),
           "p3": dict(packed_stem=True, packed_interior=True,
                      packed_p3=True)}
# tests/test_packed_interior.py:40's cases: (k, stride, fi, fo, cin, cout)
REPACK_CASES = [(3, 1, 2, 2, 8, 8), (1, 1, 2, 2, 16, 8), (3, 2, 2, 2, 8, 16),
                (3, 2, 2, 1, 16, 24), (3, 2, 4, 2, 3, 8), (1, 1, 4, 4, 6, 10)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Six test workers share the cores: torch's default threads would
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(head, layout=None, nc=3):
    cfg = YoloConfig.from_size("n", num_classes=nc, img_size=IMG,
                               head_type=head)
    return cfg.with_(**LAYOUTS[layout]) if layout else cfg


def _jax_cfg(cfg):
    from yolo_from_scratch_tpu.config import YoloConfig as JaxConfig

    return JaxConfig(**{f: getattr(cfg, f) for f in (
        "num_classes", "img_size", "width_mult", "depth_mult", "head_type",
        "packed_stem", "packed_interior", "packed_p3")})


def _port(cfg, variables):
    model = YOLO(cfg)
    model.load_state_dict(from_flax_variables(variables, model))
    return model


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(7).random((2, IMG, IMG, 3)).astype(
        np.float32)


@pytest.mark.parametrize("f", [2, 4])
def test_layout_routines_bit_equal(f):
    x = np.random.default_rng(f).random((2, 3, 16, 24, 5)).astype(
        np.float32)
    packed = tpk.pack_s2d_host(x, f)
    np.testing.assert_array_equal(packed, jpk.pack_s2d_host(x, f))
    np.testing.assert_array_equal(
        tpk.pack_s2d(torch.from_numpy(x), f).numpy(), packed)
    np.testing.assert_array_equal(
        tpk.unpack_s2d(torch.from_numpy(packed), f).numpy(),
        np.asarray(jpk.unpack_s2d(jnp.asarray(packed), f)))
    np.testing.assert_array_equal(
        tpk.unpack_s2d(torch.from_numpy(packed), f).numpy(), x)
    # the NCHW unpack of the model is the NHWC one, permuted
    nchw = torch.from_numpy(packed[0]).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(
        tpk.unpack_nchw(nchw, f).permute(0, 2, 3, 1).numpy(), x[0])


@pytest.mark.parametrize("fi", [2, 4])
def test_pack_conv_kernel_bit_equal(fi):
    w = np.random.default_rng(fi).normal(size=(3, 3, 5, 7)).astype(
        np.float32)
    np.testing.assert_array_equal(tpk.pack_conv_kernel(w, fi),
                                  np.asarray(jpk.pack_conv_kernel(
                                      jnp.asarray(w), fi)))


@pytest.mark.parametrize("k,stride,fi,fo,cin,cout", REPACK_CASES)
def test_repack_conv_kernel_bit_equal(k, stride, fi, fo, cin, cout):
    w = np.random.default_rng(k * 100 + cin).normal(
        size=(k, k, cin, cout)).astype(np.float32)
    got = tpk.repack_conv_kernel(w, stride, fi, fo)
    want = jpk.repack_conv_kernel(jnp.asarray(w), stride, fi, fo)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1:] == tuple(want[1:])
    # the module's gather of the canonical OIHW weight is that kernel
    conv = tpk.GPackedConvBNSiLU(cin, cout, k, stride, fi, fo)
    with torch.no_grad():
        conv.conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        wp = conv.packed_weight(torch.float32).numpy()
    np.testing.assert_array_equal(wp.transpose(2, 3, 1, 0), got[0])
    assert (conv.s_packed, conv.pad) == got[1:]


def test_repack_conv_kernel_concat_segments_bit_equal():
    w = np.random.default_rng(4).normal(size=(1, 1, 12, 10)).astype(
        np.float32)
    segs = [(2, 8), (2, 4)]
    got = tpk.repack_conv_kernel(w, 1, 2, 2, in_segments=segs)
    want = jpk.repack_conv_kernel(jnp.asarray(w), 1, 2, 2, in_segments=segs)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1:] == tuple(want[1:])


def test_stem_kernel_gather_bit_equal():
    conv = tpk.PackedConvBNSiLU(3, 8, 4)
    w = conv.conv.weight.detach().numpy().transpose(2, 3, 1, 0)
    want = np.asarray(jpk.pack_conv_kernel(jnp.asarray(w), 4))
    np.testing.assert_array_equal(
        conv.packed_weight(torch.float32).detach().numpy().transpose(
            2, 3, 1, 0), want)


def test_packed_kernel_gradient_reaches_canonical_weight():
    """The gather's backward sums each packed tap's gradient into its
    canonical tap: d/dw of sum(packed * g) is the scatter-add of g."""
    conv = tpk.GPackedConvBNSiLU(4, 4, 3, 1, 2, 2)
    g = torch.randn(conv._index.shape, generator=torch.Generator()
                    .manual_seed(0))
    (conv.packed_weight(torch.float32) * g).sum().backward()
    n = conv.conv.weight.numel()
    idx = torch.from_numpy(conv._index).reshape(-1)
    want = torch.zeros(int(idx.max()) + 1).index_add_(0, idx, g.reshape(-1))
    torch.testing.assert_close(conv.conv.weight.grad.reshape(-1), want[:n],
                               rtol=1e-6, atol=1e-6)
    # each zero tap reads a slot of its own; a canonical tap is read by at
    # most 4 packed taps (one an output phase)
    assert sorted(idx[idx >= n].tolist()) == list(range(n, int(idx.max()) + 1))
    assert torch.bincount(idx[idx < n]).max() <= 4


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
def test_packed_forward_matches_jax(image, head, layout):
    """Eval and train mode, the outputs and the moved BatchNorm statistics,
    against the JAX package's packed model on the host-packed image."""
    cfg = _cfg(head, layout)
    variables = random_variables(YOLO(cfg, device="meta"), seed=3)
    packed = jpk.pack_s2d_host(image)
    jmodel = JaxYOLO(_jax_cfg(cfg))
    want_eval, (want_train, moved) = jax.jit(lambda v, x: (
        jmodel.apply(v, x, train=False),
        jmodel.apply(v, x, train=True, mutable=["batch_stats"])))(
        variables, jnp.asarray(packed))
    model = _port(cfg, variables)
    with torch.no_grad():
        got_eval = model(torch.from_numpy(packed), train=False)
        got_train = model(torch.from_numpy(packed), train=True)
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-4)
    stats = from_flax_variables(
        {"params": variables["params"],
         "batch_stats": jax.tree_util.tree_map(np.asarray,
                                               moved["batch_stats"])},
        YOLO(cfg, device="meta"))
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), stats[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
def test_packed_matches_port_unpacked(image, head, layout):
    """The port's packed model against its own unpacked one on the same
    weights, at JAX's own packed-test tolerances; the pixel image is packed
    on the device, the host-packed one gives the same outputs."""
    base = _cfg(head)
    variables = random_variables(YOLO(base, device="meta"), seed=5)
    x = torch.from_numpy(image)
    xp = torch.from_numpy(tpk.pack_s2d_host(image))
    unpacked, packed = _port(base, variables), _port(_cfg(head, layout),
                                                     variables)
    with torch.no_grad():
        for a, b in zip(unpacked(x), packed(xp)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-5)
        for a, b in zip(packed(x), packed(xp)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        for a, b in zip(unpacked(x, train=True), packed(xp, train=True)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-5)
    for (name, a), b in zip(unpacked.named_buffers(), packed.buffers()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5,
                                   err_msg=name)


def test_packed_state_dict_and_seeded_reset_match_unpacked():
    """Same keys and shapes (checkpoints carry both ways), and the seeded
    reset draws the same weights (the modules register in one order)."""
    for head in ("anchor", "anchor_free"):
        base = YOLO(_cfg(head)).reset_parameters(
            torch.Generator().manual_seed(1))
        for layout in LAYOUTS:
            packed = YOLO(_cfg(head, layout)).reset_parameters(
                torch.Generator().manual_seed(1))
            sa, sb = base.state_dict(), packed.state_dict()
            assert list(sa) == list(sb)
            for key in sa:
                torch.testing.assert_close(sb[key], sa[key], rtol=0, atol=0)
