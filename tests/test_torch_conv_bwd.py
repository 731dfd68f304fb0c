"""Fused 3x3 conv backward of the PyTorch port (`ops/conv_bwd.py`) against
the JAX package's Pallas kernel, on the CPU.

The JAX side runs its kernel in the Pallas interpreter
(`YOLO_FUSED_CONV_BWD=interpret`); the port's CPU path is the plain
version, which is what the CUDA kernel is held against on the card.
Tolerances are those of `tests/test_conv_bwd.py`: float32 products summed
in another order (576-deep for dx, B*H*W-deep for dW), so dx to 2e-5 and dW
to 2e-5 relative / 2e-4 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolo_from_scratch_tpu.ops import conv_bwd as jax_conv_bwd
from yolo_from_scratch_tpu_torch.models.blocks import Bottleneck
from yolo_from_scratch_tpu_torch.ops import conv_bwd


def _nchw(a):
    """NHWC numpy -> an NCHW tensor that is channels-last in memory, as the
    port's activations are."""
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _case(seed, b=2, h=16, w=16, c=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)  # HWIO
    dy = rng.standard_normal((b, h, w, c)).astype(np.float32)
    return x, k, dy


def test_plain_matches_jax_interpret(monkeypatch):
    monkeypatch.setenv("YOLO_FUSED_CONV_BWD", "interpret")
    x, k, dy = _case(0)
    dx_j, dw_j = jax_conv_bwd.fused_bwd(jnp.asarray(x), jnp.asarray(dy),
                                        jnp.asarray(k))
    dx, dw = conv_bwd.fused_bwd_plain(
        _nchw(x), _nchw(dy), torch.from_numpy(k.transpose(3, 2, 0, 1)))
    assert dx.dtype == torch.float32 and dw.dtype == torch.float32
    assert dx.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(),
                               np.asarray(dx_j), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dw.permute(2, 3, 1, 0).numpy(),
                               np.asarray(dw_j), rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 7, 5)])
def test_plain_matches_autograd_and_forward_is_stock(shape):
    x, k, dy = _case(1, *shape)
    xt = _nchw(x).requires_grad_(True)
    wt = torch.from_numpy(k.transpose(3, 2, 0, 1)).contiguous()
    wt.requires_grad_(True)
    y_ref = F.conv2d(xt, wt, padding=1)
    dx_ref, dw_ref = torch.autograd.grad(y_ref, (xt, wt), _nchw(dy))

    y = conv_bwd.conv3x3_same(xt, wt)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)  # same op, same bits
    dx, dw = torch.autograd.grad(y, (xt, wt), _nchw(dy))
    np.testing.assert_allclose(dx.numpy(), dx_ref.numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(dw.numpy(), dw_ref.numpy(), rtol=2e-5,
                               atol=2e-4)


def test_bfloat16_backward_dtypes():
    """bf16 in, bf16 dx and dW out (dW summed in float32, then rounded
    once), as the JAX `_bwd` casts them."""
    x, k, dy = _case(2, 1, 8, 8)
    xb, dyb = _nchw(x).bfloat16(), _nchw(dy).bfloat16()
    wb = torch.from_numpy(k.transpose(3, 2, 0, 1)).bfloat16()
    xb.requires_grad_(True)
    wb.requires_grad_(True)
    dx, dw = torch.autograd.grad(conv_bwd.conv3x3_same(xb, wb), (xb, wb), dyb)
    assert dx.dtype == dw.dtype == torch.bfloat16
    dx_p, dw_p = conv_bwd.fused_bwd_plain(xb.detach(), dyb, wb.detach())
    torch.testing.assert_close(dx, dx_p, rtol=0, atol=0)
    torch.testing.assert_close(dw, dw_p.bfloat16(), rtol=0, atol=0)


def test_gate_shapes(monkeypatch):
    monkeypatch.setenv("YOLO_FUSED_CONV_BWD", "1")
    gate = conv_bwd.use_fused_bwd
    assert gate(3, 1, 64, 64, 80, 80)
    assert gate(3, 1, 64, 64, 40, 40)
    assert not gate(1, 1, 64, 64, 40, 40)      # 1x1
    assert not gate(3, 2, 64, 64, 40, 40)      # strided
    assert not gate(3, 1, 64, 128, 40, 40)     # cin != cout
    assert not gate(3, 1, 128, 128, 40, 40)    # not the 64-channel case
    assert not gate(3, 1, 64, 64, 160, 160)    # H*W bound
    # float32 halves the bound, as the JAX gate does
    assert gate(3, 1, 64, 64, 40, 80, torch.float32)
    assert not gate(3, 1, 64, 64, 80, 80, torch.float32)
    monkeypatch.setenv("YOLO_FUSED_CONV_BWD", "0")
    assert not gate(3, 1, 64, 64, 80, 80)      # opt-out
    monkeypatch.delenv("YOLO_FUSED_CONV_BWD")
    assert not gate(3, 1, 64, 64, 80, 80)      # default off


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On the CPU the wrapper runs the plain version and counts no
    launch; a tensor on another device is refused, not routed."""
    x, k, dy = _case(3, 1, 4, 4)
    before = conv_bwd.launches
    args = (_nchw(x), _nchw(dy), torch.from_numpy(k.transpose(3, 2, 0, 1)))
    for got, want in zip(conv_bwd.fused_bwd(*args),
                         conv_bwd.fused_bwd_plain(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert conv_bwd.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        conv_bwd.fused_bwd(*(a.to("meta") for a in args))


def test_bottleneck_grads_same_with_flag_on_and_off(monkeypatch):
    """A Bottleneck (two 3x3 64-channel ConvBNSiLU, train mode) gives the
    same parameter gradients through the fused backward as through
    autograd of the stock conv; tolerance that of the JAX test
    (`tests/test_conv_bwd.py`)."""
    block = Bottleneck(64)
    gen = torch.Generator().manual_seed(0)
    for conv in (block.conv1, block.conv2):
        conv.reset_parameters(gen)
    x = _nchw(np.random.default_rng(4).standard_normal(
        (1, 8, 8, 64)).astype(np.float32))

    calls = []
    plain = conv_bwd.fused_bwd_plain
    monkeypatch.setattr(conv_bwd, "fused_bwd_plain",
                        lambda *a: calls.append(1) or plain(*a))

    def grads(flag):
        monkeypatch.setenv("YOLO_FUSED_CONV_BWD", flag)
        block.zero_grad(set_to_none=True)
        (block(x, train=True) ** 2).sum().backward()
        return {n: p.grad.clone() for n, p in block.named_parameters()}

    fused = grads("1")
    assert len(calls) == 2  # both convs took the fused backward
    stock = grads("0")
    assert len(calls) == 2
    assert sorted(fused) == sorted(stock)
    for name in fused:
        np.testing.assert_allclose(fused[name].numpy(), stock[name].numpy(),
                                   rtol=5e-5, atol=5e-4, err_msg=name)
