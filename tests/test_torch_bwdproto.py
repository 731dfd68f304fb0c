"""The port's conv-backward prototypes K3 (patch matrix) and K4 (per-tap),
`yolo_from_scratch_tpu_torch/benchmarks/bwdproto.py`, against the JAX
repository's `benchmarks/bwdproto.py` on the CPU.

The JAX side runs its Pallas kernels in the interpreter; the port's
wrappers, given CPU tensors, run their plain versions, which are what the
CUDA kernels are held against on the card. Tolerances, relative to the
reference's largest magnitude:
- float32: 1e-5 for dx and dW (float32 sums taken in another order, 576
  deep for dx, B*H*W deep for dW);
- bf16: 2^-7 for dx, which both sides round to bf16 once from float32
  sums taken in another order (one bf16 ulp is 2^-8 of a value), and 1e-3
  for the float32 dW, as K2's test.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmarks import bwdproto as jax_bwdproto
from yolo_from_scratch_tpu_torch.benchmarks import bwdproto

CASES = [(2, 8, 8, "float32"), (1, 7, 5, "float32"), (2, 16, 16, "float32"),
         (2, 8, 8, "bfloat16"), (1, 7, 5, "bfloat16")]
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 1e-3)}
KERNELS = {
    "K3": (jax_bwdproto.make_fused_bwd, bwdproto.make_fused_bwd,
           bwdproto.fused_bwd_patch_plain),
    "K4": (jax_bwdproto.make_fused_bwd_v2, bwdproto.make_fused_bwd_v2,
           bwdproto.fused_bwd_tap_plain),
}


def _inputs(seed, b, h, w, c=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)
    dy = rng.standard_normal((b, h, w, c)).astype(np.float32)
    return x, dy, wt


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("b,h,w,dtype", CASES)
def test_matches_jax_interpret(kernel, b, h, w, dtype):
    jax_make, make, _ = KERNELS[kernel]
    x, dy, wt = _inputs(0, b, h, w)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    dx_j, dw_j = jax_make(b, h, w, 64, jdt, interpret=True)(
        *(jnp.asarray(a, jdt) for a in (x, dy, wt)))
    dx, dw = make(b, h, w, 64, tdt)(
        *(torch.from_numpy(a).to(tdt) for a in (x, dy, wt)))
    assert dx.dtype == tdt and dx.shape == (b, h, w, 64)
    assert dw.dtype == torch.float32 and dw.shape == (3, 3, 64, 64)
    tol_dx, tol_dw = TOL[dtype]
    assert _rel(dx.float(), np.asarray(dx_j, np.float32)) <= tol_dx
    assert _rel(dw, np.asarray(dw_j)) <= tol_dw


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 7, 5)])
def test_plain_matches_float64_autograd(kernel, dtype, shape):
    """The plain version's math pinned without JAX: autograd of `F.conv2d`
    in float64 on the same (dtype-rounded) inputs. float32: 1e-5 for both
    gradients; bf16: the products are exact in float32, so dW holds to
    1e-5 and dx to its one rounding to bf16 (2^-8 of the max)."""
    plain = KERNELS[kernel][2]
    tdt = getattr(torch, dtype)
    x, dy, wt = (torch.from_numpy(a).to(tdt) for a in _inputs(1, *shape))
    x64, w64 = (t.double().requires_grad_(True) for t in (x, wt))
    y = F.conv2d(x64.permute(0, 3, 1, 2), w64.permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    dx_ref, dw_ref = torch.autograd.grad(y, (x64, w64), dy.double())
    dx, dw = plain(x, dy, wt)
    assert dx.dtype == tdt and dw.dtype == torch.float32
    assert _rel(dx.float(), dx_ref.detach()) <= (1e-5 if dtype == "float32"
                                                 else 2.0 ** -8)
    assert _rel(dw, dw_ref.detach()) <= 1e-5


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper returns the plain version's bits and counts
    no launch."""
    before = dict(bwdproto.launches)
    args = [torch.from_numpy(a) for a in _inputs(2, 1, 4, 4)]
    for kernel, (_, make, plain) in KERNELS.items():
        got = make(1, 4, 4, 64, torch.float32)(*args)
        for g, want in zip(got, plain(*args)):
            torch.testing.assert_close(g, want, rtol=0, atol=0)
    assert bwdproto.launches == before


def _bad_inputs(how):
    x, dy, wt = (torch.from_numpy(a) for a in _inputs(3, 1, 4, 4))
    if how == "mixed dtypes":
        return (x, dy.bfloat16(), wt), TypeError
    if how == "float16":
        return (x.half(), dy.half(), wt), TypeError
    if how == "dy shape":
        return (x, dy[:, :, :3].contiguous(), wt), ValueError
    if how == "weight shape":
        return (x, dy, wt[:, :, :32]), ValueError
    if how == "meta device":
        return (x.to("meta"), dy.to("meta"), wt.to("meta")), ValueError
    raise AssertionError(how)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("how", ["mixed dtypes", "float16", "dy shape",
                                 "weight shape", "meta device"])
def test_wrapper_refuses(kernel, how):
    make = KERNELS[kernel][1]
    args, err = _bad_inputs(how)
    with pytest.raises(err):
        make(1, 4, 4, 64, args[0].dtype)(*args)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_wrapper_refuses_other_channel_counts(kernel):
    make = KERNELS[kernel][1]
    with pytest.raises(ValueError, match="64 channels"):
        make(1, 4, 4, 32, torch.float32)
    x = torch.zeros((1, 4, 4, 32))
    with pytest.raises(ValueError):
        make(1, 4, 4, 64, torch.float32)(x, x, torch.zeros((3, 3, 32, 32)))


def test_gated_conv_count_of_the_step(monkeypatch):
    """The projection's conv count, walked from the port's model with the
    fused gate's rule: 6 at 40x40 and head_p3's 2 at 80x80 in bf16, and
    float32's halved H*W bound drops the 80x80 pair. The count does not
    read the gate's switch, and leaves it as it was."""
    monkeypatch.setenv("YOLO_FUSED_CONV_BWD", "0")
    cfg = bwdproto.step_config()
    assert bwdproto.gated_convs(cfg) == {(40, 40): 6, (80, 80): 2}
    assert bwdproto.gated_convs(cfg.with_(compute_dtype="float32")) == {
        (40, 40): 6}
    assert os.environ["YOLO_FUSED_CONV_BWD"] == "0"
