"""The port's bottleneck-chain backward K5,
`yolo_from_scratch_tpu_torch/benchmarks/blockbwd.py`, against the JAX
repository's `benchmarks/blockbwd.py` on the CPU.

The JAX side runs its Pallas kernel in the interpreter; the port's
wrapper, given CPU tensors, runs its plain version, which is what the CUDA
kernel is held against on the card. Tolerances, relative to the
reference's largest magnitude:
- float32: 1e-5 for dx, dw1 and dw2 (float32 sums in another order, and
  the two frameworks' sigmoids);
- bf16: dz2 = bf16(dy * s2) is one rounding of the same product on both
  sides, so dw2 holds to 1e-3 as K2's dW. dz1 is rounded to bf16 from da1,
  a float32 sum taken in another order, so an element can land one bf16
  ulp (2^-8 of it) away; that flip enters dw1 summed over the batch's
  pixels (1e-3 of the max) and dx, which is rounded to bf16 once more
  (2^-7 of the max, as K2's dx).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import blockbwd as jax_blockbwd
from yolo_from_scratch_tpu_torch.benchmarks import blockbwd, bwdproto

CASES = [(2, 8, 8, "float32"), (1, 7, 5, "float32"), (2, 16, 16, "float32"),
         (2, 8, 8, "bfloat16"), (1, 7, 5, "bfloat16")]
TOL = {"float32": (1e-5, 1e-5, 1e-5), "bfloat16": (2.0 ** -7, 1e-3, 1e-3)}


def _inputs(seed, b, h, w, c=64):
    """x, w1, w2 (HWIO), s1, s2 in [0.5, 1.5), dy, as the JAX check."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)
    s1 = (rng.random(c) + 0.5).astype(np.float32)
    s2 = (rng.random(c) + 0.5).astype(np.float32)
    dy = rng.standard_normal((b, h, w, c)).astype(np.float32)
    return x, w1, w2, s1, s2, dy


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("b,h,w,dtype", CASES)
def test_matches_jax_interpret(b, h, w, dtype):
    """The same chain (the JAX forward's z1 and a1, in the compute dtype)
    through the Pallas kernel and the port's wrapper."""
    x, w1, w2, s1, s2, dy = _inputs(0, b, h, w)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jw1, jw2, jdy = (jnp.asarray(a, jdt) for a in (x, w1, w2, dy))
    js1, js2 = jnp.asarray(s1), jnp.asarray(s2)
    z1, a1, _ = jax_blockbwd.chain_fwd(jx, jw1, jw2, js1, js2)
    want = jax_blockbwd.make_chain_bwd(b, h, w, 64, jdt, interpret=True)(
        jx, z1, a1, jdy, jw1, jw2, js1, js2)

    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt)
    got = blockbwd.make_chain_bwd(b, h, w, 64, tdt)(
        t(x), t(z1), t(a1), t(dy), t(w1), t(w2), torch.from_numpy(s1),
        torch.from_numpy(s2))
    assert got[0].dtype == tdt and got[0].shape == (b, h, w, 64)
    for g, wnt, tol in zip(got, want, TOL[dtype]):
        assert g.shape == wnt.shape
        assert _rel(g.float(), np.asarray(wnt, np.float32)) <= tol


def test_chain_fwd_matches_jax():
    x, w1, w2, s1, s2, _ = _inputs(1, 2, 8, 8)
    want = jax_blockbwd.chain_fwd(*(jnp.asarray(a)
                                    for a in (x, w1, w2, s1, s2)))
    got = blockbwd.chain_fwd(*(torch.from_numpy(a)
                               for a in (x, w1, w2, s1, s2)))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 7, 5)])
def test_plain_matches_float64_autograd(shape):
    """The plain version's math pinned without JAX: autograd of
    `chain_fwd` in float64, float32 plain version within 1e-5."""
    x, w1, w2, s1, s2, dy = (torch.from_numpy(a) for a in _inputs(2, *shape))
    leaves = [t.double().requires_grad_(True) for t in (x, w1, w2)]
    y = blockbwd.chain_fwd(*leaves, s1.double(), s2.double())[2]
    refs = torch.autograd.grad(y, leaves, dy.double())
    with torch.no_grad():
        z1, a1, _ = blockbwd.chain_fwd(x, w1, w2, s1, s2)
    got = blockbwd.chain_bwd_plain(x, z1, a1, dy, w1, w2, s1, s2)
    for g, r in zip(got, refs):
        assert g.dtype == torch.float32
        assert _rel(g, r.detach()) <= 1e-5


def test_cpu_tensors_take_the_plain_version():
    x, w1, w2, s1, s2, dy = (torch.from_numpy(a) for a in _inputs(3, 1, 4, 4))
    z1, a1, _ = blockbwd.chain_fwd(x, w1, w2, s1, s2)
    args = (x, z1, a1, dy, w1, w2, s1, s2)
    before = blockbwd.launches
    got = blockbwd.make_chain_bwd(1, 4, 4, 64, torch.float32)(*args)
    for g, want in zip(got, blockbwd.chain_bwd_plain(*args)):
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    assert blockbwd.launches == before


@pytest.mark.parametrize("how", ["channels", "mixed dtypes", "scale shape",
                                 "meta device"])
def test_wrapper_refuses(how):
    x, w1, w2, s1, s2, dy = (torch.from_numpy(a) for a in _inputs(4, 1, 4, 4))
    z1, a1, _ = blockbwd.chain_fwd(x, w1, w2, s1, s2)
    args = [x, z1, a1, dy, w1, w2, s1, s2]
    if how == "channels":
        with pytest.raises(ValueError, match="64 channels"):
            blockbwd.make_chain_bwd(1, 4, 4, 32, torch.float32)
        return
    fused = blockbwd.make_chain_bwd(1, 4, 4, 64, torch.float32)
    if how == "mixed dtypes":
        args[1], err = z1.bfloat16(), TypeError
    elif how == "scale shape":
        args[6], err = s1[:32], ValueError
    else:
        args, err = [a.to("meta") for a in args], ValueError
    with pytest.raises(err):
        fused(*args)


def test_bottleneck_chain_count_of_the_step():
    """The projection's chain count: the 's' @640 model's 64-channel
    bottlenecks, one in each of the three P4-level C3s (backbone, FPN
    merge, PANet merge), all at 40x40."""
    assert blockbwd.bottleneck_chains(bwdproto.step_config()) == {
        (40, 40): 3}
