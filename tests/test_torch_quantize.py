"""The port's int8 post-training quantization (`infer/quantize.py`,
`ops/quant.py`) against the JAX package's `infer/quantize.py` on the CPU,
at the tier-1 test config (width 0.25, depth 0.33, 128 px), both heads.

Tolerances, and why:

- `quantize_params`: `w_int8` bit-equal, `w_scale` and `bias` within 1 ulp
  (both fold and round in numpy float32 with the same op order);
- calibration scales: rtol 1e-5 (the port's and XLA's float convs sum in
  another order, ~3e-7 relative measured), abs-max and percentile 99.9;
- the plain int8 conv's int32 accumulator: bit for bit with `_int8_conv`
  (both exact); Q1's int8: bit for bit with `_quant_input` in float32 and
  bf16, half-way ties included (round half to even);
- one conv body against `_quant_conv_silu` in float32, given the same
  input: rtol 1e-6, atol 1e-7 (the int32 sums equal, the dequant the same
  float32 ops; XLA's and torch's SiLU may differ in the last ulp);
- the whole quantized forward against `make_quant_apply` in float32, given
  the JAX calibration's scales: the median output within 1e-6 and all
  within 2e-4. The float stem0 conv differs in the last bits between the
  two packages, so now and then a value lands on the other side of a
  rounding step (one int8 step of one activation, which then spreads
  over its receptive field); such a step moves outputs by up to ~5e-5 at
  this width (measured), and the int8 forward differs from the float one
  by 4e-4 and more, so the bound still tells the two apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from yolo_from_scratch_tpu.config import YoloConfig as JaxConfig
from yolo_from_scratch_tpu.infer import quantize as JQ
from yolo_from_scratch_tpu.models.blocks import ConvBNSiLU as JaxConvBNSiLU
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu_torch import YoloConfig
from yolo_from_scratch_tpu_torch.infer import quantize as Q
from yolo_from_scratch_tpu_torch.infer.predict import (
    BatchPredictor,
    Predictor,
    _load_model,
)
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import quant
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)

CPU = torch.device("cpu")
HEADS = ["anchor", "anchor_free"]


def _cfgs(head):
    kw = dict(num_classes=3, img_size=128, width_mult=0.25, depth_mult=0.33,
              head_type=head)
    return YoloConfig(**kw), JaxConfig(**kw)


@pytest.fixture(scope="module", params=HEADS)
def setup(request):
    """Per head: the port's config, state dict and float serving model, the
    JAX model and variables (the same seeded weights), two calibration
    images and the JAX package's abs-max scales on them."""
    torch.set_num_threads(1)
    cfg, jcfg = _cfgs(request.param)
    variables = random_variables(YOLO(cfg, device="meta"), seed=0)
    state = from_flax_variables(variables, YOLO(cfg, device="meta"))
    imgs = np.random.default_rng(7).random((2, 128, 128, 3), np.float32)
    jmodel = JaxYOLO(jcfg)
    return dict(cfg=cfg, state=state, model=_load_model(state, cfg, CPU),
                jmodel=jmodel, variables=variables, imgs=imgs,
                scales=JQ.calibrate(jmodel, variables, [imgs]))


@pytest.mark.parametrize("percentile", [None, 99.9])
def test_calibrate_matches_jax(setup, percentile):
    got = Q.calibrate(setup["model"], [setup["imgs"]], percentile=percentile)
    want = (setup["scales"] if percentile is None else JQ.calibrate(
        setup["jmodel"], setup["variables"], [setup["imgs"]],
        percentile=percentile))
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[k] for k in want], list(want.values()),
                               rtol=1e-5)


def test_quantize_params_matches_jax(setup):
    got = Q.quantize_params(setup["state"], setup["scales"])
    want = JQ.quantize_params(setup["variables"], setup["scales"])
    assert list(got) == list(want)
    for key, q in want.items():
        np.testing.assert_array_equal(got[key]["w_int8"],
                                      np.asarray(q["w_int8"]), err_msg=key)
        for leaf in ("w_scale", "bias", "a_scale"):
            np.testing.assert_array_max_ulp(
                got[key][leaf], np.asarray(q[leaf], np.float32), maxulp=1)


def test_key_sets_and_skip(setup):
    """The port's keys are the JAX module paths: 59 ConvBNSiLU on the
    anchor head, 65 on the anchor-free head (its four a scale); with
    skip=(stem0, stem1) two fewer; `quantize_model` swaps all but stem0 and
    leaves the heads' pred convs float."""
    scales = setup["scales"]
    assert len(scales) == (59 if setup["cfg"].head_type == "anchor" else 65)
    got = Q.quantize_params(setup["state"], scales, skip=("stem0", "stem1"))
    want = JQ.quantize_params(setup["variables"], scales,
                              skip=("stem0", "stem1"))
    assert set(got) == set(want) and len(got) == len(scales) - 2
    qmodel = Q.quantize_model(setup["model"], [setup["imgs"]],
                              state_dict=setup["state"])
    swapped = [n for n, m in qmodel.named_modules()
               if isinstance(m, Q.QuantConvBNSiLU)]
    assert len(swapped) == len(scales) - 1 and "stem0" not in swapped
    assert isinstance(qmodel.stem0.conv, torch.nn.Conv2d)
    preds = [n for n, m in qmodel.named_modules()
             if isinstance(m, torch.nn.Conv2d) and n.endswith("pred")]
    assert len(preds) == (3 if setup["cfg"].head_type == "anchor" else 6)
    # the float model is left as it was
    assert not any(isinstance(m, Q.QuantConvBNSiLU)
                   for m in setup["model"].modules())


def test_mxu_bound_select_matches_jax(setup):
    got = Q.quantize_params(setup["state"], setup["scales"],
                            select=Q.mxu_bound_select)
    want = JQ.quantize_params(setup["variables"], setup["scales"],
                              select=JQ.mxu_bound_select)
    assert set(got) == set(want) and 0 < len(got) < len(setup["scales"])
    for q in got.values():
        kh, _, cin, _ = q["w_int8"].shape
        assert kh == 3 and cin >= 64


def test_quantized_forward_matches_jax(setup):
    """The whole int8 forward (all convs but stem0) against
    `make_quant_apply`, float32, the same scales."""
    qtree = Q.quantize_params(setup["state"], setup["scales"],
                              skip=("stem0",))
    jtree = JQ.quantize_params(setup["variables"], setup["scales"],
                               skip=("stem0",))
    imgs = setup["imgs"]
    want = JQ.make_quant_apply(setup["jmodel"])(
        (setup["variables"], jtree), jnp.asarray(imgs))
    with torch.inference_mode():
        got = Q.quantized_copy(setup["model"], qtree)(torch.from_numpy(imgs))
        flt = setup["model"](torch.from_numpy(imgs))
    for g, w, f in zip(got, want, flt):
        diff = np.abs(g.numpy() - np.asarray(w))
        assert diff.max() < 2e-4, diff.max()
        assert np.median(diff) < 1e-6, np.median(diff)
        # int8 is not float: the bound above tells them apart
        assert np.abs(f.numpy() - np.asarray(w)).max() > 2e-4


CONV_CASES = [(k, s, cin) for k in (1, 3) for s in (1, 2)
              for cin in (8, 16, 32, 64)]
# the space-to-depth packed 2x2 convs: stride 1, padded (1, 0)
CONV_CASES += [(2, 1, cin) for cin in (16, 32, 64)]


@pytest.mark.parametrize("k,s,cin", CONV_CASES)
def test_int8_conv_acc_bit_equal_jax(k, s, cin):
    """The plain Q2 accumulator against `_int8_conv` bit for bit, on int8
    values up to +-127 (|sums| to 127^2 * k^2 * cin), on an odd grid (the
    stride-2 edge); cin = 8 takes Q1's zero channels up to 16. The low pad
    is k // 2 and the high one k - 1 - k // 2: SAME for k 1 and 3, and
    the packed 2x2 convs' (1, 0) for k 2 (`models/packed.py`)."""
    rng = np.random.default_rng(k * 100 + s * 10 + cin)
    xq = rng.integers(-127, 128, (2, 9, 11, cin), dtype=np.int8)
    wq = rng.integers(-127, 128, (k, k, cin, 24), dtype=np.int8)
    xq[0, :3] = 127  # a patch of the largest sums
    wq[..., 0] = 127
    p = k // 2
    want = np.asarray(JQ._int8_conv(jnp.asarray(xq), jnp.asarray(wq), (s, s),
                                    ((p, k - 1 - p),) * 2))
    xp = torch.from_numpy(xq)
    xp = torch.nn.functional.pad(xp, (0, quant.padded_channels(cin) - cin))
    got = quant.int8_conv_acc(xp.contiguous(), quant.pack_weights(wq), k, s)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_input_bit_equal_jax(dtype):
    """Q1 against `_quant_input`: the reciprocal rounded to dt, the
    product in dt, round half to even (exact .5 ties placed on purpose),
    the clip at +-127, and the zero channels past C."""
    a_scale = np.float32(0.03125)  # inv 32: x = (n + 0.5) / 32 is a tie
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (2, 7, 5, 20)).astype(np.float32)
    x[0, 0, :, :10] = (np.arange(-5, 5) + 0.5) / 32.0  # ties
    x[0, 1, 0, :2] = (9.0, -9.0)  # clipped
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(JQ._quant_input(jnp.asarray(x), {"a_scale":
                                                       jnp.asarray(a_scale)},
                                      jdt))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt)
    got = quant.quant_input_plain(xt, quant.input_inverse(a_scale, tdt))
    assert got.shape == (2, 7, 5, 32)
    np.testing.assert_array_equal(got[..., :20].numpy(), want)
    assert not got[..., 20:].any()
    assert set(np.unique(want[0, 0, :, :10])) <= set(range(-4, 5))


@pytest.mark.parametrize("k,s,cin,cout", [(3, 1, 16, 16), (3, 2, 16, 32),
                                          (1, 1, 32, 16), (3, 1, 64, 64)])
def test_conv_body_matches_jax_f32(k, s, cin, cout):
    """One quantized ConvBNSiLU body (Q1, Q2 and the epilogue, through the
    registered ops on CPU tensors) against `_quant_conv_silu`, float32."""
    rng = np.random.default_rng(k + s + cin)
    x = rng.normal(0, 1, (2, 10, 10, cin)).astype(np.float32)
    q = {"w_int8": rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8),
         "w_scale": rng.uniform(1e-3, 1e-2, cout).astype(np.float32),
         "bias": rng.normal(0, 0.5, cout).astype(np.float32),
         "a_scale": np.float32(np.abs(x).max() / 127.0)}
    mod = JaxConvBNSiLU(cout, k, s)
    want = np.asarray(JQ._quant_conv_silu(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in q.items()}, mod))
    qmod = Q.QuantConvBNSiLU(q, k, s, torch.float32)
    before = (quant.quant_launches, quant.conv_launches)
    got = qmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert (quant.quant_launches, quant.conv_launches) == before
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-7)
    qmod.plain = True
    torch.testing.assert_close(qmod(torch.from_numpy(x).permute(0, 3, 1, 2)),
                               got, rtol=0, atol=0)


def test_ops_fake_and_real_agree():
    """`torch.library.opcheck`: the fake (meta) functions that
    `torch.export` traces give the real outputs' shapes and dtypes, and
    the schemas hold."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (2, 8, 6, 6)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        torch.library.opcheck(torch.ops.yolo_torch.quant_input.default,
                              (x.to(dt), 12.5))
    xq = quant.quant_input_plain(x, 12.5)
    w = quant.pack_weights(rng.integers(-127, 128, (3, 3, 8, 16),
                                        dtype=np.int8))
    vec = torch.ones(16)
    for bf16 in (False, True):
        torch.library.opcheck(torch.ops.yolo_torch.int8_conv.default,
                              (xq, w, vec, vec, 3, 2, bf16))


@pytest.mark.parametrize("how", ["dtype", "layout", "epilogue", "device",
                                 "kernel", "packing", "align"])
def test_kernel_wrappers_refuse_bad_tensors(how):
    """The wrappers raise, before the library is built or a launch made,
    on tensors their kernels cannot read; no copy, no fallback."""
    xq = torch.zeros((1, 4, 4, 16), dtype=torch.int8)
    w = torch.zeros((8, 32), dtype=torch.int8)
    vec = torch.zeros(8)
    if how == "dtype":
        with pytest.raises(TypeError):
            quant._launch_int8_conv(xq.float(), w, vec, vec, 1, 1, 1)
        with pytest.raises(TypeError):
            quant._launch_quant_input(torch.zeros((1, 3, 4, 4),
                                                  dtype=torch.float16), 1.0)
    elif how == "layout":
        with pytest.raises(ValueError, match="contiguous"):
            quant._launch_int8_conv(xq.transpose(1, 2), w, vec, vec, 1, 1, 1)
    elif how == "epilogue":
        with pytest.raises(ValueError, match="float32 scale"):
            quant._launch_int8_conv(xq, w, vec.double(), vec, 1, 1, 1)
    elif how == "kernel":  # Q2's tap table and stage sizes cover k 1-3
        w5 = torch.zeros((8, 416), dtype=torch.int8)
        with pytest.raises(ValueError, match="k 1, 2 or 3"):
            quant._launch_int8_conv(xq, w5, vec, vec, 5, 1, 1)
        with pytest.raises(ValueError, match="stride"):
            quant._launch_int8_conv(xq, w, vec, vec, 1, 0, 1)
    elif how == "packing":  # w's K must be what pack_weights gives
        with pytest.raises(ValueError, match="Kp"):
            quant._launch_int8_conv(xq, w, vec, vec, 3, 1, 1)
        with pytest.raises(ValueError, match="Cp"):
            quant._launch_int8_conv(torch.zeros((1, 4, 4, 8),
                                                dtype=torch.int8), w, vec,
                                    vec, 1, 1, 1)
    elif how == "align":  # TMA reads from 16-byte boundaries
        flat = torch.zeros(xq.numel() + 1, dtype=torch.int8)
        with pytest.raises(ValueError, match="16-byte"):
            quant._launch_int8_conv(flat[1:].view(xq.shape), w, vec, vec, 1,
                                    1, 1)
    else:
        with pytest.raises(ValueError, match="CPU or CUDA"):
            quant.int8_conv_acc(xq.to("meta"), w.to("meta"), 1, 1)
    assert quant.conv_launches == 0 and quant.quant_launches == 0


def test_percentile_above_quantile_limit():
    """The percentile of 2^24 + 3 values (torch.quantile refuses more
    than 2^24) by kthvalue, against numpy's linear interpolation."""
    rng = np.random.default_rng(1)
    ax = rng.random(2 ** 24 + 3, np.float32)
    got = float(Q._percentile(torch.from_numpy(ax), 99.9))
    np.testing.assert_allclose(got, np.percentile(ax, 99.9), rtol=1e-6)


def test_calib_batches_match_jax(tmp_path):
    """The calibration letterbox divides by 255.0 as the JAX package's
    does (the serving path's INV255 product can differ by an ulp)."""
    paths = []
    for i, hw in enumerate(((60, 200), (128, 128), (90, 70))):
        arr = (np.random.default_rng(i).random(hw + (3,)) * 255).astype(
            np.uint8)
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(arr).save(paths[-1])
    got = Q.calib_batches_from_images(paths, 128, batch_size=2)
    want = JQ.calib_batches_from_images(paths, 128, batch_size=2)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_predictors_refuse_device_letterbox():
    cfg, _ = _cfgs("anchor")
    state = from_flax_variables(random_variables(YOLO(cfg, device="meta"),
                                                 0), YOLO(cfg, device="meta"))
    for cls in (Predictor, BatchPredictor):
        with pytest.raises(ValueError, match="device_letterbox"):
            cls(state, cfg, device=CPU, device_letterbox=True,
                quantize_calib=["x.jpg"])


def test_quantized_batch_predictor_serves(setup, temp_dataset_dir):
    """`BatchPredictor(quantize_calib=...)` serves the int8 model on the
    CPU: detections well formed, every prediction within
    2e-3 of the float predictor's (the probability-level bound of the JAX
    package's test) in objectness and best-class probability, and no
    kernel launched."""
    imgs = [str(p) for p in
            sorted((temp_dataset_dir / "val" / "images").glob("*.jpg"))[:2]]
    kw = dict(conf_threshold=1e-3, max_outputs=512, device=CPU)
    cfg = setup["cfg"].with_(img_size=128)
    qnt = BatchPredictor(setup["state"], cfg, quantize_calib=imgs, **kw)
    flt = BatchPredictor(setup["state"], cfg, **kw)
    out = qnt(imgs)
    assert len(out) == 2 and all(out)
    for dets in out:
        for d in dets:
            assert len(d) == 6 and d[2] >= d[0] and d[3] >= d[1]
            assert 0.0 <= d[4] <= 1.0
    args = qnt.stage(imgs)
    _, obj_q, cls_q, _ = qnt.postprocess.decode(*args)
    _, obj_f, cls_f, _ = flt.postprocess.decode(*args)
    assert (obj_q - obj_f).abs().max() < 2e-3
    assert (cls_q - cls_f).abs().max() < 2e-3
    assert quant.conv_launches == 0 and quant.quant_launches == 0
