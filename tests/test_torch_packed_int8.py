"""int8 serving under the packed layouts (`--packed ... --int8`): the port
against the JAX package's packed int8 path, on the CPU (width 0.25,
depth 0.33, nc=3, 128 px; the plain versions of Q1 and Q2).

For each layout (`stem`, `interior`, `p3`), both heads:

- the quantized tree of the packed model is the canonical one: its
  `w_int8` bit-equal to JAX's packed quantization and to the port's
  unpacked quantization; each packed conv's int8 kernel, as Q2 reads it,
  is `pack_weights` of JAX's `repack_conv_kernel` / `pack_conv_kernel` of
  that canonical kernel, bit for bit, at JAX's packed kernel size, stride
  and padding (the 2x2 convs' (1, 0) included);
- the abs-max calibration of the packed model within rtol 1e-6 of JAX's
  packed calibration (the float convs sum in another order in the two
  packages);
- the quantized packed forward, given JAX's scales, against
  `make_quant_apply` on JAX's packed model: probabilities within 2e-3
  (`tests/test_quantize.py`'s bound), raw outputs within
  `tests/test_torch_quantize.py::test_quantized_forward_matches_jax`'s
  (the median within 1e-6, all within 2e-4);
- the packed int8 forward against the port's unpacked int8 forward,
  probabilities within 2e-3 (the float `stem0` sums in another order
  under packing, so the int8 inputs of `stem1` may differ by a step).

The packed int8 predictors serve (`Predictor` and `BatchPredictor` with
`quantize_calib`), calibrated on host-packed batches, with no launch on
the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu.config import YoloConfig as JaxConfig
from yolo_from_scratch_tpu.infer import quantize as JQ
from yolo_from_scratch_tpu.models import packed as jax_packed
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu_torch import YoloConfig
from yolo_from_scratch_tpu_torch.data.letterbox import pack_s2d_host
from yolo_from_scratch_tpu_torch.infer import quantize as Q
from yolo_from_scratch_tpu_torch.infer.predict import (
    BatchPredictor,
    Predictor,
    _load_model,
)
from yolo_from_scratch_tpu_torch.models.packed import (
    GPackedConvBNSiLU,
    PackedConvBNSiLU,
)
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import quant
from yolo_from_scratch_tpu_torch.utils.convert import (
    from_flax_variables,
    random_variables,
)

CPU = torch.device("cpu")
LAYOUTS = {"stem": dict(packed_stem=True),
           "interior": dict(packed_stem=True, packed_interior=True),
           "p3": dict(packed_stem=True, packed_interior=True,
                      packed_p3=True)}
CASES = [("stem", "anchor"), ("interior", "anchor"), ("p3", "anchor"),
         ("p3", "anchor_free")]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Six test workers share the cores: torch's default threads would
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _probs(out, head):
    """The probabilities of a head output: every sigmoid channel (the
    anchor head's objectness and classes, the anchor-free head's
    classes)."""
    out = np.asarray(out, np.float32)
    lead = 4 if head == "anchor" else out.shape[-1] - 3
    return 1.0 / (1.0 + np.exp(-out[..., lead:]))


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def case(request):
    """Per (layout, head): the seeded weights in both packages, the
    packed and the pixel image batches, both packages' packed
    calibrations and quantized trees, the port's unpacked tree, and the
    port's quantized packed and unpacked models."""
    torch.set_num_threads(1)
    layout, head = request.param
    kw = dict(num_classes=3, img_size=128, width_mult=0.25, depth_mult=0.33,
              head_type=head)
    cfg = YoloConfig(**kw)
    pcfg, jpcfg = cfg.with_(**LAYOUTS[layout]), JaxConfig(**kw, **LAYOUTS[
        layout])
    variables = random_variables(YOLO(cfg, device="meta"), seed=0)
    state = from_flax_variables(variables, YOLO(cfg, device="meta"))
    imgs = np.random.default_rng(7).random((2, 128, 128, 3), np.float32)
    packed = pack_s2d_host(imgs)
    jmodel = JaxYOLO(jpcfg)
    jscales = JQ.calibrate(jmodel, variables, [jnp.asarray(packed)])
    jtree = JQ.quantize_params(variables, jscales, skip=("stem0",))
    pmodel = _load_model(state, pcfg, CPU)
    umodel = _load_model(state, cfg, CPU)
    scales = Q.calibrate(pmodel, [packed])
    qtree = Q.quantize_params(state, jscales, skip=("stem0",))
    with torch.inference_mode():
        got = Q.quantized_copy(pmodel, qtree)(torch.from_numpy(packed))
        unp = Q.quantized_copy(umodel, Q.quantize_params(
            state, Q.calibrate(umodel, [imgs]), skip=("stem0",)))(
                torch.from_numpy(imgs))
        pk = Q.quantized_copy(pmodel, Q.quantize_params(
            state, scales, skip=("stem0",)))(torch.from_numpy(packed))
    want = JQ.make_quant_apply(jmodel)((variables, jtree),
                                       jnp.asarray(packed))
    return dict(layout=layout, head=head, pmodel=pmodel, state=state,
                scales=scales, jscales=jscales, jtree=jtree, qtree=qtree,
                got=got, want=want, unpacked=unp, packed=pk,
                uscales=Q.calibrate(umodel, [imgs]))


def test_packed_int8_weights_match_jax_and_unpacked(case):
    """The canonical int8 tree is the same in both packages and layouts,
    and every packed conv's Q2 kernel is JAX's repack of it, bit for
    bit."""
    qtree, jtree = case["qtree"], case["jtree"]
    assert list(qtree) == list(jtree) and "stem0" not in qtree
    unpacked = Q.quantize_params(case["state"], case["uscales"],
                                 skip=("stem0",))
    assert sorted(unpacked) == sorted(qtree)
    for key, q in jtree.items():
        np.testing.assert_array_equal(qtree[key]["w_int8"],
                                      np.asarray(q["w_int8"]), err_msg=key)
        np.testing.assert_array_equal(unpacked[key]["w_int8"],
                                      qtree[key]["w_int8"], err_msg=key)
    qmodel = Q.quantized_copy(case["pmodel"], qtree)
    n_packed = 0
    for name, mod in case["pmodel"].named_modules():
        if not isinstance(mod, (GPackedConvBNSiLU, PackedConvBNSiLU)) or \
                name == "stem0":
            continue
        n_packed += 1
        w = np.asarray(jtree[name.replace(".", "/")]["w_int8"])
        if isinstance(mod, PackedConvBNSiLU):
            wp = np.array(jax_packed.pack_conv_kernel(
                jnp.asarray(w), mod._packed_in))
            s_packed, pad = 1, (1, 0)
        else:
            stride, fi, fo, segs = mod._packing
            wp, s_packed, pad = jax_packed.repack_conv_kernel(
                jnp.asarray(w), stride, fi, fo, in_segments=segs)
            wp = np.array(wp)
        assert wp.dtype == np.int8
        body = qmodel.get_submodule(name)
        # Q2 pads a k x k conv k // 2 low and k - 1 - k // 2 high: the
        # packed conv's own padding
        k = body.k
        assert (k, body.stride) == (wp.shape[0], s_packed)
        assert tuple(pad) == (k // 2, k - 1 - k // 2)
        assert torch.equal(body.w, quant.pack_weights(wp)), name
        ph = mod.phases_out
        np.testing.assert_array_equal(
            body.scale.numpy(), quant.dequant_vectors(
                qtree[name.replace(".", "/")]["a_scale"],
                np.tile(qtree[name.replace(".", "/")]["w_scale"], ph),
                np.tile(qtree[name.replace(".", "/")]["bias"], ph),
                torch.float32)[0].numpy())
    # stem1; + the C3a's five and bb_p3_down; + the C3b's five,
    # bb_p4_down, lateral_p3, merge_p3's five and downsample_p3_to_p4
    assert n_packed == {"stem": 1, "interior": 7, "p3": 20}[case["layout"]]


def test_packed_calibration_matches_jax(case):
    got, want = case["scales"], case["jscales"]
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[k] for k in want], list(want.values()),
                               rtol=1e-6)


def test_packed_int8_forward_matches_jax(case):
    for g, w in zip(case["got"], case["want"]):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        diff = np.abs(g - w)
        assert diff.max() < 2e-4, diff.max()
        assert np.median(diff) < 1e-6, np.median(diff)
        assert np.abs(_probs(g, case["head"])
                      - _probs(w, case["head"])).max() < 2e-3


def test_packed_int8_matches_unpacked_int8(case):
    for p, u in zip(case["packed"], case["unpacked"]):
        assert p.shape == u.shape
        assert np.abs(_probs(p.numpy(), case["head"])
                      - _probs(u.numpy(), case["head"])).max() < 2e-3


def test_packed_calibration_batches_are_host_packed(tmp_path):
    """`calib_batches_from_images(packed_stem=True)` equals the JAX
    package's: the letterboxed batch packed on the host."""
    from PIL import Image

    paths = []
    for i, hw in enumerate(((60, 200), (128, 128), (90, 70))):
        arr = (np.random.default_rng(i).random(hw + (3,)) * 255).astype(
            np.uint8)
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(arr).save(paths[-1])
    got = Q.calib_batches_from_images(paths, 128, batch_size=2,
                                      packed_stem=True)
    want = JQ.calib_batches_from_images(paths, 128, batch_size=2,
                                        packed_stem=True)
    assert [g.shape for g in got] == [(2, 32, 32, 48), (1, 32, 32, 48)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("layout", ["stem", "p3"])
def test_packed_int8_predictors_serve(layout, temp_dataset_dir):
    """The packed int8 predictors serve on the CPU: the packed model's
    convs quantized (none left float but stem0), detections well formed,
    each prediction's probabilities within 2e-3 of the packed float
    predictor's, no kernel launched."""
    cfg = YoloConfig(num_classes=1, img_size=128, width_mult=0.25,
                     depth_mult=0.33, **LAYOUTS[layout])
    state = from_flax_variables(random_variables(YOLO(cfg, device="meta"),
                                                 seed=0),
                                YOLO(cfg, device="meta"))
    imgs = [str(p) for p in
            sorted((temp_dataset_dir / "val" / "images").glob("*.jpg"))[:2]]
    kw = dict(conf_threshold=1e-3, max_outputs=512, device=CPU)
    qnt = BatchPredictor(state, cfg, quantize_calib=imgs, **kw)
    flt = BatchPredictor(state, cfg, **kw)
    assert not isinstance(qnt.model.stem0, Q.QuantConvBNSiLU)
    assert isinstance(qnt.model.stem1, Q.QuantConvBNSiLU)
    assert not any(isinstance(m, (GPackedConvBNSiLU, PackedConvBNSiLU))
                   for n, m in qnt.model.named_modules() if n != "stem0")
    out = qnt(imgs)
    assert len(out) == 2 and all(out)
    args = qnt.stage(imgs)
    assert tuple(args[0].shape) == (2, 32, 32, 48)
    _, obj_q, cls_q, _ = qnt.postprocess.decode(*args)
    _, obj_f, cls_f, _ = flt.postprocess.decode(*args)
    assert (obj_q - obj_f).abs().max() < 2e-3
    assert (cls_q - cls_f).abs().max() < 2e-3
    one = Predictor(state, cfg, quantize_calib=imgs[:1], **kw)
    assert isinstance(one.model.stem1, Q.QuantConvBNSiLU)
    assert all(len(d) == 6 for d in one(imgs[0]))
    assert quant.conv_launches == 0 and quant.quant_launches == 0
