"""The port's checkpoint loader repairs a missing detection-head bias as the
JAX loader does (`ensure_detection_biases`), on the CPU.

A checkpoint of the conftest-size model is written by the port with
`head_p3/pred/bias` removed, or set to None. Both loaders read it without
error and print the same warning; the rebuilt biases are equal bit for bit
(both are float32 zeros with the float32 -log(99) on each anchor's
objectness channel); the eval outputs of the two models then agree within
the float32 tolerance of tests/test_torch_model.py (rtol=atol=1e-4: XLA and
PyTorch sum each convolution in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu.models.yolo import (
    ensure_detection_biases as jax_ensure,
)
from yolo_from_scratch_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from yolo_from_scratch_tpu_torch.models.yolo import (
    YOLO,
    ensure_detection_biases,
)
from yolo_from_scratch_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from yolo_from_scratch_tpu_torch.utils.convert import random_variables

WARNING = ("Warning: Detection head bias was None, created new bias "
           "parameter")


def _variables(cfg, how):
    v = random_variables(YOLO(cfg, device="meta"), seed=7)
    pred = v["params"]["head_p3"]["pred"]
    if how == "missing":
        del pred["bias"]
    else:
        pred["bias"] = None
    return v


@pytest.mark.parametrize("how", ["missing", "none"])
def test_load_repairs_head_bias_as_jax(cfg, tmp_path, capsys, how):
    path = tmp_path / f"{how}.ckpt"
    save_checkpoint(path, _variables(cfg, how), cfg, epoch=1)

    jax_vars, jax_cfg, _ = jax_load_checkpoint(path)
    jax_out = capsys.readouterr().out
    state, port_cfg, meta = load_checkpoint(path)
    port_out = capsys.readouterr().out
    assert port_cfg == jax_cfg == cfg and meta["epoch"] == 1
    assert jax_out == port_out == WARNING + "\n"

    want = np.asarray(jax_vars["params"]["head_p3"]["pred"]["bias"])
    got = state["head_p3.pred.bias"].numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == (18,)
    np.testing.assert_array_equal(got, want)
    assert got.reshape(3, 6)[:, 4].tolist() == [np.float32(-np.log(99.0))] * 3

    x = np.random.default_rng(3).random(
        (2, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    expected = JaxYOLO(cfg).apply(
        jax.tree_util.tree_map(jnp.asarray, jax_vars), jnp.asarray(x),
        train=False)
    model = YOLO(cfg)
    model.load_state_dict(state)
    with torch.no_grad():
        outs = model.eval()(torch.from_numpy(x))
    for g, e in zip(outs, expected):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-4)


def test_ensure_detection_biases_matches_jax(cfg):
    """The repair on the tree alone: the same bias, the same warning per
    head, an intact head left as it was, the anchor-free head untouched."""
    v = random_variables(YOLO(cfg, device="meta"), seed=8)
    intact = v["params"]["head_p4"]["pred"]["bias"].copy()
    for head in ("head_p3", "head_p5"):
        del v["params"][head]["pred"]["bias"]
    jax_logs, port_logs = [], []
    want = jax_ensure(jax.tree_util.tree_map(np.copy, v["params"]), cfg,
                      log=jax_logs.append)
    got = ensure_detection_biases(v["params"], cfg, log=port_logs.append)
    assert got is v["params"]
    assert port_logs == jax_logs == [WARNING] * 2
    for head in ("head_p3", "head_p4", "head_p5"):
        np.testing.assert_array_equal(got[head]["pred"]["bias"],
                                      np.asarray(want[head]["pred"]["bias"]))
    np.testing.assert_array_equal(got["head_p4"]["pred"]["bias"], intact)

    af = {"head_p3": {"pred": {}}}
    assert ensure_detection_biases(af, cfg.with_(head_type="anchor_free"),
                                   log=port_logs.append) == af
    assert af == {"head_p3": {"pred": {}}} and len(port_logs) == 2
