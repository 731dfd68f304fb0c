"""uint8 normalization in the port: multiply by `config.INV255`, never
divide by 255.

The JAX package normalizes uint8 pixels as `u8.astype(float32) * INV255`
(`config.py`): the division gives another float32 on 126 of the 256
values, one ulp apart, and that difference grows into a loss divergence
over a few steps. Both places where the port turns uint8 into float on its
own, the training step's loss (`train/steps.py::make_loss_fn`) and the
Predictor's forward (`infer/predict.py::make_postprocess`), are held to it
bit for bit over all 256 values; the host loader's copy is held by
`tests/test_torch_config_data.py`.
"""

import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu_torch import INV255, YoloConfig
from yolo_from_scratch_tpu_torch.infer.predict import make_postprocess
from yolo_from_scratch_tpu_torch.train.steps import make_loss_fn

# every uint8 value, three channels of a 16x16 image
U8 = (np.arange(16 * 16 * 3) % 256).astype(np.uint8).reshape(1, 16, 16, 3)
WANT = U8.astype(np.float32) * INV255


class _Seen(Exception):
    """Raised by the stand-in model once it has seen its input."""


def _model_input(call):
    """The float tensor that `call(model)` hands the model first."""
    seen = []

    def model(img, **kwargs):
        seen.append(img)
        raise _Seen

    with pytest.raises(_Seen):
        call(model)
    return seen[0]


@pytest.mark.parametrize("where", ["train step", "predictor"])
def test_uint8_is_multiplied_by_inv255(where):
    cfg = YoloConfig()
    images = torch.from_numpy(U8)
    if where == "train step":
        got = _model_input(lambda m: make_loss_fn(cfg)(m, images, None))
    else:
        got = _model_input(lambda m: make_postprocess(m, cfg).decode(
            images, 1.0, 0, 0))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  WANT.view(np.uint32))


def test_dividing_by_255_differs():
    """The division the port must not use rounds 126 of the 256 values
    another way."""
    u8 = np.arange(256, dtype=np.uint8)
    mul = u8.astype(np.float32) * INV255
    div = torch.from_numpy(u8).float() / 255
    assert int((div.numpy() != mul).sum()) == 126
