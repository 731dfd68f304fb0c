"""Read the JAX package's msgpack checkpoints with `msgpack` alone
(counterpart of `yolo_from_scratch_tpu/utils/checkpoint.py::load_checkpoint`).

The JAX package's serializer writes each array as a msgpack extension
(type 1, ndarray; type 3, numpy scalar) whose payload is itself msgpack
`(shape, dtype name, raw C bytes)`; this decodes exactly that and refuses
any other extension.
"""

from __future__ import annotations

import numpy as np

from yolo_from_scratch_tpu.config import YoloConfig

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray_from_bytes(data: bytes):
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 checkpoint leaves are not supported")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(
        shape, order="C")


def _ext_hook(code, data):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def read_payload(path) -> dict:
    """The checkpoint's msgpack payload as nested dicts of numpy arrays."""
    import msgpack

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)


def config_from_payload(payload) -> YoloConfig:
    """The `YoloConfig` the JAX `load_checkpoint` builds from a payload."""
    return YoloConfig(
        num_classes=int(payload["num_classes"]),
        img_size=int(payload["img_size"]),
        width_mult=float(payload["width_mult"]),
        depth_mult=float(payload["depth_mult"]),
        anchors=tuple(
            tuple(tuple(float(v) for v in wh) for wh in s)
            for s in np.asarray(payload["anchors"])
        ),
        compute_dtype=payload.get("compute_dtype", "float32"),
        head_type=payload.get("head_type", "anchor"),
    )


def load_checkpoint(path):
    """Read a checkpoint. Returns (state_dict, cfg, meta): the port's
    state dict (float32 CPU tensors), the config, and epoch / opt_state /
    extra / version as the JAX loader returns them."""
    from yolo_from_scratch_tpu_torch.models.yolo import YOLO
    from yolo_from_scratch_tpu_torch.utils.convert import from_flax_variables

    payload = read_payload(path)
    cfg = config_from_payload(payload)
    meta = {
        "epoch": int(payload.get("epoch", 0)),
        "opt_state": payload.get("opt_state"),
        "extra": payload.get("extra"),
        "version": int(payload.get("version", 0)),
    }
    state_dict = from_flax_variables(payload["model"],
                                     YOLO(cfg, device="meta"))
    return state_dict, cfg, meta
