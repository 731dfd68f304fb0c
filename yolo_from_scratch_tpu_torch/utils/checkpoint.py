"""Read and write the JAX package's msgpack checkpoints with `msgpack`
alone (counterpart of `yolo_from_scratch_tpu/utils/checkpoint.py`).

The JAX package's serializer writes each array as a msgpack extension
(type 1, ndarray; type 3, numpy scalar) whose payload is itself msgpack
`(shape, dtype name, raw C bytes)`; this decodes exactly that and refuses
any other extension, and `save_checkpoint` encodes the same way, so the
JAX `load_checkpoint` reads what the port writes.
"""

from __future__ import annotations

import os

import numpy as np

from yolo_from_scratch_tpu_torch.config import YoloConfig

CKPT_VERSION = 1
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


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    import msgpack

    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _ext_pack(obj):
    import msgpack

    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(obj))
    if isinstance(obj, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR,
                               _ndarray_to_bytes(np.asarray(obj)))
    raise TypeError(f"cannot serialize {type(obj).__name__} in a checkpoint")


def save_checkpoint(path, variables: dict, cfg: YoloConfig, epoch: int = 0,
                    opt_state: dict | None = None, extra: dict | None = None):
    """Write a checkpoint in the JAX package's format. `variables` is
    `{'params': ..., 'batch_stats': ...}` of numpy arrays (see
    `utils/convert.py::to_flax_variables`); `opt_state`, when given, is the
    optimizer state as nested dicts of numpy arrays in the layout the JAX
    `restore_train_state` reads (`train/steps.py::optax_state_dict`). The
    file is replaced atomically: a crash mid-write keeps the old one."""
    import msgpack

    payload = {
        "version": CKPT_VERSION,
        "model": variables,
        "epoch": int(epoch),
        "num_classes": int(cfg.num_classes),
        "img_size": int(cfg.img_size),
        "width_mult": float(cfg.width_mult),
        "depth_mult": float(cfg.depth_mult),
        "anchors": np.asarray(cfg.anchors, np.float32),
        "compute_dtype": cfg.compute_dtype,
        "head_type": cfg.head_type,
    }
    if opt_state is not None:
        payload["opt_state"] = opt_state
    if extra:
        payload["extra"] = extra
    blob = msgpack.packb(payload, default=_ext_pack, strict_types=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


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
    from yolo_from_scratch_tpu_torch.models.yolo import (
        YOLO,
        ensure_detection_biases,
    )
    from yolo_from_scratch_tpu_torch.utils.convert import from_flax_variables

    payload = read_payload(path)
    cfg = config_from_payload(payload)
    meta = {
        "epoch": int(payload.get("epoch", 0)),
        "opt_state": payload.get("opt_state"),
        "extra": payload.get("extra"),
        "version": int(payload.get("version", 0)),
    }
    variables = payload["model"]
    if isinstance(variables.get("params"), dict):
        # a degenerate checkpoint may lack a head bias: repair and warn, as
        # the JAX loader does
        variables["params"] = ensure_detection_biases(variables["params"], cfg)
    state_dict = from_flax_variables(variables, YOLO(cfg, device="meta"))
    return state_dict, cfg, meta
