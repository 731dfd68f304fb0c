"""Loading a frozen serving artifact (the loading half of
`yolo_from_scratch_tpu/infer/export.py`; `infer/export.py` writes them).

A serving process needs this module, torch and the port's registered ops
(K1's `yolo_torch::nms_keep_mask` in `ops/nms_cuda.py`; Q1's and Q2's
`yolo_torch::quant_input` and `yolo_torch::int8_conv` in `ops/quant.py`),
which the program calls: no model module is imported, no checkpoint read
and nothing traced.

File format: MAGIC + u32 header length (little-endian) + the JSON header
(the config fields the host-side pre- and post-steps need) + the
`torch.export.save` payload of the program. The magic differs from the
JAX package's `YFSTPU1\\n`: each package's loader refuses the other's
file, this one saying that the file is a `jax.export` artifact.
"""

from __future__ import annotations

import io
import json
import struct
from pathlib import Path

import numpy as np
import torch

from yolo_from_scratch_tpu_torch.data.letterbox import (
    letterbox_image,
    pack_s2d_host,
)
from yolo_from_scratch_tpu_torch.device import cuda_device
from yolo_from_scratch_tpu_torch.infer.detections import detections_per_image
from yolo_from_scratch_tpu_torch.ops import (  # noqa: F401 (the program's ops)
    nms_cuda,
    quant,
)

MAGIC = b"YFSTORCH1\n"
JAX_MAGIC = b"YFSTPU1\n"  # the JAX package's jax.export artifacts


def write_artifact(path, header: dict, payload: bytes):
    """Write MAGIC, the header's length and JSON, then the payload."""
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(head)))
        f.write(head)
        f.write(payload)


def read_artifact(path):
    """(header dict, program payload bytes) of an artifact file; raises
    ValueError on a file of the JAX package or any other bad magic."""
    raw = Path(path).read_bytes()
    if raw.startswith(JAX_MAGIC):
        raise ValueError(
            f"{path}: a jax.export artifact of the JAX package (magic "
            f"{JAX_MAGIC!r}); serve it with `python train.py`. The port "
            f"loads its own torch.export artifacts (magic {MAGIC!r})")
    if not raw.startswith(MAGIC):
        raise ValueError(f"{path}: not a serving artifact (bad magic)")
    off = len(MAGIC)
    (hlen,) = struct.unpack_from("<I", raw, off)
    off += 4
    return json.loads(raw[off:off + hlen].decode()), raw[off + hlen:]


def stage_images(images, img_size, batch_size, device, packed=False):
    """Host letterbox of up to `batch_size` paths, PIL images or HWC uint8
    arrays, divided by 255.0 as the JAX package's loader does, padded to
    `batch_size` with zero images, packed 4x on the host for a packed
    program (`packed`: `pack_s2d_host`, as the JAX package's loader packs)
    and uploaded to `device`. Returns a frozen program's arguments (imgs,
    scales, pad_tops, pad_lefts)."""
    from PIL import Image

    pils = [Image.fromarray(np.asarray(im, np.uint8))
            if isinstance(im, np.ndarray)
            else (im if hasattr(im, "size") else Image.open(im))
            for im in images]
    if len(pils) > batch_size:
        raise ValueError(
            f"{len(pils)} images > frozen batch size {batch_size}; chunk "
            f"the input or export with a larger batch_size")
    imgs, params = [], []
    for pil in pils:
        arr, scale, pad_top, pad_left = letterbox_image(pil.convert("RGB"),
                                                        img_size)
        imgs.append(arr.astype(np.float32) / 255.0)
        params.append((scale, pad_top, pad_left))
    pad_n = batch_size - len(pils)
    imgs.extend([np.zeros_like(imgs[0])] * pad_n)
    params.extend([(1.0, 0.0, 0.0)] * pad_n)
    batch = np.stack(imgs)
    batch = torch.from_numpy(pack_s2d_host(batch) if packed else batch).to(
        device)
    return (batch, *torch.tensor(params, dtype=torch.float32).to(
        device).unbind(1))


class ServingArtifact:
    """A loaded frozen serving program. Call like `BatchPredictor`: a list
    of image paths, PIL images or HWC uint8 arrays in, per-image detection
    lists out. The program runs on its platform's device
    (`meta["platforms"][0]`: the card for "cuda", which must be present;
    the CPU for "cpu"). A partial batch is padded to the frozen batch
    size; a larger one is refused."""

    def __init__(self, path):
        self.meta, payload = read_artifact(path)
        platform = self.meta["platforms"][0]
        self.device = (cuda_device() if platform == "cuda"
                       else torch.device("cpu"))
        self._program = torch.export.load(io.BytesIO(payload)).module()

    def stage(self, images):
        """`stage_images` at the artifact's size, batch, layout and
        device."""
        return stage_images(images, self.meta["img_size"],
                            self.meta["batch_size"], self.device,
                            self.meta["packed_stem"])

    def run(self, imgs, scales, pad_tops, pad_lefts):
        """The frozen program on staged arguments: (boxes (B, K, 4),
        scores (B, K), classes (B, K), valid (B, K)) on its device."""
        with torch.inference_mode():
            return self._program(imgs, scales, pad_tops, pad_lefts)

    def __call__(self, images):
        out = self.run(*self.stage(images))
        return detections_per_image(*(t.cpu() for t in out), len(images))


def load_serving_artifact(path) -> ServingArtifact:
    return ServingArtifact(path)
