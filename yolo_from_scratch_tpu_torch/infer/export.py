"""Frozen serving artifacts via `torch.export` (counterpart of
`yolo_from_scratch_tpu/infer/export.py`).

Freezes the whole batched serving program, forward + decode + sigmoid +
gate + top-k + class-aware NMS (`make_batch_postprocess`, the program the
live `BatchPredictor` runs), with the weights baked in, into one file; a
serving process loads it with `infer/artifact.py` and needs no model code,
no checkpoint and no tracing. With `quantize_calib` the int8 model
(`infer/quantize.py`) is frozen instead: its int8 weights and scales are
the baked-in constants.

Platforms: an artifact holds one program for one platform, "cuda" (the
default) or "cpu", exported on that platform's device. A "cuda" program
calls K1, Q1 and Q2 through the registered ops, which launch the kernels;
a "cpu" program calls the same ops, which run the plain versions. The JAX
package's multi-platform and "tpu" lowerings have no counterpart: a list
naming more than one platform, or "tpu", is refused with the reason.
"""

from __future__ import annotations

import io

import torch
from torch import nn

from yolo_from_scratch_tpu_torch.config import YoloConfig
from yolo_from_scratch_tpu_torch.device import cuda_device
from yolo_from_scratch_tpu_torch.infer.artifact import (  # noqa: F401
    MAGIC,
    ServingArtifact,
    load_serving_artifact,
    write_artifact,
)

PLATFORMS = ("cuda", "cpu")


def check_platforms(platforms) -> str:
    """The one platform of `platforms` (None: "cuda"); ValueError with the
    reason for anything else."""
    platforms = ["cuda"] if platforms is None else list(platforms)
    if "tpu" in platforms:
        raise ValueError(
            "'tpu' is a platform of the JAX package's jax.export artifacts "
            "(`python train.py ... --export`); the port exports 'cuda' or "
            "'cpu'")
    if len(platforms) != 1:
        raise ValueError(
            f"an artifact of the port holds one program for one platform, "
            f"got {platforms}: export once for each of {list(PLATFORMS)}")
    if platforms[0] not in PLATFORMS:
        raise ValueError(f"unknown platform {platforms[0]!r}: the port "
                         f"exports one of {list(PLATFORMS)}")
    return platforms[0]


class _Frozen(nn.Module):
    """(imgs (B, S, S, 3) float32 in [0, 1], scales, pad_tops, pad_lefts)
    -> (boxes (B, K, 4), scores (B, K), classes (B, K), valid (B, K)): a
    BatchPredictor's program, its model a submodule so that the export
    holds the weights."""

    def __init__(self, model, postprocess):
        super().__init__()
        self.model = model
        self._postprocess = postprocess

    def forward(self, imgs, scales, pad_tops, pad_lefts):
        return self._postprocess(imgs, scales, pad_tops, pad_lefts)


def export_serving(state_dict, cfg: YoloConfig, batch_size: int,
                   conf_threshold=0.5, iou_threshold=0.4, topk=None,
                   max_outputs=300, platforms=None, quantize_calib=None):
    """Build and export the frozen batched serving program. Returns
    (torch.export.ExportedProgram, header dict).

    The program takes (imgs (B, S, S, 3) float32, scales (B,), pad_tops
    (B,), pad_lefts (B,)) on its platform's device and returns (boxes
    (B, K, 4), scores (B, K), classes (B, K), valid (B, K)), K =
    `max_outputs`. `quantize_calib`: a list of images; the int8 program,
    calibrated on them, is frozen instead. A packed config is not
    exported yet (ROADMAP A10b): it raises."""
    if cfg.packed_stem:
        raise ValueError("exporting a packed model is not ported: export "
                         "the unpacked config (the weights are the same)")
    from yolo_from_scratch_tpu_torch.infer.predict import (
        BatchPredictor,
        default_topk,
        preds_per_cell,
    )

    platform = check_platforms(platforms)
    device = cuda_device() if platform == "cuda" else torch.device("cpu")
    live = BatchPredictor(state_dict, cfg, conf_threshold, iou_threshold,
                          max_outputs=max_outputs, topk=topk,
                          quantize_calib=quantize_calib, device=device)
    frozen = _Frozen(live.model, live.postprocess).eval()
    # dense weights: the archive stores a strided (permuted) tensor as a
    # slice of its storage and warns that this may break off the CPU
    for t in [*frozen.parameters(), *frozen.buffers()]:
        t.data = t.data.contiguous()
    s = cfg.img_size
    args = (torch.zeros((batch_size, s, s, 3), dtype=torch.float32,
                        device=device),
            torch.ones(batch_size, dtype=torch.float32, device=device),
            torch.zeros(batch_size, dtype=torch.float32, device=device),
            torch.zeros(batch_size, dtype=torch.float32, device=device))
    exported = torch.export.export(frozen, args, strict=False)
    header = {
        "format": 1,
        "batch_size": batch_size,
        "img_size": s,
        "num_classes": cfg.num_classes,
        "packed_stem": False,
        "head_type": cfg.head_type,
        "conf_threshold": conf_threshold,
        "iou_threshold": iou_threshold,
        "topk": topk or default_topk(s, preds_per_cell(cfg)),
        "max_outputs": max_outputs,
        "platforms": [platform],
        "cuda_nms": platform == "cuda",
        "int8": quantize_calib is not None,
    }
    return exported, header


def save_serving_artifact(path, state_dict, cfg: YoloConfig,
                          batch_size: int, **kwargs):
    """Export and write a serving artifact file; returns the header."""
    exported, header = export_serving(state_dict, cfg, batch_size, **kwargs)
    # the zero batch traced with is not kept: 39 MB at B=8 @640
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    write_artifact(path, header, buf.getvalue())
    return header
