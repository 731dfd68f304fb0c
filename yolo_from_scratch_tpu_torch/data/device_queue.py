"""Double-buffered host-to-device input queue (counterpart of
`yolo_from_scratch_tpu/data/device_queue.py`, one device).

Batches come from the port's own host loader
(`yolo_from_scratch_tpu_torch/data/loader.py`, numpy only), are copied
into pinned host memory and sent to the card with `non_blocking=True` one
batch AHEAD of the consumer, so the copy of batch N+1 overlaps step N.
On the CPU the numpy arrays are wrapped without a copy. On a 2-D mesh
(`--spatial`) only this rank's block of rows of the images and dense
targets is sent (`parallel/mesh.py::shard_batch` of its data shard's
batch); compact labels go whole. A train step that cuts the rows itself
(the device mosaic, which composes whole images) is given a queue
without the mesh (`train/loop.py::train_epoch`).
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_from_scratch_tpu_torch.device import upload
from yolo_from_scratch_tpu_torch.parallel.mesh import shard_batch


class DeviceQueue:
    """Iterate (images, targets, valid_count) on `device`, one batch ahead
    of the consumer: targets [t_p3, t_p4, t_p5] dense, or [labels, counts]
    for a compact loader (`DataLoader(compact=K)`). With a 2-D `mesh` the
    loader's batches are this rank's data shard's, and this rank's rows
    of them are placed; valid_count stays the batch's images."""

    def __init__(self, loader, device, mesh=None):
        self.loader = loader
        self.device = torch.device(device)
        self.rows = mesh.space_view() if mesh is not None and mesh.spatial \
            else None

    def _put(self, array):
        return upload(torch.from_numpy(array), self.device)

    def _place(self, images, targets):
        valid = images.shape[0]
        if self.rows is not None:
            images, targets = shard_batch(self.rows, images, targets)
            # a row block is a strided view of the batch; made contiguous,
            # only its rows travel
            images = np.ascontiguousarray(images)
            targets = [np.ascontiguousarray(t) for t in targets]
        return (self._put(images), [self._put(t) for t in targets], valid)

    def __iter__(self):
        pending = None
        for images, targets in self.loader:
            staged = self._place(images, targets)  # async copy on a card
            if pending is not None:
                yield pending
            pending = staged
        if pending is not None:
            yield pending
