"""Double-buffered host-to-device input queue (counterpart of
`yolo_from_scratch_tpu/data/device_queue.py`, one device).

Batches come from the port's own host loader
(`yolo_from_scratch_tpu_torch/data/loader.py`, numpy only), are copied
into pinned host memory and sent to the card with `non_blocking=True` one
batch AHEAD of the consumer, so the copy of batch N+1 overlaps step N.
On the CPU the numpy arrays are wrapped without a copy.
"""

from __future__ import annotations

import torch

from yolo_from_scratch_tpu_torch.device import upload


class DeviceQueue:
    """Iterate (images, targets, valid_count) on `device`, one batch ahead
    of the consumer: targets [t_p3, t_p4, t_p5] dense, or [labels, counts]
    for a compact loader (`DataLoader(compact=K)`)."""

    def __init__(self, loader, device):
        self.loader = loader
        self.device = torch.device(device)

    def _put(self, array):
        return upload(torch.from_numpy(array), self.device)

    def _place(self, images, targets):
        return (self._put(images), [self._put(t) for t in targets],
                images.shape[0])

    def __iter__(self):
        pending = None
        for images, targets in self.loader:
            staged = self._place(images, targets)  # async copy on a card
            if pending is not None:
                yield pending
            pending = staged
        if pending is not None:
            yield pending
