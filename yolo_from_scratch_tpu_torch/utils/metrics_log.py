"""Append-only JSONL metrics writer, one record per epoch (a copy of
`yolo_from_scratch_tpu/utils/metrics_log.py::MetricsLogger`: importing the
JAX package's `utils` loads flax), and `profiler_trace`, the counterpart
of its `profiler_trace` on `torch.profiler`."""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path


class MetricsLogger:
    """Append-only JSONL metrics writer; a no-op without a path."""

    def __init__(self, path=None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, record: dict):
        if not self.path:
            return
        record = dict(record, ts=time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


@contextlib.contextmanager
def profiler_trace(logdir=None):
    """Trace the region with `torch.profiler` when a logdir is given: CPU
    activities, and CUDA ones where a card is there; on exit the Chrome
    trace is written to `logdir/trace.json` (Perfetto and
    chrome://tracing open it). Without a logdir a no-op. The profiler's
    own errors propagate. Yields the profiler (None without a logdir)."""
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))
