"""Append-only JSONL metrics writer, one record per epoch (a copy of
`yolo_from_scratch_tpu/utils/metrics_log.py::MetricsLogger`: importing the
JAX package's `utils` loads flax)."""

from __future__ import annotations

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
