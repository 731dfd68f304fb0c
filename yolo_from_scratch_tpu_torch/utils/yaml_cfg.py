"""dataset.yaml loader, keys `nc`, `names`, `train`, `val` (a copy of
`yolo_from_scratch_tpu/utils/yaml_cfg.py`: importing the JAX package's
`utils` loads flax)."""

from __future__ import annotations

import yaml


def load_dataset_yaml(path) -> dict:
    with open(path, encoding="utf-8") as f:
        return yaml.safe_load(f)
