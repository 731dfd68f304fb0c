"""Finds a cell's parts by name, each in a file of its own:

- `workloads/<cell>.json`: the cell (its configuration, traffic mix,
  batch, precision, the calls it traces and the limits of its check);
- `configs/<config>.json`: the model configuration as it is run;
- `mixes/<traffic>.json`: the traffic mix's parameters, read by
  `core/traffic.py`;
- `metrics/<metric>.py`: a per-layer metric's reader, `read(record)`,
  which returns a number or None (nothing to read in this cell);
- `BENCHMARK.json` at the root of the checkout: which end-to-end and
  per-layer metrics each cell reports.

A new cell or metric is new files here and a new entry in
`BENCHMARK.json`; no code changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return _json(BENCH_DIR / "mixes" / f"{name}.json")


def workload(name: str) -> dict:
    """The cell `name` with its configuration and mix filled in:
    {"name", "config": {...}, "mix": {...}, ...the cell file's keys}."""
    cell = _json(BENCH_DIR / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config"] = config(cell["config"])
    cell["mix"] = mix(cell["traffic"])
    return cell


def metric_reader(name: str):
    """The `read` function of `metrics/<name>.py`."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reports(metric: dict, cell: str) -> bool:
    """Does `cell` report this BENCHMARK.json metric entry?"""
    return "workloads" not in metric or cell in metric["workloads"]
