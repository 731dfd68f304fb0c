"""The readers of the program's span counters (`core/spans.py`) read a
number after a run of their cell's kind, cut to a CPU size, and nothing
without a trace; on a card, a traced run captures the training graph
once (no recapture in the window)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import run
from portbench.core import registry
from yolo_from_scratch_tpu_torch.utils import metrics_log

SPEC = json.loads((Path(__file__).resolve().parents[2]
                   / "BENCHMARK.json").read_text())
READERS = {
    "train": ("gather_ms.train", "take_wait_ms.train", "capture_s.train"),
    "serve": ("letterbox_ms.serve", "upload_ms.serve", "upload_gb_s.serve",
              "lists_ms.serve", "calibrate_s.serve"),
}
CELLS = {"train": "s-train-stream-b64", "serve": "l-serve-b32-int8"}
SEED = 2 ** 33 + 17


def _entry(name):
    return next(m for m in SPEC["per_layer"] if m["name"] == name)


def _run(kind, traced, device):
    metrics_log.reset()
    _, result, _, _ = run.run_cell(CELLS[kind], SEED, 0.5, traced, device,
                                   lambda: 0.0)
    return result


def test_each_reader_is_declared_where_its_spans_run():
    for kind, names in READERS.items():
        for name in names:
            m = _entry(name)
            assert m["source"] == "program_span"
            assert CELLS[kind] in m["workloads"]


@pytest.mark.parametrize("kind", sorted(READERS))
def test_readers_read_the_programs_counters(tiny_cells, kind):
    _run(kind, False, "cpu")
    cell = registry.workload(CELLS[kind])
    c = metrics_log.counters()
    for name in READERS[kind]:
        read = registry.metric_reader(name)
        value = read({"cell": cell, "record": {}, "trace": {}})
        assert isinstance(value, float) and value >= 0, name
        assert read({"cell": cell, "record": {}, "trace": None}) is None
    if kind == "serve":
        assert c["serve.calibrate"]["calls"] == 1
        assert c["serve.upload"]["bytes"] > 0
    else:
        assert c["stream.take"]["calls"] == c["train.chunk"]["calls"] > 1


@pytest.mark.parametrize("kind", sorted(READERS))
def test_a_traced_run_captures_once(card, tiny_cells, kind):
    result = _run(kind, True, card)
    c = metrics_log.counters()
    got = set(result["metrics"])
    assert set(READERS[kind]) <= got, got
    if kind == "train":
        assert c["graph.capture"]["calls"] == 1
        assert c["train.replay"]["calls"] == c["train.chunk"]["calls"]
    else:
        assert "graph.capture" not in c
        assert c["serve.calibrate"]["calls"] == 1
