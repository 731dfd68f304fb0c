"""The harness finds a cell's parts by name from files of their own, so a
new cell or metric is new files and a new `BENCHMARK.json` entry; and
`BENCHMARK.json` keeps to its format: names, units, bounds, files."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench.core import registry

BENCH = Path(__file__).resolve().parents[1]
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_found_by_name(cell):
    found = registry.workload(cell["name"])
    assert found["config"]["name"] == cell["config"]
    assert found["traffic"] == cell["traffic"]
    assert found["mix"]["kind"] in ("train", "serve")
    assert found["limits"]
    assert found["precision"] == found["config"].get("precision",
                                                     found["precision"])


def test_each_pair_of_config_and_traffic_is_one_cell():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(registry.metric_reader(metric["name"]))


def test_names_units_and_bounds_keep_to_the_format():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in SPEC[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for c in SPEC["configs"]:
        assert (BENCH.parent / c["file"]).is_file()
        assert registry.config(c["name"])["reduced"] == c["reduced"]
    assert (BENCH.parent / "BENCHMARK.json").stat().st_size < 64 * 1024


def test_a_new_cell_and_metric_are_only_new_files(tmp_path, monkeypatch):
    """A copy of the benchmark with one more cell (an existing configuration
    under an existing mix it is not yet paired with) and one more per-layer
    metric, added as files and entries only: the registry finds both."""
    copy = tmp_path / "portbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    cell = json.loads((copy / "workloads" / "l-serve-b32.json").read_text())
    cell["config"] = "yfs-s"
    (copy / "workloads" / "s-serve-b32.json").write_text(json.dumps(cell))
    (copy / "metrics" / "calls.serve.py").write_text(
        "def read(run):\n    return run['record']['calls']\n")
    spec["workloads"].append({"name": "s-serve-b32", "config": "yfs-s",
                              "traffic": "serve_batch", "chips": 1,
                              "why": "B=32 at 's'"})
    spec["per_layer"].append({"name": "calls.serve", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "predictors", "moves": "serve_img_s",
                              "workloads": ["s-serve-b32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(registry, "BENCH_DIR", copy)
    monkeypatch.setattr(registry, "ROOT", tmp_path)
    found = registry.workload("s-serve-b32")
    assert found["batch"] == 32 and found["config"]["name"] == "yfs-s"
    assert found["mix"] == registry.mix("serve_batch")
    assert registry.metric_reader("calls.serve")(
        {"record": {"calls": 7}}) == 7
    entry = registry.benchmark()["per_layer"][-1]
    assert registry.reports(entry, "s-serve-b32")
    assert not registry.reports(entry, "l-serve-b32")


def test_readers_read_nothing_without_a_trace():
    run = {"trace": None, "record": {"spans": {}, "img_s": 100.0,
                                     "flops_per_img": 1e9,
                                     "dtype": "bfloat16"}}
    for m in SPEC["per_layer"]:
        value = registry.metric_reader(m["name"])(run)
        if m["name"].startswith("mfu"):
            assert 0 < value < 100
        else:
            assert value is None


def test_readers_of_a_trace():
    trace = {"busy_s": 0.75, "window_s": 1.0,
             "calls": [(0.1, 0.04), (0.1, 0.06)],
             "kernels": {"nms_mask_pass": (2, 0.002),
                         "nms_scan": (2, 0.002),
                         "void int8_conv_tma_kernel<64, 2>": (2, 0.01)}}
    run = {"trace": trace, "record": {"spans": {"stream.next": [0.1, 0.3]},
                                      "k1_bound_ms": 0.1,
                                      "q2_bound_ms": 1.0}}

    def read(name):
        return registry.metric_reader(name)(run)

    assert read("device_idle_pct.train") == pytest.approx(25.0)
    assert read("host_ms_per_call.serve") == pytest.approx(50.0)
    assert read("k1_roofline") == pytest.approx(5.0)
    assert read("q2_roofline") == pytest.approx(20.0)
    assert read("stream_wait_ms.train") == pytest.approx(200.0)
