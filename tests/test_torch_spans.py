"""The port's span recorder (`utils/metrics_log.py`) at its sites: the
counters are exact and always on, spans are recorded only under a
profiler or `recording()`, nest under their call, share the profiler's
clock and land in `profiler_trace`'s file, and no profiler event is
added for them."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from yolo_from_scratch_tpu_torch import YoloConfig
from yolo_from_scratch_tpu_torch.data.stream import ChunkStream
from yolo_from_scratch_tpu_torch.infer.predict import BatchPredictor
from yolo_from_scratch_tpu_torch.models.yolo import YOLO
from yolo_from_scratch_tpu_torch.ops import letterbox_cuda
from yolo_from_scratch_tpu_torch.train.steps import (
    TrainState,
    make_optimizer,
    make_train_step_multi_compact,
)
from yolo_from_scratch_tpu_torch.utils import metrics_log
from yolo_from_scratch_tpu_torch.utils.metrics_log import (
    Recorder,
    counters,
    profiler_trace,
    recording,
    span,
    spans,
)

S, B, NC, K = 64, 2, 2, 4
CFG = YoloConfig(num_classes=NC, img_size=S, width_mult=0.25,
                 depth_mult=0.33)
SERVE_CHILDREN = {"serve.letterbox", "serve.upload", "serve.l1",
                  "serve.forward", "serve.download", "serve.lists"}
NAMES = SERVE_CHILDREN | {"serve.call", "serve.calibrate", "stream.gather",
                          "stream.upload", "stream.take", "train.chunk",
                          "train.copy_inputs", "train.replay",
                          "graph.capture", "kernels.build"}


@pytest.fixture(autouse=True)
def fresh():
    metrics_log.reset()
    yield
    metrics_log.reset()


@pytest.fixture(scope="module")
def predictor():
    torch.manual_seed(0)
    return BatchPredictor(YOLO(CFG).state_dict(), CFG, conf_threshold=0.01,
                          max_outputs=20, device="cpu")


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8)
            for shape in ((40, 64, 3), (64, 48, 3))]


class _Cache:
    """What ChunkStream reads of an image cache, in memory."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, S, S, 3), dtype=np.uint8)
        self.labels = np.zeros((n, K, 5), np.float32)
        self.labels[:, 0] = [0, 0.5, 0.5, 0.25, 0.25]
        self.counts = np.ones(n, np.int32)

    def __len__(self):
        return len(self.images)


def _epochs(stream, n):
    return [chunk for _ in range(n) for chunk in stream]


def test_serve_counters_are_exact(predictor):
    calls = 3
    for i in range(calls):
        predictor(_frames(i))
    c = counters()
    assert c["serve.call"]["calls"] == calls
    for name in SERVE_CHILDREN:
        assert c[name]["calls"] == calls and c[name]["ns"] > 0
    # the raw frames (each a multiple of 16 bytes, so no alignment gap,
    # and at scale 1, so no coefficients) behind the table, a row an image
    frames = sum(f.nbytes for f in _frames())
    assert frames % letterbox_cuda.ALIGN == 0
    table = B * letterbox_cuda.TABLE_ROW_BYTES
    assert c["serve.upload"]["bytes"] == calls * (frames + table)
    assert c["serve.letterbox"]["bytes"] == calls * frames
    assert c["serve.call"]["ns"] >= sum(c[n]["ns"] for n in SERVE_CHILDREN)


def test_stream_counters_are_exact():
    cache = _Cache(10)
    stream = ChunkStream(cache, batch_size=B, steps_per_chunk=2, seed=3,
                         device="cpu")
    chunks = _epochs(stream, 2)
    assert len(chunks) == 6  # 10 images, 4 a chunk, wrap-padded to 3
    c = counters()
    assert c["stream.take"]["calls"] == c["stream.gather"]["calls"] == 6
    assert c["stream.gather"]["bytes"] == sum(t.nbytes for chunk in chunks
                                              for t in chunk)
    assert "stream.upload" not in c  # nothing is uploaded on the CPU


def test_a_chunk_through_the_trainer_is_one_span():
    torch.manual_seed(0)
    model = YOLO(CFG)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-3))
    trainer = make_train_step_multi_compact(CFG, False, "cpu")
    stream = ChunkStream(_Cache(4), batch_size=B, steps_per_chunk=2,
                         device="cpu")
    with recording():
        for chunk in stream:
            state, _ = trainer(state, *chunk)
    c = counters()
    assert c["train.chunk"]["calls"] == 1
    assert "graph.capture" not in c  # the CPU runs the steps eagerly
    (chunk,) = [s for s in spans() if s["name"] == "train.chunk"]
    assert chunk["parent"] is None and chunk["call"] == chunk["index"]


def test_no_span_is_recorded_when_tracing_is_off(predictor):
    predictor(_frames())
    list(ChunkStream(_Cache(4), batch_size=B, steps_per_chunk=2,
                     device="cpu"))
    assert spans() == [] and metrics_log.dropped() == 0
    assert span("serve.call") is span("serve.call")
    assert span("x", nbytes=8) is span("x")
    assert counters()["serve.call"]["calls"] == 1


def _traced(mode, fn):
    if mode == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            fn()
    else:
        with recording():
            fn()
    return spans()


@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_spans_nest_under_their_call(predictor, mode):
    got = _traced(mode, lambda: [predictor(_frames(i)) for i in range(2)])
    calls = {s["index"]: s for s in got if s["name"] == "serve.call"}
    assert len(calls) == 2
    for s in calls.values():
        assert s["parent"] is None and s["call"] == s["index"]
    children = [s for s in got if s["name"] != "serve.call"]
    assert {s["name"] for s in children} == SERVE_CHILDREN
    assert len(children) == 2 * len(SERVE_CHILDREN)
    for s in children:
        parent = calls[s["parent"]]
        assert s["call"] == parent["index"]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= parent["end_ns"]


@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_children_cover_the_call(predictor, mode):
    got = _traced(mode, lambda: [predictor(_frames(i)) for i in range(3)])
    for call in (s for s in got if s["name"] == "serve.call"):
        inside = sum(s["end_ns"] - s["start_ns"] for s in got
                     if s["parent"] == call["index"])
        assert inside >= 0.95 * (call["end_ns"] - call["start_ns"])


def test_no_profiler_event_is_named_like_a_span(predictor):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        predictor(_frames())
        list(ChunkStream(_Cache(4), batch_size=B, steps_per_chunk=2,
                         device="cpu"))
    assert {s["name"] for s in spans()} >= SERVE_CHILDREN | {"stream.take"}
    names = {e.name for e in prof.events()}
    assert not names & NAMES


def _probe_call(predictor):
    """A call inside `record_function("probe")`, a millisecond from each
    end (the profiler's clock and the epoch clock agree to a few us)."""
    with record_function("probe"):
        time.sleep(1e-3)
        predictor(_frames())
        time.sleep(1e-3)


def test_spans_share_the_profilers_clock(predictor):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _probe_call(predictor)
    (probe,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "probe"]
    got = spans()
    assert len(got) == 1 + len(SERVE_CHILDREN)
    for s in got:
        assert probe.start_ns() <= s["start_ns"] <= s["end_ns"] \
            <= probe.end_ns()


def test_profiler_trace_writes_the_spans(predictor, tmp_path):
    predictor(_frames())  # before the region: not in its file
    with profiler_trace(tmp_path):
        _probe_call(predictor)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (probe,) = [e for e in events if e.get("name") == "probe"]
    rows = [e for e in events if e.get("cat") == "span"]
    assert sorted(e["name"] for e in rows) == sorted(
        SERVE_CHILDREN | {"serve.call"})
    assert probe["tid"] not in {e["tid"] for e in rows}
    for e in rows:
        assert probe["ts"] <= e["ts"] <= e["ts"] + e["dur"] \
            <= probe["ts"] + probe["dur"]


def test_calibration_is_one_span():
    torch.manual_seed(0)
    BatchPredictor(YOLO(CFG).state_dict(), CFG, device="cpu",
                   quantize_calib=_frames())
    c = counters()
    assert c["serve.calibrate"]["calls"] == 1
    assert c["serve.calibrate"]["ns"] > 0


def test_the_ring_keeps_the_newest_spans():
    rec = Recorder(capacity=4)
    with rec.recording():
        for i in range(10):
            with rec.span("outer"), rec.span("inner", nbytes=i):
                pass
    got = rec.spans()
    assert [s["name"] for s in got] == ["outer", "inner"] * 2
    assert [s["index"] for s in got] == [16, 17, 18, 19]
    assert rec.dropped() == 16
    assert rec.counters()["inner"] == {
        "calls": 10, "bytes": 45, "ns": rec.counters()["inner"]["ns"]}
    rec.reset()
    assert rec.spans() == [] and rec.counters() == {} and rec.dropped() == 0
