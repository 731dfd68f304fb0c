"""Append-only JSONL metrics writer, one record per epoch (a copy of
`yolo_from_scratch_tpu/utils/metrics_log.py::MetricsLogger`: importing the
JAX package's `utils` loads flax), `profiler_trace`, the counterpart of
its `profiler_trace` on `torch.profiler`, and the port's span recorder.

The recorder: `with span("serve.upload", nbytes=n):` at a layer's
boundary does two things.

- Counters, always on: each span name keeps monotonic `calls`, `ns` (time
  inside, `time.perf_counter_ns`) and `bytes` (when given, or set on the
  span before it closes). `counters()` takes a snapshot, `reset()` clears
  it. With tracing off a span is one object a name, shared by every call
  (two clock reads and three integer adds; it allocates and appends
  nothing), so each name is written by one thread only.
- Spans, only while tracing is on (a `torch.profiler` session runs, or
  inside `recording()`): each records its name, start, end, parent (a
  thread-local stack), thread and its root span's index, the call id
  that all spans of one predictor call or trainer chunk share. They are
  kept in a ring of `CAPACITY` spans (`dropped()` counts what fell out)
  and exported by `spans()` on the profiler's clock (epoch ns: each root
  span takes one (perf_counter_ns, time_ns) pair). `profiler_trace`
  writes them into its Chrome trace on a row of their own.

Spans open no `record_function` or NVTX range: the profiler would put
every such range on the device's timeline as if it were work there.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from pathlib import Path

from torch.autograd import profiler as _autograd_profiler

CAPACITY = 65536
# the Chrome trace rows of the spans: one a thread, a tid no OS thread has
_SPAN_TID = 2 ** 31 - 1


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


class _Counter:
    """A span name's counters, and its span while tracing is off."""

    __slots__ = ("calls", "ns", "bytes", "nbytes", "t0")

    def __init__(self):
        self.calls = self.ns = self.bytes = self.nbytes = self.t0 = 0

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.ns += time.perf_counter_ns() - self.t0
        self.calls += 1
        self.bytes += self.nbytes
        return False


class _Span:
    """A span while tracing is on: the name's counters, and a row of the
    ring [name, start, end, parent, thread, call, offset, index]
    (perf_counter ns; `offset` takes them to epoch ns)."""

    __slots__ = ("rec", "counter", "nbytes", "row")

    def __init__(self, rec, counter, name, nbytes):
        self.rec, self.counter, self.nbytes = rec, counter, nbytes
        self.row = [name, 0, None, None, threading.get_native_id(), None, 0,
                    None]

    def __enter__(self):
        rec, row = self.rec, self.row
        stack = rec._stack()
        row[7] = index = next(rec._seq)
        if stack:
            parent = stack[-1]
            row[3], row[5], row[6] = parent[7], parent[5], parent[6]
        else:
            row[5] = index
            row[6] = time.time_ns() - time.perf_counter_ns()
        stack.append(row)
        rec._ring.append(row)
        row[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        row = self.row
        row[2] = time.perf_counter_ns()
        self.rec._stack().pop()
        c = self.counter
        c.ns += row[2] - row[1]
        c.calls += 1
        c.bytes += self.nbytes
        return False


class Recorder:
    """Counters and spans of named regions (the module's docstring); the
    port records into the module's `RECORDER`."""

    def __init__(self, capacity=CAPACITY):
        self._counters = {}
        self._ring = collections.deque(maxlen=capacity)
        self._seq = itertools.count()
        self._local = threading.local()
        self._on = 0

    def _stack(self):
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, nbytes: int = 0):
        """A context manager that counts the region under `name`, with
        `nbytes` (or what is set on it as `.nbytes` inside), and records it
        as a span while tracing is on."""
        counter = self._counters.get(name)
        if counter is None:
            counter = self._counters.setdefault(name, _Counter())
        # the module flag that torch.profiler sets (~30 ns a read)
        if self._on or _autograd_profiler._is_profiler_enabled:
            return _Span(self, counter, name, nbytes)
        counter.nbytes = nbytes
        return counter

    def counters(self) -> dict:
        """{name: {"calls", "ns", "bytes"}} since the last `reset()`."""
        return {name: {"calls": c.calls, "ns": c.ns, "bytes": c.bytes}
                for name, c in list(self._counters.items())}

    def reset(self):
        """Clear the counters and the ring."""
        self._counters = {}
        self._ring.clear()
        self._seq = itertools.count()

    @contextlib.contextmanager
    def recording(self):
        """Record spans inside the region, with or without a profiler."""
        self._on += 1
        try:
            yield self
        finally:
            self._on -= 1

    def spans(self, since_ns: int = 0) -> list:
        """The ring's closed spans that started at or after `since_ns`
        (epoch ns), oldest first: {"name", "start_ns", "end_ns" (epoch
        ns, the profiler's clock), "index", "parent" (an index or None),
        "call" (the root's index), "thread" (native id)}."""
        out = []
        for name, t0, t1, parent, thread, call, offset, index in list(
                self._ring):
            if t1 is not None and t0 + offset >= since_ns:
                out.append({"name": name, "start_ns": t0 + offset,
                            "end_ns": t1 + offset, "index": index,
                            "parent": parent, "call": call,
                            "thread": thread})
        return out

    def dropped(self) -> int:
        """Spans recorded since the last `reset()` that the ring no longer
        holds: those older than its oldest."""
        return self._ring[0][7] if self._ring else 0


RECORDER = Recorder()
span = RECORDER.span
counters = RECORDER.counters
reset = RECORDER.reset
recording = RECORDER.recording
spans = RECORDER.spans
dropped = RECORDER.dropped


def _add_spans(path: Path, rows: list):
    """Write spans into a Chrome trace on its own time base, a row a
    thread."""
    trace = json.loads(path.read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    tids = {}
    events = trace.setdefault("traceEvents", [])
    for s in rows:
        if s["thread"] not in tids:
            tids[s["thread"]] = tid = _SPAN_TID - len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {
                               "name": f"spans (thread {s['thread']})"}})
        events.append({"ph": "X", "cat": "span", "name": s["name"],
                       "pid": pid, "tid": tids[s["thread"]],
                       "ts": (s["start_ns"] - base) / 1e3,
                       "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "args": {"index": s["index"], "parent": s["parent"],
                                "call": s["call"]}})
    path.write_text(json.dumps(trace))


@contextlib.contextmanager
def profiler_trace(logdir=None):
    """Trace the region with `torch.profiler` when a logdir is given: CPU
    activities, and CUDA ones where a card is there, with the recorder's
    spans on; on exit the Chrome trace is written to `logdir/trace.json`
    (Perfetto and chrome://tracing open it), the region's spans on rows
    of their own. Without a logdir a no-op. The profiler's own errors
    propagate. Yields the profiler (None without a logdir)."""
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
    since = time.time_ns()
    with recording(), profile(activities=activities) as prof:
        yield prof
    path = logdir / "trace.json"
    prof.export_chrome_trace(str(path))
    _add_spans(path, spans(since))
