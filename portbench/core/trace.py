"""Spans, and the device trace of a part of the window.

`Spans` times the benchmark's own calls into the program's layers on the
host clock (always on; a few perf_counter reads a call). `WindowTrace`
runs `torch.profiler` over some of the window's calls (`--trace 1`) and
reduces it: the device's busy time (the union of every kernel, copy and
memset interval), the traced window's length, time and launches a kernel
name, each traced call's wall and busy time, and the longest idle gaps
labelled by what the host was doing then.

The traced calls run after the window has closed, so that the profiler's
cost on the card (it slows a graph replay) touches no timed call; a
training run first dispatches one chunk untraced, so that the card is
busy when the trace begins. A trace can come back cut short: the
profiler now and then drops the first device events of a trace (on an
H100, one call of twenty in a trace, or most of them). So, as the
program's `utils/timing.py::kernel_trace` does, each trace begins with
spin kernels (`torch.cuda._sleep`), and is read only when one of them is
in it and every traced call launched the same kernels
(`expected_launches`); a run takes two traces and reads the first
sound one. The profiler also puts the host's ranges (`pb:...`) on the
device's timeline; those are not device work and are left out.
"""

from __future__ import annotations

import bisect
import collections
import sys
import time

import torch

SENTINELS = 64
SENTINEL_KERNEL = "spin_kernel"
WINDOW = "pb:window"
CALL = "pb:call"


class Spans:
    """Durations (s) a span name, on the host clock."""

    def __init__(self):
        self.durations = collections.defaultdict(list)

    def add(self, name, seconds):
        self.durations[name].append(seconds)


class WindowTrace:
    """Profiles the calls run inside `with trace:`; each call wrapped in
    `trace.call()`. `read()` gives the reduction, or raises ValueError
    when the trace was cut short."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.calls = 0

    def __enter__(self):
        self.prof.__enter__()
        for _ in range(SENTINELS):
            torch.cuda._sleep(0)
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        self.t0 = time.perf_counter()
        return self

    def call(self):
        self.calls += 1
        return torch.profiler.record_function(CALL)

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.host_s = time.perf_counter() - self.t0
        self._window.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def read(self, expected_launches=None, top=10) -> dict:
        """{busy_s, window_s, kernels {name: (launches, s)}, calls [(wall
        s, busy s)], device_ops [[name, s]], idle_gaps [[name, s]]}.
        `expected_launches` {kernel substring: launches a call} is held
        to the trace."""
        device, cpu = [], []
        for e in self.prof.events():
            span = (e.time_range.start, e.time_range.end)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not e.name.startswith("pb:"):
                    device.append((*span, e.name))
            else:
                cpu.append((*span, e.name, e.thread))
        sentinels = sum(SENTINEL_KERNEL in n for *_, n in device)
        window = [c for c in cpu if c[2] == WINDOW]
        calls = sorted(c[:2] for c in cpu if c[2] == CALL)
        if not sentinels or not window or len(calls) != self.calls:
            raise ValueError(f"trace cut short: {sentinels} of {SENTINELS} "
                             f"spin kernels, {len(calls)} of {self.calls} "
                             f"calls")
        w0, w1, _, main = window[0]
        cpu = [c[:3] for c in cpu if c[3] == main]
        device = sorted(d for d in device if d[0] >= w0 and d[1] <= w1
                        and SENTINEL_KERNEL not in d[2])
        kernels = collections.defaultdict(lambda: [0, 0.0])
        for s, e, n in device:
            kernels[n][0] += 1
            kernels[n][1] += (e - s) * 1e-6
        for sub, per_call in (expected_launches or {}).items():
            got = sum(c for n, (c, _) in kernels.items() if sub in n)
            if got != per_call * self.calls:
                raise ValueError(f"trace cut short: {got} launches of {sub}, "
                                 f"{per_call * self.calls} expected")
        busy = _merge([d[:2] for d in device])
        gaps = _gaps(busy, w0, w1)
        out = {
            "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6,
            "host_window_s": self.host_s,
            "kernels": {n: tuple(v) for n, v in kernels.items()},
            "calls": [((e - s) * 1e-6, _covered(busy, s, e) * 1e-6)
                      for s, e in calls],
            "device_ops": [[n, v[1]] for n, v in sorted(
                kernels.items(), key=lambda kv: -kv[1][1])[:top]],
        }
        labelled = collections.defaultdict(float)
        inner = sorted((c for c in cpu if c[2] != WINDOW), key=lambda c: c[0])
        starts = [c[0] for c in inner]
        for s, e in gaps:
            labelled[_host_at(inner, starts, s)] += (e - s) * 1e-6
        out["idle_gaps"] = [[n, v] for n, v in sorted(
            labelled.items(), key=lambda kv: -kv[1])[:top]]
        return out


def first_sound(traces, expected_launches=None):
    """The reduction of the first of `traces` that is sound, or None."""
    for t in traces:
        try:
            return t.read(expected_launches)
        except ValueError as e:
            print(f"portbench: {e}; reading the next trace", file=sys.stderr)
    return None


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _gaps(busy, w0, w1):
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def _covered(busy, s, e):
    return sum(max(0, min(e, b) - max(s, a)) for a, b in busy)


def _host_at(inner, starts, t):
    """The innermost host event running at time t (the latest-starting
    one of the 2000 before t that covers it), or "host (no op)"."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 2000, -1), -1):
        if inner[j][1] > t:
            return inner[j][2]
    return "host (no op)"
