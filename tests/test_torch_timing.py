"""`utils/timing.py::kernel_ms` on the CPU, with a stand-in profiler: a
trace without device time is taken again, and a timing never reads 0 ms.

The real profiler needs the card; here `torch.profiler.profile` and
`torch.cuda.synchronize` are replaced, so only the retry logic runs.
"""

import types

import pytest
import torch

from yolo_from_scratch_tpu_torch.utils import timing


def _event(key, us, device=True):
    kind = torch.autograd.DeviceType
    return types.SimpleNamespace(
        key=key, self_device_time_total=us,
        device_type=kind.CUDA if device else kind.CPU)


def _fake_profiler(monkeypatch, traces):
    """Each `profile(...)` hands out the next list of events in `traces`;
    returns the list of calls fn saw per trace."""
    calls = []

    class Profile:
        def __init__(self, activities):
            self.events = traces[len(calls)]

        def __enter__(self):
            calls.append(0)
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(timing, "RETRY_PAUSE_S", 0.0)
    return calls


@pytest.mark.parametrize("empty_traces", [0, 1, timing.TRACE_ATTEMPTS - 1])
def test_kernel_ms_retakes_a_trace_without_device_time(monkeypatch,
                                                       empty_traces):
    good = [_event("k", 3000.0), _event("cpu op", 9000.0, device=False)]
    empty = [_event("cpu op", 9000.0, device=False)]
    calls = _fake_profiler(monkeypatch, [empty] * empty_traces + [good])

    def fn():
        calls[-1] += 1

    assert timing.kernel_ms(fn, 4) == {"k": 3.0}
    assert calls == [4] * (empty_traces + 1)


@pytest.mark.parametrize("timer", [
    lambda: timing.kernel_ms(lambda: None, 2),
    lambda: timing.device_ms(lambda: None, runs=2, warmup=0)])
def test_a_timing_without_device_time_raises(monkeypatch, timer):
    calls = _fake_profiler(monkeypatch,
                           [[_event("k", 0.0)]] * timing.TRACE_ATTEMPTS)
    with pytest.raises(RuntimeError, match="no device time"):
        timer()
    assert len(calls) == timing.TRACE_ATTEMPTS
