"""`utils/timing.py::kernel_ms` on the CPU, with a stand-in profiler: a
trace without device time, or cut short, is taken again, and a timing
never reads 0 ms or a part of its calls.

The real profiler needs the card; here `torch.profiler.profile`,
`torch.cuda.synchronize` and `torch.cuda._sleep` are replaced, so only
the retry logic runs.
"""

import collections
import types

import pytest
import torch

from yolo_from_scratch_tpu_torch.utils import timing

SPIN = f"at::cuda::(anonymous namespace)::{timing.SENTINEL_KERNEL}(long)"


def _event(key, us, count=4, device=True):
    kind = torch.autograd.DeviceType
    return types.SimpleNamespace(
        key=key, self_device_time_total=us, count=count,
        device_type=kind.CUDA if device else kind.CPU)


def _spin(count=timing.TRACE_SENTINELS):
    """The sentinels' events, as many as the trace kept."""
    return _event(SPIN, 2.0 * count, count=count)


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
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(timing, "RETRY_PAUSE_S", 0.0)
    return calls


@pytest.mark.parametrize("empty_traces", [0, 1, timing.TRACE_ATTEMPTS - 1])
def test_kernel_ms_retakes_a_trace_without_device_time(monkeypatch,
                                                       empty_traces):
    good = [_spin(), _event("k", 3000.0),
            _event("cpu op", 9000.0, device=False)]
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
                           [[_spin(), _event("k", 0.0)]]
                           * timing.TRACE_ATTEMPTS)
    with pytest.raises(RuntimeError, match="no device time"):
        timer()
    assert len(calls) == timing.TRACE_ATTEMPTS


@pytest.mark.parametrize("short", [
    # the profiler dropped the trace's first events, its sentinels: the
    # calls' counts alone cannot tell
    [_event("q1", 400.0, count=8), _event("q2", 600.0, count=4)],
    # a kernel seen fewer times than a multiple of the calls
    [_spin(1), _event("q1", 300.0, count=6), _event("q2", 450.0, count=3)],
])
@pytest.mark.parametrize("short_traces", [1, timing.TRACE_ATTEMPTS - 1])
def test_kernel_ms_retakes_a_trace_cut_short(monkeypatch, short_traces,
                                             short):
    """A cut trace is not read; a whole one is, without its sentinels:
    two kernels a call in full and one of them twice a call."""
    good = [_spin(), _event("q1", 400.0, count=8), _event("q2", 600.0)]
    calls = _fake_profiler(monkeypatch, [short] * short_traces + [good])
    assert timing.kernel_ms(lambda: None, 4) == {"q1": 0.4, "q2": 0.6}
    assert len(calls) == short_traces + 1


def test_a_timing_whose_traces_are_all_cut_short_raises(monkeypatch):
    """Six traces without a sentinel, the last of 64 x 2^5 of them."""
    calls = _fake_profiler(monkeypatch, [[_event("conv", 6.5, count=20)]]
                           * timing.TRACE_ATTEMPTS)
    last = timing.TRACE_SENTINELS << (timing.TRACE_ATTEMPTS - 1)
    assert last == 2048
    with pytest.raises(RuntimeError,
                       match=rf"cut short \(0 of {last} sentinels"):
        timing.kernel_ms(lambda: None, 20)
    assert len(calls) == timing.TRACE_ATTEMPTS


def test_each_trace_taken_again_has_twice_the_sentinels(monkeypatch):
    """A profiler that drops the first events of every trace drops the
    sentinels first: each trace taken again opens with twice as many."""
    good = [_spin(), _event("k", 100.0, count=2)]
    calls = _fake_profiler(monkeypatch, [[_event("k", 100.0, count=2)]] * 3
                           + [good])
    spins = collections.Counter()  # sentinels launched, by trace
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: spins.update([len(calls)]))
    assert timing.kernel_ms(lambda: None, 2) == {"k": 0.1}
    assert [spins[t] for t in range(1, 5)] == [64, 128, 256, 512]


def test_a_trace_opens_with_its_sentinels(monkeypatch):
    """Inside the profiler's window the sentinels come before the first
    call, and the card is synchronized after the last."""
    seen = []

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            seen.append("open")
            return self

        def __exit__(self, *exc):
            seen.append("close")
            return False

        def key_averages(self):
            return [_spin(), _event("k", 100.0, count=2)]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: seen.append("sync"))
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: seen.append(cycles))
    assert timing.kernel_ms(lambda: seen.append("call"), 2) == {"k": 0.1}
    assert seen == (["sync", "open"] + [0] * timing.TRACE_SENTINELS
                    + ["call", "call", "sync", "close"])


def test_kernel_trace_gives_launches_and_times(monkeypatch):
    """A whole trace's launch counts and times, without its sentinels (what
    the smoke script's launch counters read); a trace that lost its
    sentinels is taken again."""
    calls = _fake_profiler(monkeypatch, [
        [_event("q1", 400.0, count=8)],
        [_spin(), _event("q1", 400.0, count=8), _event("q2", 600.0)]])
    assert timing.kernel_trace(lambda: None, 4) == {"q1": (8, 0.4),
                                                    "q2": (4, 0.6)}
    assert len(calls) == 2
