"""The program's own span counters (`yolo_from_scratch_tpu_torch/utils/
metrics_log.py::counters`), read after a traced run in the run's process.
A program without them (one older than its span recorder) reads None, as
does a run without a trace."""

from __future__ import annotations


def program_counters(run):
    """{span name: {"calls", "ns", "bytes"}}, or None."""
    if run["trace"] is None:
        return None
    try:
        from yolo_from_scratch_tpu_torch.utils.metrics_log import counters
    except ImportError:
        return None
    return counters()


def mean_ms(run, name, per=None):
    """Time inside span `name`, ms a call of span `per` (its own calls
    without one); None where either is not there."""
    c = program_counters(run)
    if not c or name not in c:
        return None
    calls = c.get(per or name, {}).get("calls", 0)
    return c[name]["ns"] / 1e6 / calls if calls else None


def total_s(run, name):
    """Time inside span `name`, s in all (0 where it never ran)."""
    c = program_counters(run)
    return None if c is None else c.get(name, {}).get("ns", 0) / 1e9


def gb_s(run, name):
    """Bytes over time inside span `name`, GB/s."""
    c = program_counters(run)
    if not c or not c.get(name, {}).get("ns"):
        return None
    return c[name]["bytes"] / c[name]["ns"]
