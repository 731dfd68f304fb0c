"""Test settings of the benchmark's own tests (`pytest portbench/tests`):
the `card` marker, for tests that need a CUDA card, and the tiny cells
that the CPU tests run."""

from __future__ import annotations

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (decided "
        "inside the test)")


@pytest.fixture
def card():
    """The card's device name; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny(cell: dict) -> dict:
    """A cell cut to a size a CPU test holds: width 0.25 and depth 0.33
    at 64 px in float32, four images a batch, two-step chunks, 16 frames
    of 48 x 64 and 64 x 48 with 256 candidates and 50 detections an
    image. (At depth 1.0 and 64 px a P5 grid of 2 x 2 leaves BatchNorm
    statistics of 8 frames that saturate the heads on other frames.)"""
    cell = dict(cell, batch=4)
    cell["config"] = dict(cell["config"], width_mult=0.25, depth_mult=0.33,
                          img_size=64, compute_dtype="float32")
    if cell["mix"]["kind"] == "train":
        cell["mix"] = dict(cell["mix"], images=32, steps_per_chunk=2)
    else:
        cell["mix"] = dict(cell["mix"], pool=16,
                           frame_shapes=[[48, 64], [64, 48]], topk=256,
                           max_outputs=50, check_top=20, sample_from=4,
                           check_calls=2, schedule_calls=16)
    return cell


@pytest.fixture
def tiny_cells(monkeypatch):
    """Every cell read through the registry comes back `tiny`."""
    from portbench.core import registry

    full = registry.workload
    monkeypatch.setattr(registry, "workload", lambda name: tiny(full(name)))
    return full
