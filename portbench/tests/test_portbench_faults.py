"""The check fails what it must: whole runs of each cell (cut to a CPU
size, the look for a card skipped) with the timed path broken
underneath come out not correct, once for each fault the cell can have;
a sound run comes out correct. The faults, planted in the program's
objects the run drives:

- training: a step that returns its state unchanged; half of each batch
  left out, the mean taken over the rest; one leaf's update applied
  twice (an answer altered where it is produced); every step of a chunk
  on the chunk's first batch (a graph whose steps select the wrong
  rows); each image's labels paired with the next image's (a gather that
  mixes up the rows);
- serving: half of each call's images answered with nothing; every
  detection's class moved by one (an answer altered where it is
  produced).
There is no exchange between cards to leave out: every cell runs on one.

The controls (the next lower precision in the program's place) are
read at the cells' own sizes on the card (`tools/readings.py`, and
`test_control_fails_at_the_cells_size` below, which skips without one).
"""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.tests.conftest import tiny

SEED = 2 ** 33 + 11


def _run(cell, hooks=None, device="cpu", seconds=0.5):
    ok, result, rows, _ = run.run_cell(cell, SEED, seconds, False, device,
                                    lambda: 0.0, hooks)
    return ok, {k: v for k, v, _ in rows}


class Unchanged:
    """Every step leaves the model and Adam's state as they were."""

    def trainer(self, trainer):
        def steps(state, *chunk):
            params = [p.detach().clone() for p in state.model.parameters()]
            opt = state.optimizer.state
            before = {p: {k: v.clone() for k, v in s.items()}
                      for p, s in opt.items()}
            state, metrics = trainer(state, *chunk)
            with torch.no_grad():
                for p, saved in zip(state.model.parameters(), params):
                    p.copy_(saved)
                for p in list(opt):
                    if p not in before:
                        del opt[p]
                    else:
                        for k, v in before[p].items():
                            opt[p][k].copy_(v)
            return state, metrics
        return steps


class HalfBatch:
    """Each step trains on the first half of its batch."""

    def trainer(self, trainer):
        def steps(state, images, labels, counts):
            half = images.shape[1] // 2
            return trainer(state, images[:, :half], labels[:, :half],
                           counts[:, :half])
        return steps

    def predictor(self, pred, **_):
        def call(frames):
            lists = pred(frames)
            half = len(lists) // 2
            return lists[:half] + [[] for _ in lists[half:]]
        return call


class Altered:
    """Training: the largest leaf's update applied twice. Serving: every
    detection's class moved by one."""

    def trainer(self, trainer):
        def steps(state, *chunk):
            p = max(state.model.parameters(), key=lambda t: t.numel())
            before = p.detach().clone()
            state, metrics = trainer(state, *chunk)
            with torch.no_grad():
                p.add_(p - before)
            return state, metrics
        return steps

    def predictor(self, pred, cell, **_):
        nc = cell["config"]["num_classes"]

        def call(frames):
            return [[(*d[:5], (d[5] + 1) % nc) for d in lists]
                    for lists in pred(frames)]
        return call


class FirstBatch:
    """Every step of a chunk trains on the chunk's first step's batch."""

    def trainer(self, trainer):
        def steps(state, *chunk):
            return trainer(state, *(t[:1].expand_as(t).contiguous()
                                    for t in chunk))
        return steps


class Misplaced:
    """Each image's labels and count are the next image's of its step."""

    def trainer(self, trainer):
        def steps(state, images, labels, counts):
            return trainer(state, images, labels.roll(1, dims=1),
                           counts.roll(1, dims=1))
        return steps


TRAIN = ["s-train-stream-b64", "l-train-stream-b24"]
SERVE = ["l-serve-b32", "l-serve-b32-int8"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_a_sound_run_is_correct(cell, tiny_cells):
    ok, numbers = _run(cell)
    assert ok, numbers


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [Unchanged, HalfBatch, Altered, FirstBatch,
                                   Misplaced], ids=lambda f: f.__name__)
def test_a_training_fault_is_not_correct(cell, fault, tiny_cells):
    ok, numbers = _run(cell, fault())
    assert not ok, numbers


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("fault", [HalfBatch, Altered],
                         ids=lambda f: f.__name__)
def test_a_serving_fault_is_not_correct(cell, fault, tiny_cells):
    ok, numbers = _run(cell, fault())
    assert not ok, numbers


@pytest.mark.card
@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_control_fails_at_the_cells_size(cell, card):
    """The control of each cell, one seed at the cell's own size: its
    numbers against the cell's limits come out not correct."""
    from portbench.core import check, registry
    from portbench.tools import readings

    full = registry.workload(cell)
    fn = (readings.train_readings if full["mix"]["kind"] == "train"
          else readings.serve_readings)
    control = fn(full, SEED, card)["control"]
    ok, _ = check.judge(control, full["limits"])
    assert not ok, control
