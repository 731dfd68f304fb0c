"""CUDA graphs of training steps: the port's counterpart of the JAX
package's one jitted program for N scanned steps (`train/steps.py`'s
`make_train_step_multi*`). This module has no JAX counterpart.

`capture(run, warmup, model, optimizer, *others)` records `run()` (N
optimizer steps that read only static tensors and the training state) as
one `torch.cuda.CUDAGraph`, which the caller replays:

- Warm-up: `warmup()` runs first on a side stream. It builds the kernel
  library, cuDNN's plans and the optimizer's lazily created state. It
  must not change the training state, so the parameters, buffers,
  optimizer state and learning-rate tensors, and those of `others` (an
  EMA model), are snapshotted before it and copied back into the same
  tensors after it (`Snapshot`); optimizer state that the warm-up created
  is zeroed, which is Adam's fresh state. The graph then reads and writes
  exactly those tensors (`addresses` lists them, so that a caller can
  tell when they were replaced).
- Capture runs with `torch.backends.cudnn.benchmark` off, in the
  thread-local error mode (background threads that stage the next chunk
  may call the CUDA API meanwhile). The optimizer must be capturable
  (its step count and learning rate on the card).
- Failure: any error during capture raises RuntimeError naming the line
  of the port where the failing operator was called; nothing falls back
  to eager steps.

Kernel launch counters (`ops/conv_bwd.py::launches`,
`ops/nms_cuda.py::launches`) count Python calls of their wrappers: a
captured launch is counted once, at capture, and never at a replay.
"""

from __future__ import annotations

import traceback
from pathlib import Path

import torch

from yolo_from_scratch_tpu_torch.utils.metrics_log import span


def _state_tensors(model, optimizer, *others):
    """The training state's tensors apart from the optimizer's per-parameter
    state: parameters and buffers, the optimizer's group tensors (a
    capturable optimizer's learning rate), and the parameters and buffers
    of `others`."""
    tensors = [*model.parameters(), *model.buffers()]
    tensors += [v for g in optimizer.param_groups for k, v in g.items()
                if k != "params" and torch.is_tensor(v)]
    for m in others:
        tensors += [*m.parameters(), *m.buffers()]
    return tensors


def addresses(model, optimizer, *others) -> tuple:
    """The addresses of every tensor a graph of training steps reads from
    the training state: `_state_tensors` and the optimizer's state."""
    tensors = _state_tensors(model, optimizer, *others)
    for p in model.parameters():
        tensors += [v for v in optimizer.state.get(p, {}).values()
                    if torch.is_tensor(v)]
    return tuple(t.data_ptr() for t in tensors)


class Snapshot:
    """Clones of a model's parameters and buffers, of its optimizer's
    state and group tensors (the learning rate), and of the parameters and
    buffers of `others` (an EMA model); `restore()` copies them back into
    the same tensors and zeroes optimizer state created since (Adam's and
    AdamW's fresh state: step 0, zero moments)."""

    def __init__(self, model, optimizer, *others):
        self.optimizer = optimizer
        self.tensors = _state_tensors(model, optimizer, *others)
        with torch.no_grad():
            self.saved = [t.detach().clone() for t in self.tensors]
            self.opt = {p: {k: v.clone() for k, v in s.items()
                            if torch.is_tensor(v)}
                        for p, s in optimizer.state.items()}

    @torch.no_grad()
    def restore(self):
        for t, s in zip(self.tensors, self.saved):
            t.copy_(s)
        for p, state in self.optimizer.state.items():
            saved = self.opt.get(p)
            for k, v in state.items():
                if not torch.is_tensor(v):
                    continue
                if saved is None:
                    v.zero_()
                else:
                    v.copy_(saved[k])


def _failed_at(exc) -> str:
    """The innermost line of the port in an exception's traceback: where
    the operator that broke the capture was called."""
    package = Path(__file__).resolve().parents[1]
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if Path(f.filename).resolve().is_relative_to(package)
              and Path(f.filename).name != "graphs.py"]
    if not frames:
        return "the end of the capture (an operator left it invalid)"
    f = frames[-1]
    return (f"{Path(f.filename).relative_to(package.parent)}:{f.lineno} "
            f"`{f.line}`")


def capture(run, warmup, model, optimizer, *others) -> torch.cuda.CUDAGraph:
    """Capture `run()` as a CUDA graph after `warmup()` on a side stream;
    the training state (and `others`, an EMA model) is as it was before
    the warm-up when this returns. Raises RuntimeError if the optimizer is
    not capturable or the capture fails. The span `graph.capture` times
    the warm-up and the capture."""
    if not all(g.get("capturable") for g in optimizer.param_groups):
        raise RuntimeError("a CUDA graph of training steps needs a "
                           "capturable optimizer (make_optimizer(..., "
                           "capturable=True))")
    with span("graph.capture"):
        snapshot = Snapshot(model, optimizer, *others)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warmup()
        torch.cuda.current_stream().wait_stream(side)
        snapshot.restore()
        optimizer.zero_grad(set_to_none=True)

        graph = torch.cuda.CUDAGraph()
        benchmark = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = False
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                run()
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture failed at "
                               f"{_failed_at(e)}: {e}") from e
        finally:
            torch.backends.cudnn.benchmark = benchmark
        return graph
