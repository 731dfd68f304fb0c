"""The training cells: the program's `--stream` trainer, as its CLI builds
it (`cli.py`, `--stream`): `data/stream.py::ChunkStream` over the image
cache feeding `train/steps.py::make_train_step_multi_compact`, N steps a
chunk (one CUDA graph replay on the card), Adam with the global-norm clip
at a constant learning rate.

Set-up builds the training state from the benchmark's weights and the
window's own stream (shuffled, N steps a chunk), and runs the stream's
first chunk through the same trainer object: that call captures the
graph that the window replays and trains its N steps. The check's
readings come from that chunk: its mean loss, the parameters' change,
which rows of the cache it held (found by each image's first pixels),
and the gradients Adam took at each of its steps, which `GradProbe`
copies out of the optimizer (on the card its copies are part of the
captured graph, so every replay of the window makes them too). The
window then times whole chunks from the first dispatch to the last
synchronize. With `--trace 1` two traces of `trace.count` chunks follow
the window, each after one untraced chunk.

Then the state is freed and the reference follows the chunk step by step
in float32 (`follow`): at each step it works out the gradient at the
program's parameters on the step's rows of its own copy of the cache and
compares it with the program's; it then takes its own Adam step with the
program's gradient, which gives it the program's next parameters. Its
parameters after the chunk hold the program's update to Adam's
arithmetic. Following the program's own trajectory is what makes a step
after the first comparable: two trajectories at this learning rate part
within a few steps (bfloat16 and fp8 then read alike against float32).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.core import check, traffic
from portbench.core.common import port_config, stage, tf32_off
from portbench.core.roofline import conv_flops
from portbench.core.trace import Spans, WindowTrace, first_sound
from portbench.core.weights import make_state_dict
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train

TRACES = 2
PRINT_PX = 6  # pixels of an image's first row that identify its cache row


class Chunks:
    """Chunks of a ChunkStream across epochs; `close()` stops its
    thread."""

    def __init__(self, stream):
        self.stream, self.it = stream, iter(stream)

    def next(self):
        try:
            return next(self.it)
        except StopIteration:
            self.it = iter(self.stream)
            return next(self.it)

    def close(self):
        self.it.close()


class GradProbe:
    """The gradients Adam takes at each step of the first chunk: an
    optimizer step pre-hook copies every parameter's gradient into slot i
    at the chunk's i-th step. On the card the copies are recorded into the
    chunk's graph as it is captured (the warm-up step before the capture
    is not recorded), so the slots must live as long as the graph; on the
    CPU the steps run eagerly and `take` stops the recording."""

    def __init__(self, model, optimizer, steps: int):
        self.params = list(model.named_parameters())
        self.slots = [[torch.zeros_like(p) for _, p in self.params]
                      for _ in range(steps)]
        self.cuda = self.params[0][1].is_cuda
        self.count, self.armed = 0, True
        self.handle = optimizer.register_step_pre_hook(self._hook)

    @torch.no_grad()
    def _hook(self, optimizer, args, kwargs):
        if not self.armed or self.count == len(self.slots):
            return
        if self.cuda and not torch.cuda.is_current_stream_capturing():
            return
        for dst, (_, p) in zip(self.slots[self.count], self.params):
            if p.grad is None:
                dst.zero_()
            else:
                dst.copy_(p.grad)
        self.count += 1

    def take(self):
        """[{leaf: gradient} a step] on the host, or None unless every
        step was recorded."""
        self.armed = False
        self.handle.remove()
        if self.count != len(self.slots):
            return None
        return [{k: t.cpu() for (k, _), t in zip(self.params, slot)}
                for slot in self.slots]


def _prints(images) -> list:
    """Each image's first `PRINT_PX` pixels as bytes; `images` (..., S, S,
    3) uint8, a tensor or an array."""
    head = images[..., 0, :PRINT_PX, :]
    if isinstance(head, torch.Tensor):
        head = head.cpu().numpy()
    head = np.ascontiguousarray(head).reshape(-1, PRINT_PX * 3)
    return [r.tobytes() for r in head]


def chunk_rows(images, cache) -> np.ndarray:
    """(N * B,) the cache row of each image of a chunk (N, B, S, S, 3), in
    step order; -1 where an image is no row of the cache."""
    where = {k: i for i, k in enumerate(_prints(cache.images))}
    return np.array([where.get(k, -1) for k in _prints(images)], np.int64)


def first_chunk(cell, seed, device, hooks=None):
    """(state, trainer, chunks, cache, p0, probe, readings) after the
    window's stream's first chunk went through the trainer. `probe` keeps
    the memory the graph copies into; free it with the trainer."""
    from yolo_from_scratch_tpu_torch.data.stream import ChunkStream
    from yolo_from_scratch_tpu_torch.models.yolo import YOLO
    from yolo_from_scratch_tpu_torch.train.steps import (
        TrainState,
        make_optimizer,
        make_train_step_multi_compact,
    )

    cfg, mix = cell["config"], cell["mix"]
    p0 = make_state_dict(cfg, seed, device)
    cache = traffic.train_cache(mix, cfg["img_size"], seed, device)
    model = YOLO(port_config(cfg), device="meta")
    model.load_state_dict({k: v.clone() for k, v in p0.items()}, strict=True,
                          assign=True)
    state = TrainState(model, make_optimizer(
        model.parameters(), mix["learning_rate"],
        capturable=torch.device(device).type == "cuda"))
    probe = GradProbe(model, state.optimizer, mix["steps_per_chunk"])
    trainer = make_train_step_multi_compact(port_config(cfg), False, device)
    if hooks is not None:
        trainer = hooks.trainer(trainer)
    chunks = Chunks(ChunkStream(cache, batch_size=cell["batch"],
                                steps_per_chunk=mix["steps_per_chunk"],
                                shuffle=True, seed=seed, device=device))
    item = chunks.next()
    rows = chunk_rows(item[0], cache)
    state, metrics = trainer(state, *item)
    readings = {"loss": float(metrics["loss"]), "rows": rows,
                "grads": probe.take(),
                "change": {k: (p.detach() - p0[k]).cpu()
                           for k, p in model.named_parameters()}}
    return state, trainer, chunks, cache, p0, probe, readings


def reference_grad(cell, theta, p0, cache, rows, device, num=None):
    """(loss, {leaf: clipped gradient}) of the reference at parameters
    `theta` (the rest of the state from `p0`) on the cache's `rows`."""
    cfg = cell["config"]
    size, nc = cfg["img_size"], cfg["num_classes"]
    leaves = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
    x = ref_model.normalize(torch.from_numpy(cache.images[rows]).to(device))
    targets = [torch.from_numpy(t).to(device) for t in ref_train.assign(
        cache.labels[rows], cache.counts[rows], size, nc)]
    total = ref_train.loss(ref_model.forward(dict(p0, **leaves), cfg, x, True,
                                             num), targets, size)
    grads = torch.autograd.grad(total, list(leaves.values()))
    return float(total.detach()), ref_train.clip(dict(zip(leaves, grads)))


def follow(cell, cache, p0, prog, device, others=None) -> dict:
    """The reference following the program's first chunk step by step
    (module docstring). `others`: {name: (numerics, rows -> rows)}, more
    reference gradients worked out at the same parameters and compared
    with the float32 one as the program's is (the control, a fault).
    Returns {"program": numbers, name: numbers}."""
    rows = prog["rows"].reshape(cell["mix"]["steps_per_chunk"], -1)
    others = others or {}
    theta = {k: v.clone() for k, v in p0.items() if ref_model.is_param(k)}
    adam = ref_train.Adam(theta, cell["mix"]["learning_rate"])
    steps = {name: [] for name in ("program", *others)}
    losses = {name: [] for name in ("program", *others)}
    ref_losses = []
    for batch, g_prog in zip(rows, prog["grads"]):
        loss, g_ref = reference_grad(cell, theta, p0, cache, batch, device)
        ref_losses.append(loss)
        steps["program"].append(check.grad_step(g_prog, g_ref))
        for name, (num, pick) in others.items():
            loss_o, g_o = reference_grad(cell, theta, p0, cache, pick(batch),
                                         device, num)
            losses[name].append(loss_o)
            steps[name].append(check.grad_step(g_o, g_ref))
            del g_o
        del g_ref
        adam.step({k: g.to(device) for k, g in g_prog.items()})
    change = {k: v - p0[k] for k, v in theta.items()}
    ref_loss = float(np.mean(ref_losses))
    out = {"program": check.train_numbers(
        prog["loss"], ref_loss, steps["program"], prog["change"], change)}
    for name in others:
        # the reference's own Adam stands in for the other's: no step gap
        out[name] = check.train_numbers(float(np.mean(losses[name])),
                                        ref_loss, steps[name], change, change)
    out["details"] = {"steps": [s["worst"] for s in steps["program"]],
                      "change": check.change_details(prog["change"], change,
                                                     steps["program"][0])}
    return out


def run(cell, seed, seconds, traced, device, clock, hooks=None):
    """One run of a training cell; returns its outcome dict."""
    cuda = torch.device(device).type == "cuda"
    mix, b = cell["mix"], cell["batch"]
    n = mix["steps_per_chunk"]
    state, trainer, chunks, cache, p0, probe, prog = first_chunk(
        cell, seed, device, hooks)
    spans = Spans()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    gc.collect()
    setup_s = clock()
    stage(clock, "first chunk")
    done, item = 0, None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        item = chunks.next()
        spans.add("stream.next", time.perf_counter() - t)
        state, _ = trainer(state, *item)
        done += 1
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    traces = []
    for _ in range(TRACES if traced else 0):
        state, _ = trainer(state, *chunks.next())
        with WindowTrace() as tracer:
            for _ in range(cell["trace"]["count"]):
                with tracer.call():
                    state, _ = trainer(state, *chunks.next())
        traces.append(tracer)
    chunks.close()
    del state, trainer, chunks, item, probe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rows = prog["rows"]
    numbers = {"rows_unmatched": int((rows < 0).sum()
                                     + len(rows) - len(set(rows.tolist())))}
    if numbers["rows_unmatched"] == 0 and prog["grads"] is not None:
        with tf32_off():
            numbers.update(follow(cell, cache, p0, prog, device)["program"])
    images = done * n * b
    return {
        "setup_s": setup_s,
        "e2e": {"train_img_s": images / window_s},
        "attempted": images, "failed": 0,
        "memory_peak_bytes": peak,
        "numbers": numbers,
        "trace": first_sound(traces),
        "record": {"window_s": window_s, "images": images,
                   "img_s": images / window_s, "chunks": done,
                   "spans": spans.durations,
                   "flops_per_img": 3 * conv_flops(cell["config"]),
                   "dtype": cell["precision"]},
    }
