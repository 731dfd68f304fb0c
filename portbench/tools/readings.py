"""The readings that a cell's limits are set from, at the cell's own sizes,
one process for many seeds (`--seeds 1,2,3`):

- program: the numbers of the cell's check, as a run takes them (the
  training check's first chunk through the program's trainer; a serving
  run's sampled calls through the program's predictor), against the
  reference;
- control: the same numbers of the next lower precision against the
  reference: for training the reference itself on fp8 operands
  (`reference/model.py::Fp8Numerics`) in the program's place, on the
  program's first chunk's rows; for the bf16 serving cell the program's
  own int8 path; for the int8 serving cell the reference's int4
  arithmetic in the program's place;
- fault (training): the reference with half of each step's batch left
  out (the mean over the rest);
- details (training): each step's two worst leaves of the gradient (leaf,
  size, gap, program and reference norms over the median leaf's, the
  share of elements of another sign) and the worst leaves of the
  change.

    python3 portbench/tools/readings.py --workload <cell> --seeds 1,2,3 \
        [--full 4]

Prints one JSON line a seed and reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from portbench.core import check, registry  # noqa: E402
from portbench.core.common import tf32_off  # noqa: E402
from portbench.core import serve as S  # noqa: E402
from portbench.core import train as T  # noqa: E402
from portbench.reference.model import Fp8Numerics  # noqa: E402


def half_batch(rows):
    """The first half of a step's rows."""
    return rows[:len(rows) // 2]


def train_readings(cell, seed, device, full=True):
    """The program's numbers; with `full` also the control's and the
    half-batch fault's, each worked out at the program's parameters of
    every step of its first chunk, on the chunk's own rows."""
    state, trainer, chunks, cache, p0, probe, prog = T.first_chunk(
        cell, seed, device)
    chunks.close()
    del state, trainer, chunks, probe
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    rows = prog["rows"]
    assert (rows >= 0).all() and len(set(rows.tolist())) == len(rows)
    assert prog["grads"] is not None, "the probe missed a step"
    others = ({"control": (Fp8Numerics(), lambda r: r),
               "half_batch": (None, half_batch)} if full else {})
    with tf32_off():
        out = T.follow(cell, cache, p0, prog, device, others)
    for name in ("program", *others):
        out[name] = dict(out[name], rows_unmatched=0)
    return out


class _RefServer:
    """The reference's int4 arithmetic served in the program's place."""

    def __init__(self, cell, p, calib, device):
        self.cell, self.p, self.device = cell, p, device
        self.num = S.reference_numerics(cell, p, calib, device, bits=4)

    def __call__(self, frames):
        return [d.tolist() for d, _ in S.reference_lists(
            self.cell, self.p, frames, self.device, self.num)]


def serve_readings(cell, seed, device):
    mix = cell["mix"]
    p, pool, sched, calib = S.build(cell, seed, device)
    warm = mix["warmup_calls"]
    calls = [[pool[j] for j in sched.call(warm + i)]
             for i in sorted(S.sample_calls(cell, seed))]
    frames = [f for c in calls for f in c]

    def served(fn):
        for i in range(warm if not isinstance(fn, _RefServer) else 0):
            fn([pool[j] for j in sched.call(i)])
        return [lists for c in calls for lists in fn(c)]

    pred = S.predictor(cell, p, calib, device)
    prog = served(pred)
    int8 = cell["precision"] == "int8"
    del pred
    control_fn = (_RefServer(cell, p, calib, device) if int8 else
                  S.predictor(cell, p, calib, device, int8=True))
    with tf32_off():
        control = served(control_fn)
        del control_fn
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        ref = S.reference_lists(cell, p, frames, device,
                                S.reference_numerics(cell, p, calib, device))
    return {"program": S.numbers(cell, prog, ref),
            "control": S.numbers(cell, control, ref)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", type=int, default=1000,
                    help="training: read the control and the fault on the "
                    "first this many seeds only")
    args = ap.parse_args(argv)
    cell = registry.workload(args.workload)
    fn = train_readings if cell["mix"]["kind"] == "train" else serve_readings
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = (fn(cell, seed, args.device, i < args.full)
               if fn is train_readings else fn(cell, seed, args.device))
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
