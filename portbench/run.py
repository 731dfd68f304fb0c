"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One process a run: set-up (weights, inputs, the program's state, warm-up:
`setup_s`, from the process's start to the first timed call), a window
of `--seconds`, then the check against the plain reference. The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`, each compared number with its limit; the same numbers
end standard error. Exits 1 without a result when no card (or fewer than
the cell asks for) is present, and 3 when the process has loaded JAX or
the JAX package.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

_T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "yolo_from_scratch_tpu")


def _process_age() -> float:
    """Seconds since this process started (/proc), or 0 where unknown."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, float(Path("/proc/uptime").read_text().split()[0])
                   - start)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE = _process_age()


def since_start() -> float:
    """Seconds since the process started."""
    return _AGE + time.perf_counter() - _T0


def _cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name, seed, seconds, traced, device, clock, hooks=None):
    """(correct, result dict without `device`'s card fields, check rows,
    every number the check worked out) of one run of cell `name` on
    `device`."""
    from portbench.core import check, registry, serve, train

    cell = registry.workload(name)
    runner = {"train": train, "serve": serve}[cell["mix"]["kind"]]
    out = runner.run(cell, seed, seconds, traced, device, clock, hooks)
    bench = registry.benchmark()
    metrics = {}
    if traced:
        run = {"cell": cell, "record": out["record"], "trace": out["trace"]}
        for m in bench["per_layer"]:
            if registry.reports(m, name):
                value = registry.metric_reader(m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        for m in bench["end_to_end"]:
            if registry.reports(m, name):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    correct, rows = check.judge(out["numbers"], cell["limits"])
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"memory_peak_bytes": out["memory_peak_bytes"]}}
    if traced and out["trace"] is not None:
        t = out["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return correct, result, rows, out["numbers"]


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.core import registry

    chips = next(w["chips"] for w in registry.benchmark()["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this "
              f"process sees {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    torch.set_num_threads(4)
    correct, result, rows, numbers = run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
        since_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": chips, **result["device"]}
    result["checks"] = result.pop("checks")
    for k, v in numbers.items():
        print(f"number {k} {v!r}", file=sys.stderr)
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(f"correct {correct}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
