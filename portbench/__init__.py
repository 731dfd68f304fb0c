"""The benchmark of the PyTorch and CUDA port (`yolo_from_scratch_tpu_torch`).

`python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` on the card and prints
one JSON line. Cells, configurations, traffic mixes and per-layer metrics
are files of their own under `workloads/`, `configs/`, `mixes/` and
`metrics/`, found by name (`core/registry.py`). `reference/` is the plain
PyTorch reference that decides `correct`; it imports nothing of the
program.
"""
