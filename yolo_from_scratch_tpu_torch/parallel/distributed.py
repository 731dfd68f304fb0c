"""Multi-process data-parallel training over `torch.distributed`
(counterpart of `yolo_from_scratch_tpu/parallel/distributed.py`).

- `init_distributed` connects this process to the job: through a
  `tcp://` coordinator when one is given with the process count and this
  process's id, else from `torchrun`'s environment (MASTER_ADDR,
  MASTER_PORT, RANK, WORLD_SIZE), as JAX auto-detects on TPU pods. The
  backend follows the device: `nccl` on a CUDA device, `gloo` on the CPU
  (JAX's plugin sniffing for its CPU backend is not copied), and `gloo`
  too where this host's ranks outnumber its cards, so that they share
  them (NCCL refuses two ranks on one card; `gloo` runs the step's
  collectives on CUDA tensors). One tiny all-reduce right after the
  connection pins the rendezvous to start-up, as JAX's start-up barrier
  does.
- Each process loads its own strided slice of every epoch permutation
  (`local_shard_indices`; `data/loader.py::shard_indices`, wrap-padded so
  every rank takes the same steps), and `--batch-size` is per process.
- `global_eval_reduce` sums the per-process evaluation counts, so every
  process prints the global P/R/F1 and loss.

Everything else (the step's collectives, `parallel/mesh.py`) runs on the
group this makes. With one process every helper is the single-process
behaviour.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from yolo_from_scratch_tpu_torch.data.loader import shard_indices

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, backend=None, *,
                     device="cuda"):
    """Connect this process to the training job and return
    (process_index, process_count).

    Give `coordinator` as "host:port" with `num_processes` and this
    process's `process_id`, or none of the three to read `torchrun`'s
    environment; anything in between is refused (ValueError), as is a
    missing environment. `backend` defaults to `nccl` when `device` is a
    CUDA device (each rank then takes `cuda:{rank % device_count}` as its
    current device) and to `gloo` otherwise, or where more ranks than
    cards run on this host (torchrun's LOCAL_WORLD_SIZE, or every
    process when the coordinator is a loopback address)."""
    given = [a is not None for a in (coordinator, num_processes, process_id)]
    if any(given) and not all(given):
        raise ValueError("--distributed takes --coordinator, "
                         "--num-processes and --process-id together, or "
                         "none of them (torchrun's environment)")
    if not any(given):
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise ValueError(f"--distributed without --coordinator needs "
                             f"torchrun's environment; {', '.join(missing)} "
                             f"not set")
        init_method = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        host_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", 0))
    else:
        if not 0 <= process_id < num_processes:
            raise ValueError(f"--process-id {process_id} is not in [0, "
                             f"{num_processes})")
        init_method = f"tcp://{coordinator}"
        rank, world = process_id, num_processes
        host_ranks = world if _on_this_host(coordinator) else 0
    cuda = torch.device(device).type == "cuda"
    if backend is None:
        shared = cuda and host_ranks > torch.cuda.device_count()
        backend = "nccl" if cuda and not shared else "gloo"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    _startup_barrier(cuda)
    return dist.get_rank(), dist.get_world_size()


def _on_this_host(coordinator: str) -> bool:
    """Whether a "host:port" coordinator is this host (a loopback
    address): then every process of the job runs here."""
    host = coordinator.rsplit(":", 1)[0].strip("[]")
    return host in ("localhost", "::1") or host.startswith("127.")


def _startup_barrier(cuda: bool):
    """One tiny all-reduce now, while every process has just left the
    rendezvous together: the transport's connections are made here, not
    at the first step after a long warm-up."""
    t = torch.zeros(1, device=torch.cuda.current_device() if cuda else "cpu")
    dist.all_reduce(t)


def shutdown():
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_shard_indices(n_items: int, process_index: int | None = None,
                        process_count: int | None = None) -> np.ndarray:
    """This process's strided slice of dataset indices, by the loader's
    rule (`data/loader.py::shard_indices`, wrap-padded to equal sizes)."""
    pi = _rank() if process_index is None else process_index
    pc = _world() if process_count is None else process_count
    return shard_indices(np.arange(n_items), pi, pc)


def global_batch_size(local_batch: int) -> int:
    return local_batch * _world()


def global_eval_reduce(tps: int, fps: int, fns: int, loss_sum: float,
                       n_batches: int):
    """Sum per-process evaluation counts over every process, so each
    prints the GLOBAL P/R/F1 and loss: one float64 all-reduce of the five
    scalars. With one process this is the identity. Collective: every
    process must call it."""
    if _world() == 1:
        return tps, fps, fns, loss_sum, n_batches
    device = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    local = torch.tensor([float(tps), float(fps), float(fns),
                          float(loss_sum), float(n_batches)],
                         dtype=torch.float64, device=device)
    dist.all_reduce(local)
    tot = local.cpu().tolist()
    return (int(tot[0]), int(tot[1]), int(tot[2]), float(tot[3]),
            int(tot[4]))
