"""The process-group view of a data-parallel run (counterpart of
`yolo_from_scratch_tpu/parallel/mesh.py`, its data axis).

The JAX package's data-parallel step is one SPMD program over the global
batch, sharded on the mesh's `data` axis: BatchNorm's statistics are the
global batch's, every masked mean divides by a global count, and the clip
takes the global norm of the global gradient (XLA inserts the
collectives). The port runs one process a rank (`torch.distributed`) and
computes the same thing with explicit collectives, not with a
`DistributedDataParallel` wrapper (which would average per-rank gradients
of per-rank losses):

- inside `data_parallel(mesh)` the losses (`ops/losses.py`,
  `ops/losses_sparse.py`, `models/anchor_free.py`) divide by the global
  counts (`global_sum` of the local count, detached) and take plain means
  as this rank's part of the global mean (`global_mean`: the local mean
  times the local share), so that the loss of the global batch is the sum
  of the ranks' losses; train-mode BatchNorm (`models/fused_bn.py`)
  all-reduces its statistics forward and the sums behind its backward's
  means;
- the step (`train/steps.py`) then sums the gradients over the ranks in
  one flattened all-reduce (`all_reduce_grads_`) before the clip.

Only `all_reduce`, `broadcast` and `barrier` are used: the collectives
that `gloo` runs on CUDA tensors too, so that two ranks can share one
card. The local batches must be equal (the sharded loader makes them so,
`data/loader.py`). With one rank and a process group every collective is
an identity, and a mean's share is 1.0, so such a run equals the run
without one bit for bit; without a process group (`--data-parallel`
alone: a world of one) no collective is issued at all.

Not ported yet: the 2-D `data x space` mesh (`make_mesh_2d`,
`--spatial`) and the spatial rule of `batch_sharding_for`.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"  # the JAX mesh's one axis here: the ranks
SPATIAL_NOT_PORTED = ("the 2-D data x space mesh (--spatial, make_mesh_2d) "
                      "is not ported yet")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the run: its rank, the world size (`size`,
    the JAX mesh's device count on its DATA_AXIS), the device its tensors
    live on and the process group (None for a world of one without
    one)."""

    rank: int
    size: int
    device: torch.device
    group: object = None


def make_mesh(device="cpu") -> Mesh:
    """The 1-D data-parallel mesh over the processes of the initialized
    process group (`parallel/distributed.py::init_distributed`), or a
    world of one when there is none. A CUDA device becomes the rank's
    card, `cuda:{rank % device_count}`; with no group the caller's device
    stays as it is."""
    device = torch.device(device)
    if not dist.is_initialized():
        return Mesh(0, 1, device)
    rank, size = dist.get_rank(), dist.get_world_size()
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(rank, size, device, dist.group.WORLD)


def make_mesh_2d(n_space: int, devices=None):
    raise NotImplementedError(SPATIAL_NOT_PORTED)


def batch_sharding_for(mesh, arr):
    raise NotImplementedError(SPATIAL_NOT_PORTED)


def pad_batch_to_multiple(arr: np.ndarray, multiple: int):
    """Pad the batch dim to a multiple of the mesh size so the batch
    divides evenly across ranks, by REPEATING real rows (wrap-around).
    Returns (padded, valid_count).

    Repeating instead of zero-filling keeps padded rows statistically
    real: gradients/BatchNorm stats on the final partial batch see
    duplicated images rather than fabricated black ones. Loss means over
    a padded batch weight the duplicated rows twice; eval counts are exact
    because callers mask with `valid_count`."""
    b = arr.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return arr, b
    reps = np.concatenate([arr] * ((rem + b - 1) // b + 1), axis=0)[: b + rem]
    return reps, b


def shard_batch(mesh: Mesh, images, targets):
    """This rank's rows of a global host batch, `[rank * b, (rank + 1) *
    b)` with b = B / size, as the JAX mesh places a batch on its data
    axis: (images, [targets])."""
    b, rem = divmod(images.shape[0], mesh.size)
    if rem:
        raise ValueError(f"a batch of {images.shape[0]} does not divide "
                         f"over {mesh.size} ranks (pad_batch_to_multiple)")
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    return images[rows], [t[rows] for t in targets]


_active = None


@contextlib.contextmanager
def data_parallel(mesh):
    """Inside, the losses and train-mode BatchNorm compute the global
    batch's values over `mesh`'s process group (module docstring). A mesh
    without a group, or None, changes nothing."""
    global _active
    prev = _active
    _active = mesh if mesh is not None and mesh.group is not None else None
    try:
        yield
    finally:
        _active = prev


def active_mesh():
    """The mesh of the enclosing `data_parallel`, or None."""
    return _active


def all_reduce(t, mesh, op=dist.ReduceOp.SUM):
    """`t` reduced over the mesh's ranks, in place; returns t."""
    dist.all_reduce(t, op=op, group=mesh.group)
    return t


def global_sum(t):
    """A detached copy of `t` summed over the active mesh's ranks; t itself
    with no active mesh (a loss's count: the normalizer of a masked
    mean)."""
    if _active is None:
        return t
    return all_reduce(t.detach().clone(), _active)


def global_max(t):
    """A detached copy of `t`'s elementwise maximum over the active mesh's
    ranks; t itself with no active mesh."""
    if _active is None:
        return t
    return all_reduce(t.detach().clone(), _active, dist.ReduceOp.MAX)


def global_mean(t):
    """This rank's part of the mean of `t` over the global batch: the
    local mean times the local share (1 / size over equal local batches),
    so that the parts sum to the global mean over the ranks; t.mean() with
    no active mesh."""
    if _active is None:
        return t.mean()
    return t.mean() * (1.0 / _active.size)


def global_count(n):
    """A count of elements of the local batch (a Python number) as the
    global batch's count, over equal local batches."""
    return n if _active is None else n * _active.size


def all_reduce_grads_(grads, mesh):
    """Sum the gradients over the mesh's ranks in place, through one
    flattened buffer (one collective a step). Nothing without a group."""
    if mesh is None or mesh.group is None:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = all_reduce(_flatten_dense_tensors(grads), mesh)
    for g, synced in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(synced)
