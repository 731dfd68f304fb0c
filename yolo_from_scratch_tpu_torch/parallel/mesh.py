"""The process-group view of a data-parallel or spatial run (counterpart
of `yolo_from_scratch_tpu/parallel/mesh.py`).

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

The 2-D `data x space` mesh of `--spatial N` (`make_mesh_2d`) lays the
ranks out as JAX reshapes its devices, `(world / N, N)`: rank r (s = r %
N) holds a block of rows of the images of data shard r // N. The block
plan (`row_split`, `level_blocks`) splits the P5 grid, g = img_size / 32
rows: rank s holds g // N + (s < g % N) of them, and k times as many rows
of a level k times finer (32 times as many image rows). Where N divides
g the blocks are equal, rows [s * H / N, (s + 1) * H / N) of every level;
where it does not they differ by one P5 row, and where g < N the last
ranks hold none (they still join every collective, with zero rows). The
plan is the port's own: GSPMD pads the last shard instead. Every element
of the global batch lives on exactly one rank, so the rules above hold
over the world group; with equal blocks the local element counts are
equal and a mean's share is 1 / size, with unequal ones the means and the
statistics divide the local sums by the global count (`global_elements`,
`uneven`). What GSPMD adds for the rows, the port adds by hand
(`parallel/spatial.py`): the halo rows of every 3x3 conv and pool, the
gather of the anchor-free head's outputs over the space group, and the
row offset of every decode (`local_rows`). The images are square, and so
is each grid of the model: a level's global height is its width.

The 2-D `data x model` mesh of `--model-parallel N` (`make_mesh_dm`)
breaks that rule: the N ranks of a model group (rank r is model index
r % N of data shard r // N) hold the SAME images and different channels
of the large convs (`parallel/tensor.py`), and every activation between
layers is whole and equal across the group. Each batch element then
lives on N ranks, so the reductions of the losses and of BatchNorm, the
gradient sum and the metric sums run over the data group alone (the
ranks of one model index, `Mesh.reduce_view`), with the data axis's
size; at one data shard no data collective is issued at all.

The collectives are `all_reduce`, `broadcast` and, for the device
mosaic's batch (`gather_batch`), `all_gather`: `gloo` runs them on CUDA
tensors too, so that two ranks can share one card, and NCCL's can be
captured in a CUDA graph (`train/graphs.py`). The local batches must be
equal (the sharded loader makes them so,
`data/loader.py`). With one rank and a process group every collective is
an identity, and a mean's share is 1.0, so such a run equals the run
without one bit for bit; without a process group (`--data-parallel`
alone: a world of one) no collective is issued at all.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"    # the JAX mesh's first axis: the data shards
SPACE_AXIS = "space"  # its second on a 2-D mesh: the row shards
MODEL_AXIS = "model"  # or the channel shards (parallel/tensor.py)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the run: its rank, the world size (`size`,
    the JAX mesh's device count), the device its tensors live on and the
    process group (None for a world of one without one). On a 2-D mesh
    `n_space` > 1 ranks share each data shard, one block of rows each,
    or `n_model` > 1 ranks, one slice of the channels each (the two are
    exclusive); `space_group` / `model_group` joins them, `data_group`
    joins the ranks that hold the same rows or channels of the other data
    shards (None where such a group would hold this rank alone)."""

    rank: int
    size: int
    device: torch.device
    group: object = None
    n_space: int = 1
    space_group: object = None
    data_group: object = None
    n_model: int = 1
    model_group: object = None

    def __deepcopy__(self, memo):
        # immutable, and its process groups cannot be copied: a module
        # that holds it (a channel-sharded conv) is copied with it shared
        return self

    @property
    def n_data(self) -> int:
        return self.size // (self.n_space * self.n_model)

    @property
    def data_index(self) -> int:
        return self.rank // (self.n_space * self.n_model)

    @property
    def space_index(self) -> int:
        return self.rank % self.n_space

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def spatial(self) -> bool:
        return self.n_space > 1

    def data_view(self) -> Mesh:
        """The data axis alone, as the ranks of this rank's row block or
        channel slice see it: the mesh of a computation that every rank
        of a space or model group repeats on the whole images of its data
        shard (the mesh itself on a 1-D mesh)."""
        if not self.spatial and self.n_model == 1:
            return self
        return Mesh(self.data_index, self.n_data, self.device,
                    self.data_group)

    def reduce_view(self) -> Mesh:
        """The ranks whose batches differ, over which the batch's sums
        run: the mesh itself, or on a model mesh its data axis (the ranks
        of a model group hold one batch)."""
        return self.data_view() if self.n_model > 1 else self

    def space_view(self) -> Mesh:
        """The space axis alone: this rank's space group, the mesh of a
        computation on one data shard's batch (evaluation, whose shards
        hold different numbers of batches)."""
        return Mesh(self.space_index, self.n_space, self.device,
                    self.space_group, self.n_space, self.space_group)


def _rank_device(device, rank):
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return device


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
    return Mesh(rank, size, _rank_device(device, rank), dist.group.WORLD)


def make_mesh_2d(n_space: int, device="cpu") -> Mesh:
    """The 2-D (data, space) mesh over the processes of the process group
    (a world of one without one): data parallelism over groups of
    `n_space` ranks, each group splitting the image height `n_space`
    ways. Rank r is at (r // n_space, r % n_space), JAX's
    `reshape(world // n_space, n_space)` of its device list. Every rank
    creates every subgroup, in one order (`dist.new_group` is
    collective): first the space groups, then the data groups; a group of
    one rank is not made. Raises JAX's ValueError when the world does not
    divide."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_space < 1 or world % n_space:
        raise ValueError(
            f"{world} devices do not divide into space={n_space}")
    if not dist.is_initialized():
        return Mesh(0, 1, torch.device(device))
    rank, n_data = dist.get_rank(), world // n_space
    space_group = data_group = None
    if n_space > 1:
        for d in range(n_data):
            g = dist.new_group([d * n_space + s for s in range(n_space)])
            if d == rank // n_space:
                space_group = g
    if n_data > 1:
        data_group = dist.group.WORLD
        if n_space > 1:
            for s in range(n_space):
                g = dist.new_group([d * n_space + s for d in range(n_data)])
                if s == rank % n_space:
                    data_group = g
    return Mesh(rank, world, _rank_device(device, rank), dist.group.WORLD,
                n_space, space_group, data_group)


def make_mesh_dm(n_model: int, device="cpu") -> Mesh:
    """The 2-D (data, model) mesh of `--model-parallel N` over the
    processes of the process group (a world of one without one): data
    parallelism over groups of `n_model` ranks, each group splitting the
    large convs' output channels `n_model` ways. Rank r is at
    (r // n_model, r % n_model), JAX's `reshape(world // n_model,
    n_model)` with `model` the fast axis. Every rank creates every
    subgroup, in one order: first the model groups, then the data groups;
    a group of one rank is not made. Raises JAX's ValueError when the
    world does not divide."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_model < 1 or world % n_model:
        raise ValueError(
            f"{world} devices do not divide into model={n_model}")
    if not dist.is_initialized():
        return Mesh(0, 1, torch.device(device))
    rank, n_data = dist.get_rank(), world // n_model
    model_group = data_group = None
    if n_model > 1:
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == rank // n_model:
                model_group = g
    if n_data > 1:
        data_group = dist.group.WORLD
        if n_model > 1:
            for m in range(n_model):
                g = dist.new_group([d * n_model + m for d in range(n_data)])
                if m == rank % n_model:
                    data_group = g
    return Mesh(rank, world, _rank_device(device, rank), dist.group.WORLD,
                data_group=data_group, n_model=n_model,
                model_group=model_group)


def batch_sharding(mesh: Mesh, arr):
    """This rank's slice of a host array's batch dimension: the rows
    [d * b, (d + 1) * b) of data shard d (b = B / n_data), as the JAX
    mesh places a batch on its data axis. A view."""
    b, rem = divmod(arr.shape[0], mesh.n_data)
    if rem:
        raise ValueError(f"a batch of {arr.shape[0]} does not divide "
                         f"over {mesh.n_data} data shards "
                         f"(pad_batch_to_multiple)")
    return arr[mesh.data_index * b:(mesh.data_index + 1) * b]


def row_split(grid: int, n: int) -> list[int]:
    """The block plan of `--spatial n`: the P5 rows of each rank of a
    space group, in rank order, for a P5 grid of `grid` rows. Rank s holds
    grid // n + (s < grid % n): the blocks differ by one row at most, the
    first grid % n ranks hold the longer ones, and where grid < n the last
    ranks hold none. Where n divides the grid the blocks are equal."""
    return [grid // n + (s < grid % n) for s in range(n)]


def level_blocks(rows: int, n: int, grid: int | None = None) -> list[int]:
    """Each rank's rows of a level of `rows` global rows (the image or a
    grid of the model) under the plan of the P5 grid `grid`: a level
    rows / grid times as fine as P5 holds that many times each rank's P5
    rows. Without a grid, `rows` in n equal blocks (ValueError on a
    remainder)."""
    if grid is None:
        h, rem = divmod(rows, n)
        if rem:
            raise ValueError(f"{rows} rows do not divide over space={n}")
        return [h] * n
    f, rem = divmod(rows, grid)
    if rem or not f:
        raise ValueError(f"{rows} rows are no level of a P5 grid of {grid}")
    return [f * r for r in row_split(grid, n)]


def space_rows(mesh: Mesh, arr, grid: int | None = None):
    """This rank's block of dimension 1 (image or grid rows) of a batch
    held whole by its space group, under the plan of the P5 grid `grid`
    (`level_blocks`; without one, equal blocks). A view; the array itself
    without a space axis."""
    if not mesh.spatial:
        return arr
    blocks = level_blocks(arr.shape[1], mesh.n_space, grid)
    start = sum(blocks[:mesh.space_index])
    return arr[:, start:start + blocks[mesh.space_index]]


def image_sharding(mesh: Mesh, arr, grid: int | None = None):
    """This rank's part of an NHWC image batch: its data shard's images,
    and on a 2-D mesh its block of their rows (`space_rows`)."""
    return space_rows(mesh, batch_sharding(mesh, arr), grid)


def target_sharding(mesh: Mesh, arr, grid: int | None = None):
    """This rank's part of a dense target batch (B, gs, gs, ...): rows
    follow the image rows, so the loss stays local to each row block."""
    return image_sharding(mesh, arr, grid)


def replicated_sharding(mesh: Mesh, arr):
    """An array every rank holds whole (parameters): itself."""
    return arr


def batch_sharding_for(mesh: Mesh, arr, grid: int | None = None):
    """This rank's part of a batch-leading array: dense spatial maps
    (ndim >= 4: images, targets) by `target_sharding`; low-rank arrays
    (compact labels (B, K, 5), counts (B,)) by the batch alone, whole on
    every rank of a space group."""
    if arr.ndim >= 4:
        return target_sharding(mesh, arr, grid)
    return batch_sharding(mesh, arr)


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


def gather_batch(mesh: Mesh, images, labels, counts):
    """The global batch of compact labels, in data-shard order, on every
    rank: (images (B, S, S, 3), labels (B, K, 5), counts (B,)) with B =
    b x n_data, from this rank's b uint8 images, labels and counts. The
    device mosaic draws its partners from it (`train/steps.py`). One
    `all_gather` a tensor over the ranks whose batches differ: the world
    on a 1-D mesh, the data group on a 2-D one (whose space or model
    groups hold one data shard's whole batch). No autograd, no host sync
    and no size read from a tensor's values, so that a CUDA graph can
    hold it; the inputs themselves where there is no such group. Gather
    the images before normalizing them: uint8 moves a quarter of the
    bytes, and the normalization is elementwise."""
    view = mesh.data_view()
    if view.group is None:
        return images, labels, counts
    out = []
    for t in (images, labels, counts):
        buf = t.new_empty((view.size, *t.shape))
        dist.all_gather(list(buf.unbind(0)), t.contiguous(), group=view.group)
        out.append(buf.flatten(0, 1))
    return tuple(out)


def shard_batch(mesh: Mesh, images, targets, grid: int | None = None):
    """This rank's part of a global host batch: (images, [targets]) by
    `image_sharding` and `batch_sharding_for`, rows under the plan of
    the P5 grid `grid`."""
    return (image_sharding(mesh, images, grid),
            [batch_sharding_for(mesh, t, grid) for t in targets])


_active = None
_grid = None


@contextlib.contextmanager
def data_parallel(mesh, grid: int | None = None):
    """Inside, the losses and train-mode BatchNorm compute the global
    batch's values over `mesh`'s process group, and on a 2-D mesh the
    convs and pools take halo rows from their neighbours and the decodes
    offset their rows (module docstring). `grid`: the P5 grid of the
    batch in flight (img_size / 32), whose plan sets the row blocks on a
    2-D mesh; without one every level's blocks are equal. A mesh without
    a group, or None, changes nothing."""
    global _active, _grid
    prev = _active, _grid
    _active = mesh if mesh is not None and mesh.group is not None else None
    _grid = grid
    try:
        yield
    finally:
        _active, _grid = prev


def active_mesh():
    """The mesh of the enclosing `data_parallel`, or None."""
    return _active


def spatial_mesh():
    """The active mesh when it has a space axis (the tensors in flight
    are row blocks), else None."""
    return _active if _active is not None and _active.spatial else None


def row_grid():
    """The P5 grid of the active `data_parallel`, or None."""
    return _grid


def active_blocks(h: int, width: int | None = None) -> list[int]:
    """Every rank's rows, in space order, of a level of which this rank
    holds h rows under the active 2-D mesh: the active grid's plan of the
    level's global rows, which are its `width` (`level_blocks`); without a
    grid, equal blocks of h. Raises where the plan gives this rank another
    height."""
    mesh = _active
    if _grid is None:
        return [h] * mesh.n_space
    blocks = level_blocks(width, mesh.n_space, _grid)
    if blocks[mesh.space_index] != h:
        raise ValueError(f"{h} rows at rank {mesh.space_index} of space="
                         f"{mesh.n_space}; the plan of the P5 grid of {_grid} "
                         f"gives {blocks} at a width of {width}")
    return blocks


def uneven() -> bool:
    """Whether the row blocks of the active 2-D mesh differ (its grid
    does not divide by the space axis)."""
    return (_active is not None and _active.spatial and _grid is not None
            and _grid % _active.n_space != 0)


def local_rows(h: int, width: int | None = None):
    """(row offset, global rows) of a grid whose h local rows, of a level
    `width` wide, are this rank's block under the active mesh
    (`active_blocks`); (0, h) without a space axis."""
    if _active is None or not _active.spatial:
        return 0, h
    blocks = active_blocks(h, width)
    return sum(blocks[:_active.space_index]), sum(blocks)


def global_rows(h: int, width: int) -> int:
    """The global rows of a level of which this rank holds h rows, `width`
    wide: h without a space axis."""
    return local_rows(h, width)[1]


def reduce_mesh():
    """The mesh over which the active batch's sums run
    (`Mesh.reduce_view` of the active mesh), or None where there is no
    active mesh or that view is one rank without a group (a model mesh of
    one data shard)."""
    if _active is None:
        return None
    mesh = _active.reduce_view()
    return mesh if mesh.group is not None else None


def all_reduce(t, mesh, op=dist.ReduceOp.SUM):
    """`t` reduced over the mesh's ranks, in place; returns t."""
    dist.all_reduce(t, op=op, group=mesh.group)
    return t


def global_sum(t):
    """A detached copy of `t` summed over the ranks of the active batch
    (`reduce_mesh`); t itself with none (a loss's count: the normalizer
    of a masked mean)."""
    mesh = reduce_mesh()
    if mesh is None:
        return t
    return all_reduce(t.detach().clone(), mesh)


def global_max(t):
    """A detached copy of `t`'s elementwise maximum over the ranks of the
    active batch; t itself with none."""
    mesh = reduce_mesh()
    if mesh is None:
        return t
    return all_reduce(t.detach().clone(), mesh, dist.ReduceOp.MAX)


def global_elements(t, rows_dim: int = 1) -> int:
    """The global batch's count of the elements of which `t` is this
    rank's part: t.numel() times the ranks of the active batch mesh, or,
    for a row block under a space axis (its rows at `rows_dim`, its width
    next), the count of the level's whole rows over the data shards. The
    same integer as t.numel() * size where the blocks are equal."""
    mesh = reduce_mesh()
    if mesh is None:
        return t.numel()
    if not mesh.spatial:
        return t.numel() * mesh.size
    shape = list(t.shape)
    shape[rows_dim] = global_rows(shape[rows_dim], shape[rows_dim + 1])
    return math.prod(shape) * mesh.n_data


def global_mean(t):
    """This rank's part of the mean of `t` (a row block's rows at
    dimension 1) over the global batch: the local mean times the local
    share (1 / size over equal local batches), or over unequal row blocks
    the local sum over the global count, so that the parts sum to the
    global mean over the ranks; t.mean() with no active batch mesh."""
    mesh = reduce_mesh()
    if mesh is None:
        return t.mean()
    if uneven():
        return t.sum() / global_elements(t)
    return t.mean() * (1.0 / mesh.size)


def global_count(n):
    """A count of elements of the local batch (a Python number) as the
    global batch's count, over equal local batches (the images of a batch;
    a row block's elements count with `global_elements`)."""
    mesh = reduce_mesh()
    return n if mesh is None else n * mesh.size


def all_reduce_grads_(grads, mesh):
    """Sum the gradients over the ranks whose batches differ
    (`Mesh.reduce_view`) in place, through one flattened buffer (one
    collective a step). Nothing without a group: a world of one, or a
    model mesh of one data shard, whose model groups hold the whole batch
    and whose sharded leaves' gradients are whole already."""
    if mesh is None:
        return
    mesh = mesh.reduce_view()
    if mesh.group is None:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = all_reduce(_flatten_dense_tensors(grads), mesh)
    for g, synced in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(synced)
