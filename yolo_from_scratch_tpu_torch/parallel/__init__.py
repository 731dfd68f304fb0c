"""Data, spatial and tensor parallelism over `torch.distributed`
(counterpart of `yolo_from_scratch_tpu/parallel/`): the process-group
view, the 1-D data mesh and the 2-D `data x space` and `data x model`
meshes with this rank's slices of a host batch, and the collectives of
the step (`mesh.py`); the halo exchange and row gather of a row-sharded
tensor (`spatial.py`); the channel-sharded state and convs of
`--model-parallel` (`tensor.py`); the multi-process start-up, sharding
and evaluation reduce (`distributed.py`)."""

from yolo_from_scratch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SPACE_AXIS,
    Mesh,
    batch_sharding,
    batch_sharding_for,
    data_parallel,
    gather_batch,
    image_sharding,
    level_blocks,
    local_rows,
    make_mesh,
    make_mesh_2d,
    make_mesh_dm,
    pad_batch_to_multiple,
    replicated_sharding,
    row_split,
    shard_batch,
    space_rows,
    target_sharding,
)
from yolo_from_scratch_tpu_torch.parallel.spatial import (
    gather_rows,
    halo_rows,
)
from yolo_from_scratch_tpu_torch.parallel.tensor import (
    MIN_SHARD_SIZE,
    gather_state_tp,
    shard_model_,
    shard_state_tp,
    sharded_fraction,
    tp_leaf_sharding,
)

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "batch_sharding",
    "image_sharding",
    "target_sharding",
    "replicated_sharding",
    "shard_batch",
    "pad_batch_to_multiple",
    "DATA_AXIS",
    "SPACE_AXIS",
    "Mesh",
    "batch_sharding_for",
    "data_parallel",
    "gather_batch",
    "gather_rows",
    "halo_rows",
    "level_blocks",
    "local_rows",
    "row_split",
    "space_rows",
    "MODEL_AXIS",
    "MIN_SHARD_SIZE",
    "make_mesh_dm",
    "tp_leaf_sharding",
    "shard_model_",
    "shard_state_tp",
    "gather_state_tp",
    "sharded_fraction",
]
