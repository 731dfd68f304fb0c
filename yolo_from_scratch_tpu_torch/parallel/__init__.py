"""Data parallelism over `torch.distributed` (counterpart of
`yolo_from_scratch_tpu/parallel/`): the process-group view and the
collectives of the data-parallel step (`mesh.py`), and the multi-process
start-up, sharding and evaluation reduce (`distributed.py`). Not ported
yet: the 2-D spatial mesh and tensor parallelism (`parallel/tensor.py`)."""

from yolo_from_scratch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    make_mesh,
    make_mesh_2d,
    pad_batch_to_multiple,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "make_mesh",
    "make_mesh_2d",
    "pad_batch_to_multiple",
    "shard_batch",
]
