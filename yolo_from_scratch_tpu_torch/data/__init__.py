"""Host data layer: the port's copies of the JAX package's dataset, loader
and host letterbox (`yolo_from_scratch_tpu/data/`). They load only numpy
(PIL lazily), never jax, and import nothing of the JAX package."""

from yolo_from_scratch_tpu_torch.data.dataset import YoloDataset
from yolo_from_scratch_tpu_torch.data.loader import DataLoader

__all__ = ["YoloDataset", "DataLoader"]
