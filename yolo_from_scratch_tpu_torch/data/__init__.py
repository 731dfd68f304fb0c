"""Host data layer. The dataset, the loader and the letterbox are the JAX
package's (`yolo_from_scratch_tpu/data/`), shared by import: they load
only numpy (PIL and the native JPEG loader lazily), never jax."""

from yolo_from_scratch_tpu.data.dataset import YoloDataset
from yolo_from_scratch_tpu.data.loader import DataLoader

__all__ = ["YoloDataset", "DataLoader"]
