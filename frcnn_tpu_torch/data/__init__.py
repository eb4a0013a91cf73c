from frcnn_tpu_torch.data.importers import (
    create_duplo_manifest,
    create_imagenet_manifest,
    load_manifest,
    save_manifest,
)
from frcnn_tpu_torch.data.pipeline import BatchIterator

__all__ = [
    "create_duplo_manifest",
    "create_imagenet_manifest",
    "load_manifest",
    "save_manifest",
    "BatchIterator",
]
