"""PyTorch/CUDA port of frcnn_tpu: batched two-stage detection and its
joint training on NVIDIA Hopper, with hand-written CUDA kernels where the
JAX package has Pallas kernels. The JAX package stays the reference; this
package imports none of it.

The public API is the JAX package's: ``from frcnn_tpu_torch import
Detector, duplo_config``. The names resolve lazily, so ``import
frcnn_tpu_torch`` imports nothing else and builds no kernel.
"""

__all__ = [
    "Config", "duplo_config", "imagenet_config", "serving_config",
    "Trainer", "Detector", "ShardedDetector", "BatchIterator",
    "AnchorGenerator",
]

_HOMES = {
    "Config": "frcnn_tpu_torch.config",
    "duplo_config": "frcnn_tpu_torch.config",
    "imagenet_config": "frcnn_tpu_torch.config",
    "serving_config": "frcnn_tpu_torch.config",
    "Trainer": "frcnn_tpu_torch.train.trainer",
    "Detector": "frcnn_tpu_torch.detect.detector",
    "ShardedDetector": "frcnn_tpu_torch.parallel.serving",
    "BatchIterator": "frcnn_tpu_torch.data.pipeline",
    "AnchorGenerator": "frcnn_tpu_torch.geometry.anchors",
}


def __getattr__(name):
    if name not in _HOMES:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(_HOMES[name]), name)
