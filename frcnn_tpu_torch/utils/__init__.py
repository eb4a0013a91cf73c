"""Checkpoint reading and the weights bridge from the JAX package's trees."""

from frcnn_tpu_torch.utils.serialization import load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint"]
