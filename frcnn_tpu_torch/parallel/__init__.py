"""Data parallelism over ``torch.distributed`` (the JAX package's
``parallel/``: a device mesh there)."""
