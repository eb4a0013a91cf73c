"""Data parallelism over ``torch.distributed`` (the JAX package's
``parallel/``: a device mesh there).

The exports stand where the JAX package's mesh and shardings stand: a
process group of one device per rank (``rank_group``, for ``make_mesh``),
the batch split over it (``batch_shard`` and ``batch_rows``, for
``batch_sharding`` and ``shard_batch``) and the rank's own device, which
holds a whole replica (``local_device``, for ``replicated_sharding``).
"""

from frcnn_tpu_torch.parallel.mesh import (
    batch_rows,
    batch_shard,
    local_device,
    rank_group,
)

__all__ = ["rank_group", "batch_shard", "local_device", "batch_rows"]
