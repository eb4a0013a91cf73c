"""Process-group helpers for data-parallel training.

The JAX package replicates the parameters over a device mesh, shards the
image batch over its ``data`` axis and lets XLA reduce the gradients
(``frcnn_tpu/parallel/mesh.py``). Here each process of a
``torch.distributed`` group holds one replica on one device, takes its rows
of every batch, and the objective and the trainer sum what the whole batch
needs over the group (``train/objective.py::BatchShard``,
``train/trainer.py::Trainer``): the step equals the single-process step on
the whole batch.

A group is set up from the environment variables of ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) by
:func:`init_from_env`, or by the caller with an explicit address
(``torch.distributed.init_process_group("gloo", init_method=
"tcp://localhost:<port>", rank=r, world_size=n)``).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from frcnn_tpu_torch.train.objective import BatchShard


def init_from_env(backend: str | None = None) -> None:
    """Join the process group that the environment describes (``env://``):
    NCCL when a card is present, else gloo, unless ``backend`` says."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method="env://")


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device_type: str = "cuda") -> torch.device:
    """This process's device: ``cuda:<LOCAL_RANK>`` (modulo the cards
    present), or the CPU when ``device_type`` is ``"cpu"``."""
    if device_type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device; pass device_type='cpu' to train "
                           "on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % n)


def batch_rows(n: int, rank_: int, world: int) -> slice:
    """The rows of a batch of ``n`` that process ``rank_`` of ``world``
    takes; ``n`` must divide by ``world``."""
    if n % world:
        raise ValueError(f"a batch of {n} does not divide over {world} "
                         f"processes")
    b = n // world
    return slice(rank_ * b, (rank_ + 1) * b)


def batch_shard(group=None) -> BatchShard:
    """This process's :class:`BatchShard` in ``group`` (default: the
    whole world), its ``all_reduce`` a sum over the group."""

    def all_reduce(t: torch.Tensor) -> torch.Tensor:
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    return BatchShard(dist.get_rank(group), dist.get_world_size(group),
                      all_reduce)


def free_port() -> int:
    """A TCP port on localhost that is free now (for a ``tcp://`` init)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
