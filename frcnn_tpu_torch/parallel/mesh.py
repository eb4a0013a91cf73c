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
"tcp://localhost:<port>", rank=r, world_size=n)``). :func:`launch` starts
the processes of one machine with those variables set, as ``torchrun``
would; :func:`data_parallel_size` is the JAX ``Trainer``'s rule for how
many devices a step spreads over.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import multiprocessing.connection
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


@contextlib.contextmanager
def rank_group(device_type: str = "cuda"):
    """This process as one rank of the group that ``torchrun``'s variables
    describe: yields its :func:`local_device` (made current under CUDA)
    with the group joined (NCCL on ``cuda``, gloo on ``cpu``), unless the
    caller has joined it; a group joined here is destroyed at exit."""
    device = local_device(device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    joined = not dist.is_initialized()
    if joined:
        init_from_env("nccl" if device.type == "cuda" else "gloo")
    try:
        yield device
    finally:
        if joined:
            dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_threads() -> int:
    """This process's share of the machine's cores when every rank of the
    group runs on this machine (its host threads, e.g. image decode)."""
    return max(1, (os.cpu_count() or 1) // world_size())


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


def data_parallel_size(available: int, images_per_step: int) -> int:
    """How many devices a train step spreads over: the largest ``n <=
    available`` that divides ``images_per_step`` (the rule of the JAX
    package's ``Trainer`` built without a mesh, which takes every local
    device)."""
    n = max(1, available)
    while n > 1 and images_per_step % n:
        n -= 1
    return n


def _rank_main(fn, rank_: int, world: int, port: int, args) -> None:
    """A child of :func:`launch`: ``torchrun``'s variables, then ``fn``."""
    os.environ.update(RANK=str(rank_), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank_), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    fn(*args)


def launch(fn, world: int, device_type: str, *args) -> None:
    """Runs ``fn(*args)`` in ``world`` new processes of this machine
    (``spawn``), each with ``torchrun``'s environment variables (rank ``r``
    on local device ``r``, the group's address a free localhost port), so
    that ``fn`` joins the group with :func:`rank_group`. ``fn`` and
    ``args`` must pickle: a module-level function.

    Returns when every process has exited 0. When one raises or exits
    otherwise, the others are terminated (none is left waiting in a
    collective) and this raises ``RuntimeError``; nothing is retried.

    The libraries the processes load are built here first, once: the
    CUDA kernels under ``cuda`` (``ops/cuda_lib.py::build``), and the
    native host library (``data/native.py``, which the processes then only
    load)."""
    from frcnn_tpu_torch.data import native

    if device_type == "cuda":
        from frcnn_tpu_torch.ops import cuda_lib

        cuda_lib.build()
    native.available()
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, name=f"rank {r}",
                         args=(fn, r, world, port, args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        running = list(procs)
        while running:
            mp.connection.wait([p.sentinel for p in running])
            for p in [p for p in running if p.exitcode is not None]:
                running.remove(p)
                if p.exitcode != 0:
                    raise RuntimeError(
                        f"data-parallel {p.name} of {world} exited with "
                        f"code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
