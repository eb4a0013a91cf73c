"""The probe's matrix product on the hand-written CUDA kernels of
``csrc/matmul.cu``: ``O[M, N] = A[M, K] . B[K, N]``, int8 x int8 -> int32
or bfloat16 x bfloat16 -> float32, on tensor cores.

Port of ``scripts/probe_int8_dot.py::pallas_mm`` (kernel body
``_mm_kernel``). Two routes, chosen by shape (:func:`route`), each with its
own launch count:

* ``"tma"`` (:data:`KERNEL`, ``mm``): the persistent, warp-specialized
  kernel (TMA loads into an mbarrier ring, ``wgmma``), for every product
  whose operands TMA can read: 16-byte aligned bases, A's rows of
  ``K * size`` bytes and a bf16 B's rows of ``N * 2`` bytes on the
  16-byte grain. An int8 B that is N-contiguous (the probe's ``[K, N]``)
  is first transposed into a scratch ``[N, K]`` by the same launcher
  (``wgmma`` reads 8-bit operands only K-major); an int8 B that is a
  K-contiguous view (``w.t()`` of a contiguous ``[N, K]``, as the int8
  chain calls ``torch._int_mm(cols, wmat.t())``) is read as it is.
* ``"sync"`` (:data:`SYNC_KERNEL`, ``mm_sync``): the first version on
  ``mma.sync``, for any M, K, N and alignment; its B is N-contiguous (a
  K-contiguous int8 view is made contiguous first).

A is contiguous; B is contiguous or, for int8, a K-contiguous view; any
other strides raise, on the CPU too. On a CPU tensor :func:`mm` runs the
plain version (``ops/matmul.py::mm_plain``); on a CUDA tensor it launches
a kernel or raises. It lies on no serving or training path: the probe
(``tools/probe_int8_dot.py``) is its one caller.
"""

from __future__ import annotations

import ctypes

import torch

from frcnn_tpu_torch.ops.cuda_lib import CudaKernel, check_cuda, ptr
from frcnn_tpu_torch.ops.matmul import check_operands, mm_plain

REPLACES = ("scripts/probe_int8_dot.py:40 (_mm_kernel of pallas_mm, "
            "pallas_call at :51)")

KERNEL = CudaKernel(
    name="mm",
    entry="mm_tma_kernel",
    symbols={torch.int8: "frcnn_mm_tma_s8s32",
             torch.bfloat16: "frcnn_mm_tma_bf16f32"},
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 4,
    source="frcnn_tpu_torch/csrc/matmul.cu",
    replaces=REPLACES,
)

SYNC_KERNEL = CudaKernel(
    name="mm_sync",
    entry="mm_kernel",
    symbols={torch.int8: "frcnn_mm_s8s32",
             torch.bfloat16: "frcnn_mm_bf16f32"},
    argtypes=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 3,
    source="frcnn_tpu_torch/csrc/matmul.cu",
    replaces=REPLACES,
)

ROUTES = ("tma", "sync")


def b_kmajor(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``b`` [K, N] is read K-contiguous (the view ``w.t()`` of a
    contiguous int8 ``[N, K]``) rather than N-contiguous (contiguous);
    raises for any other strides, and for a K-contiguous bf16 ``b``."""
    if b.is_contiguous():
        return False
    if a.dtype == torch.int8 and b.t().is_contiguous():
        return True
    raise ValueError(f"mm: B {tuple(b.shape)} with strides {b.stride()}: "
                     f"expected a contiguous [K, N]"
                     + (" or the K-contiguous view of a contiguous [N, K]"
                        if a.dtype == torch.int8 else ""))


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """``"tma"`` where TMA can read both operands, else ``"sync"``.

    TMA reads rows whose byte stride is a multiple of 16 from 16-byte
    aligned bases: A's ``K * size``; a bf16 B's ``N * 2``; an int8 B's
    ``K`` (a K-contiguous view, or the transposed scratch of an
    N-contiguous one, which needs no alignment of its own)."""
    kmajor = b_kmajor(a, b)
    size = a.element_size()
    if a.shape[1] == 0 or (a.shape[1] * size) % 16 or a.data_ptr() % 16:
        return "sync"
    if a.dtype == torch.int8:
        return "tma" if not kmajor or b.data_ptr() % 16 == 0 else "sync"
    if (b.shape[1] * 2) % 16 or b.data_ptr() % 16:
        return "sync"
    return "tma"


def mm(a: torch.Tensor, b: torch.Tensor, via: str = None) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N] (sums wrap modulo 2^32),
    or bfloat16 -> float32. ``via``: None (the route of :func:`route`), or
    ``"sync"`` or ``"tma"`` to take that route (``"tma"`` raises where
    :func:`route` does not allow it)."""
    out_dtype = check_operands(a, b)
    chosen = route(a, b)
    if via is not None:
        if via not in ROUTES:
            raise ValueError(f"mm: route {via!r} is not one of {ROUTES}")
        if via == "tma" and chosen != "tma":
            raise ValueError(f"mm: the TMA route cannot read A "
                             f"{tuple(a.shape)} and B {tuple(b.shape)} "
                             f"(strides {b.stride()})")
        chosen = via
    if a.device.type == "cpu":
        return mm_plain(a, b)
    (m, k), n = a.shape, b.shape[1]
    check_cuda("a", a, a.dtype, (m, k))
    if b.device != a.device or b.dtype != a.dtype:
        raise ValueError(f"mm: B on {b.device} as {b.dtype}, A on "
                         f"{a.device} as {a.dtype}")
    if m == 0 or n == 0:
        raise ValueError(f"mm: empty output {m} x {n}")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"mm: a size of {m} x {k} x {n} exceeds int32")
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    if chosen == "sync":
        b = b.contiguous()
        SYNC_KERNEL.launch(a.dtype, ptr(a), ptr(b), ptr(out), m, k, n)
        return out
    kmajor = b_kmajor(a, b)
    bt = None
    if a.dtype == torch.int8 and not kmajor:
        bt = torch.empty(n, k, dtype=torch.int8, device=a.device)
    KERNEL.launch(a.dtype, ptr(a), ptr(b),
                  ctypes.c_void_p(None if bt is None else bt.data_ptr()),
                  ptr(out), m, k, n, int(kmajor))
    return out
