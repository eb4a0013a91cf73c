"""The int8 matrix-product probe on the card (the counterpart of
``scripts/probe_int8_dot.py``): is a hand-written s8 x s8 -> s32 product
inside a kernel exact, and how fast is it next to the library's?

    python -m frcnn_tpu_torch.tools.probe_int8_dot [M] [K] [N] [iters] \\
        [--device cuda|cpu]

Defaults: M = K = N = 1024, 40 iterations; inputs drawn with numpy's
``default_rng(0).integers(-127, 128)``, as the JAX script draws them. The
kernel is ``ops/matmul_kernel.py::mm`` (``csrc/matmul.cu``), on the route
its shape takes (``matmul_kernel.route``: the TMA/``wgmma`` kernel where
TMA can read the operands, else the ``mma.sync`` one).
One JSON line per experiment, in the JAX script's order:

1. ``{"probe": "int8_dot", "M", "K", "N", "builds", "exact", ...}``:
   ``exact`` is the s8 kernel against the plain version
   (``ops/matmul.py::mm_plain``) and, where its shape rules allow (M > 16,
   K and N multiples of 8), against ``torch._int_mm``, all bitwise;
   ``exact_bf16`` the bf16 kernel against the plain version, bitwise
   (required for K <= 1040, where every partial sum of these integer
   inputs is an integer below 2^24; reported beside ``bf16_max_abs_err``
   above that). The JAX script calls the flag ``compiles``: this kernel is
   built by ``nvcc`` at its first launch, not compiled by Mosaic.
2. ``cuda_s8s8s32``, ``cuda_bf16`` (the kernel, with its ``route``),
   ``torch_s8s8s32`` (``torch._int_mm``) and ``torch_bf16``
   (``torch.matmul``, which rounds its float32 sums to a bfloat16 output
   where the kernel writes float32): each with ``ms`` and ``tops`` (2 M K
   N operations over the time), ``device_ms`` and ``device_tops``.
3. The card's name and power limit (``nvidia-smi``), on a line of its
   own.

``ms`` is the median CUDA-event time of single calls, after three
warm-up calls: the wrapper's host work included. ``device_ms`` is the
device's time per call (:func:`device_ms`): the JAX script's two loop
lengths (``1 + iters // 4`` and ``1 + iters`` calls back to back between
two CUDA events), differenced, best of 3, each run queued behind a spin
kernel so that the device runs the calls back to back. With ``--device
cpu`` the wrapper runs the plain version, the host clock times ``ms`` and
``device_ms`` is null. Unlike the JAX script, a build or launch failure
is not caught into a record (its traceback ends the run), and an exactness
failure exits 1 after the first record.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

# every partial sum of integer bf16 inputs in [-127, 127] is an integer
# below 2^24 (exact in float32) while K * 127^2 < 2^24
BF16_EXACT_K = (1 << 24) // (127 * 127)


def time_ms(fn, iters: int, device, warmup: int = 3) -> float:
    """Median time of one call of ``fn`` in ms, after ``warmup`` calls:
    CUDA events on the card, the host clock on the CPU
    (``utils/metrics.py::seconds``)."""
    from frcnn_tpu_torch.utils.metrics import seconds, sync

    for _ in range(warmup):
        fn()
    sync(device)
    return statistics.median(seconds(fn, 1, device) * 1e3
                             for _ in range(iters))


_spin = {}     # device -> cycles of torch.cuda._sleep per ms


def _spin_cycles(ms: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that keep the current device busy
    for about ``ms`` (the rate measured once per device)."""
    dev = torch.cuda.current_device()
    if dev not in _spin:
        cycles = 1 << 22
        torch.cuda._sleep(cycles)       # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _spin[dev] = cycles / max(start.elapsed_time(end), 1e-3)
    return int(_spin[dev] * ms)


def device_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn`` on the card: ``1 + iters // 4`` and
    ``1 + iters`` calls back to back between two CUDA events, differenced,
    best of 3 trials (``scripts/probe_int8_dot.py:59-84``). Each run is
    queued behind a spin kernel that outlasts the host's enqueueing of the
    calls (twice its measured time, plus 1 ms), so the device meets them
    back to back and the events time the device, not the wrapper."""
    fn()
    torch.cuda.synchronize()
    small, big = 1 + iters // 4, 1 + iters
    t = time.perf_counter()
    for _ in range(big):
        fn()
    spin = _spin_cycles(2e3 * (time.perf_counter() - t) + 1.0)
    torch.cuda.synchronize()

    def run(k: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    return min((run(big) - run(small)) / (big - small) for _ in range(3))


def int_mm_allowed(m: int, k: int, n: int) -> bool:
    """``torch._int_mm``'s shape rules on CUDA: M > 16, K and N multiples
    of 8."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


def operands(m: int, k: int, n: int, device):
    """(a8, b8, abf, bbf): the JAX script's int8 draws (seed 0) and their
    bfloat16 copies, on ``device``."""
    rng = np.random.default_rng(0)
    a8 = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    b8 = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    a8, b8 = a8.to(device), b8.to(device)
    return a8, b8, a8.to(torch.bfloat16), b8.to(torch.bfloat16)


def main(argv=None) -> int:
    from frcnn_tpu_torch.bench import device_line
    from frcnn_tpu_torch.cli import require_device
    from frcnn_tpu_torch.ops.matmul import mm_plain
    from frcnn_tpu_torch.ops.matmul_kernel import mm, route

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("M", type=int, nargs="?", default=1024)
    ap.add_argument("K", type=int, nargs="?", default=1024)
    ap.add_argument("N", type=int, nargs="?", default=1024)
    ap.add_argument("iters", type=int, nargs="?", default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    m, k, n = args.M, args.K, args.N
    ops = 2.0 * m * k * n
    a8, b8, abf, bbf = operands(m, k, n, device)

    # a failed build or launch raises here (a traceback, exit code 1)
    got, got_bf = mm(a8, b8), mm(abf, bbf)
    # "builds": the kernel was built and launched (None: the CPU's plain
    # version ran)
    rec = {"probe": "int8_dot", "M": m, "K": k, "N": n,
           "device": device.type,
           "builds": True if device.type == "cuda" else None}
    exact = torch.equal(got, mm_plain(a8, b8))
    if int_mm_allowed(m, k, n):
        exact = exact and torch.equal(got, torch._int_mm(a8, b8))
    else:
        rec["int_mm"] = "not compared: needs M > 16, K and N multiples of 8"
    want_bf = mm_plain(abf, bbf)
    rec.update(exact=exact, exact_bf16=torch.equal(got_bf, want_bf),
               bf16_max_abs_err=float((got_bf - want_bf).abs().max()))
    print(json.dumps(rec), flush=True)
    if not exact or (k <= BF16_EXACT_K and not rec["exact_bf16"]):
        print(f"probe_int8_dot: the kernel differs from the plain version "
              f"({'s8' if not exact else 'bf16'} mode)", file=sys.stderr)
        return 1
    del got, got_bf, want_bf

    cases = [("cuda_s8s8s32", lambda: mm(a8, b8)),
             ("cuda_bf16", lambda: mm(abf, bbf))]
    if int_mm_allowed(m, k, n):
        cases.append(("torch_s8s8s32", lambda: torch._int_mm(a8, b8)))
    cases.append(("torch_bf16", lambda: torch.matmul(abf, bbf)))
    routes = {"cuda_s8s8s32": route(a8, b8), "cuda_bf16": route(abf, bbf)}
    for name, fn in cases:
        ms = time_ms(fn, args.iters, device)
        dms = device_ms(fn, args.iters) if device.type == "cuda" else None
        rec = {"probe": name, "ms": round(ms, 4),
               "tops": round(ops / (ms * 1e-3) / 1e12, 1),
               "device_ms": None if dms is None else round(dms, 5),
               "device_tops": None if dms is None else round(
                   ops / (dms * 1e-3) / 1e12, 1)}
        if name in routes:
            rec["route"] = routes[name]
        print(json.dumps(rec), flush=True)
    print(device_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
