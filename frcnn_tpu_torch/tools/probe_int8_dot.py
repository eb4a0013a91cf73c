"""The int8 matrix-product probe on the card (the counterpart of
``scripts/probe_int8_dot.py``): is a hand-written s8 x s8 -> s32 product
inside a kernel exact, and how fast is it next to the library's?

    python -m frcnn_tpu_torch.tools.probe_int8_dot [M] [K] [N] [iters] \\
        [--device cuda|cpu]

Defaults: M = K = N = 1024, 40 iterations; inputs drawn with numpy's
``default_rng(0).integers(-127, 128)``, as the JAX script draws them. The
kernel is ``ops/matmul_kernel.py::mm`` (``csrc/matmul.cu``, ``mma.sync``).
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
2. ``cuda_s8s8s32``, ``cuda_bf16`` (the kernel), ``torch_s8s8s32``
   (``torch._int_mm``) and ``torch_bf16`` (``torch.matmul``, which rounds
   its float32 sums to a bfloat16 output where the kernel writes float32):
   each with ``ms`` and ``tops`` (2 M K N operations over the time).
3. The card's name and power limit (``nvidia-smi``), on a line of its
   own.

Times are medians of CUDA-event times of single calls, after three
warm-up calls; that takes the place of the JAX script's two differenced
``fori_loop`` lengths, which work around ``block_until_ready`` on a
remote TPU. With ``--device cpu`` the wrapper runs the plain version and
the host clock times it. Unlike the JAX script, a build or launch failure
is not caught into a record (its traceback ends the run), and an exactness
failure exits 1 after the first record.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

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
    from frcnn_tpu_torch.ops.matmul_kernel import mm

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
    for name, fn in cases:
        ms = time_ms(fn, args.iters, device)
        print(json.dumps({"probe": name, "ms": round(ms, 4),
                          "tops": round(ops / (ms * 1e-3) / 1e12, 1)}),
              flush=True)
    print(device_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
