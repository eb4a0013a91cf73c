"""Micro-benchmark of cumulative scan formulations on the card (the
counterpart of ``scripts/bench_scan.py``): the anchor labeling's scans,
row scans over [G=32, A=26544] and one flat cumsum over G x A, batch 8.

    python -m frcnn_tpu_torch.tools.bench_scan [iters] \\
        [--device cuda|cpu] [--anchors A] [--batch B]

Cases (the JAX script's labels, its ``lax`` primitives named by their
PyTorch counterparts):

  rowmax assoc             :func:`associative_scan` of max: the odd/even
                           recursive scan ``jax.lax.associative_scan``
                           performs, written in torch ops (PyTorch has no
                           associative-scan primitive)
  rowmax torch.cummax      ``torch.cummax`` (JAX: ``lax.cummax``)
  rowmax hillis            :func:`hillis_cummax`, Hillis-Steele doubling
  rowsum torch.cumsum(i32) ``torch.cumsum`` of int32 (JAX:
                           ``lax.cumsum``)
  rowsum hillis(i32)       :func:`hillis_cumsum_i32`
  flatsum torch.cumsum     ``torch.cumsum`` of a 0/1 float32 vector per
                           image
  flatsum matmul           :func:`matmul_cumsum_flat`, a blocked
                           lower-triangular matmul (float32; exact on
                           these 0/1 values, whose sums stay below 2^24)

Each case returns the sum of every 64th scanned value, as the JAX
script's do. Each line: ``<label> <ms> ms/iter (batch 8)``, CUDA events
over ``1 + iters//4`` and ``1 + iters`` calls, the best of 3 of each,
differenced (``utils/metrics.py::differenced_seconds``); the first call's
time goes to standard error, as the JAX script's compile line does. The
card's name and power limit follow. ``--anchors`` and ``--batch`` cut the
sizes (a CPU run; the JAX script has neither). With ``--device cpu`` the
host clock times the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

G, A = 32, 26544
BATCH = 8


def _shifted(x: torch.Tensor, shift: int, dim: int, fill) -> torch.Tensor:
    """``x`` moved ``shift`` places up along ``dim``, ``fill`` in front
    (the JAX pad-then-slice)."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = shift
    front = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([front, x.narrow(dim, 0, n - shift)], dim)


def hillis_cummax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Running max along ``dim`` by Hillis-Steele doubling."""
    n, shift = x.shape[dim], 1
    while shift < n:
        x = torch.maximum(x, _shifted(x, shift, dim, -float("inf")))
        shift *= 2
    return x


def hillis_cumsum_i32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Running sum along ``dim`` by Hillis-Steele doubling."""
    n, shift = x.shape[dim], 1
    while shift < n:
        x = x + _shifted(x, shift, dim, 0)
        shift *= 2
    return x


def matmul_cumsum_flat(x: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """Cumsum of float32 ``x`` [..., n] along its last axis: row-wise
    cumsums of blocks of ``block`` values as one matmul with a
    lower-triangular matrix, then each block's carry (the JAX function's
    ``vmap`` is the leading batch axes here)."""
    n = x.shape[-1]
    nb = -(-n // block)
    xp = torch.nn.functional.pad(x, (0, nb * block - n))
    xp = xp.reshape(*x.shape[:-1], nb, block)
    tri = torch.tril(torch.ones(block, block, dtype=torch.float32,
                                device=x.device))
    within = xp @ tri.T
    chunk_tot = within[..., -1]
    carry = torch.cat([torch.zeros_like(chunk_tot[..., :1]),
                       torch.cumsum(chunk_tot, -1)[..., :-1]], -1)
    out = (within + carry[..., None]).reshape(*x.shape[:-1], nb * block)
    return out[..., :n]


def _every_other(x: torch.Tensor, start: int, stop: int, dim: int):
    sl = [slice(None)] * x.dim()
    sl[dim] = slice(start, stop, 2)
    return x[tuple(sl)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a at the even places of ``dim``, b at the odd ones."""
    shape = list(a.shape)
    shape[dim] = a.shape[dim] + b.shape[dim]
    out = a.new_empty(shape)
    even = [slice(None)] * a.dim()
    odd = [slice(None)] * a.dim()
    even[dim], odd[dim] = slice(0, None, 2), slice(1, None, 2)
    out[tuple(even)] = a
    out[tuple(odd)] = b
    return out


def associative_scan(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive scan of ``x`` along ``dim`` with the associative ``fn``,
    by the recursion ``jax.lax.associative_scan`` uses: combine adjacent
    pairs, scan the half-length result (the odd places), combine it with
    the even elements for the even places, interleave."""
    dim = dim % x.dim()
    n = x.shape[dim]
    if n < 2:
        return x
    odd = associative_scan(fn, fn(_every_other(x, 0, n - 1, dim),
                                  _every_other(x, 1, n, dim)), dim)
    if n % 2 == 0:
        even = fn(odd.narrow(dim, 0, odd.shape[dim] - 1),
                  _every_other(x, 2, n, dim))
    else:
        even = fn(odd, _every_other(x, 2, n, dim))
    return _interleave(torch.cat([x.narrow(dim, 0, 1), even], dim), odd, dim)


def cases():
    """{label: fn(rows, flat)}: the JAX script's seven cases."""
    return {
        "rowmax assoc": lambda x, f: torch.sum(
            associative_scan(torch.maximum, x, 2)[..., ::64]),
        "rowmax torch.cummax": lambda x, f: torch.sum(
            torch.cummax(x, dim=2).values[..., ::64]),
        "rowmax hillis": lambda x, f: torch.sum(
            hillis_cummax(x, dim=2)[..., ::64]),
        "rowsum torch.cumsum(i32)": lambda x, f: torch.sum(
            torch.cumsum((x > 0).to(torch.int32), dim=2,
                         dtype=torch.int32)[..., ::64]).float(),
        "rowsum hillis(i32)": lambda x, f: torch.sum(
            hillis_cumsum_i32((x > 0).to(torch.int32), dim=2)[..., ::64]
        ).float(),
        "flatsum torch.cumsum": lambda x, f: torch.sum(
            torch.cumsum(f, dim=-1)[..., ::64]),
        "flatsum matmul": lambda x, f: torch.sum(
            matmul_cumsum_flat(f)[..., ::64]),
    }


def main(argv=None) -> int:
    from frcnn_tpu_torch.bench import device_line
    from frcnn_tpu_torch.cli import require_device
    from frcnn_tpu_torch.utils.metrics import differenced_seconds, sync

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("iters", type=int, nargs="?", default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--anchors", type=int, default=A)
    ap.add_argument("--batch", type=int, default=BATCH)
    a = ap.parse_args(argv)
    device = require_device(a.device)
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.normal(size=(a.batch, G, a.anchors)).astype(
        np.float32)).to(device)
    flat = torch.from_numpy((rng.random((a.batch, G * a.anchors)) < 0.01)
                            .astype(np.float32)).to(device)
    for label, fn in cases().items():
        t0 = time.perf_counter()
        fn(rows, flat)
        sync(device)
        print(f"# {label} first call: {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)
        per, _ = differenced_seconds(lambda: fn(rows, flat), a.iters, device)
        print(f"{label:26s} {per * 1e3:8.3f} ms/iter (batch {a.batch})",
              flush=True)
    print(device_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
